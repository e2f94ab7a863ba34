"""Shi–Tomasi corner selection (PyTorch)."""
