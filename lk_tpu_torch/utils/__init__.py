"""Utilities: state checkpoints."""
