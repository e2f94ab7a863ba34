"""The LK core (PyTorch): dense pyramidal LK and its fused level."""
