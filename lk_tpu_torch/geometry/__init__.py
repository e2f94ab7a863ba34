"""Flow lines, cross points, the VP state machine, motion classes and
Hough road-line voting (PyTorch)."""
