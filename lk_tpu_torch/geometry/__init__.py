"""Flow lines, cross points, the VP state machine and motion classes
(PyTorch)."""
