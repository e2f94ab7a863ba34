"""The batched VP pipeline: state, per-frame step and serving runner
(PyTorch)."""
