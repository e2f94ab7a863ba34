"""The VP pipeline: state, per-frame step, the single-stream and batched
runners (VideoPipeline, MultiStreamPipeline), and the LK1/LK2 masked
tracker (PyTorch)."""
