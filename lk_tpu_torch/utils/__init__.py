"""Utilities: state checkpoints, profiling (FPS meter, spans, device
traces)."""
