"""Utilities: state checkpoints, profiling (FPS meter, ``profiling.span``:
the gated profiler range every span of the port opens, named spans, device
traces) and the wall-clock ``Timer``; counterpart of ``lk_tpu.utils``."""

from lk_tpu_torch.utils.runtime import Timer  # noqa: F401
