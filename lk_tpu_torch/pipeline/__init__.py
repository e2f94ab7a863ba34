"""The VP pipeline: state, per-frame step, the single-stream and batched
runners (VideoPipeline, MultiStreamPipeline), and the LK1/LK2 masked
tracker (PyTorch); counterpart of ``lk_tpu.pipeline``, with its exports."""

from lk_tpu_torch.pipeline.state import (  # noqa: F401
    FrameOutputs,
    PipelineState,
    init_pipeline_state,
)
from lk_tpu_torch.pipeline.step import make_step, preprocess_frame  # noqa: F401
from lk_tpu_torch.pipeline.runner import (  # noqa: F401
    MultiStreamPipeline,
    VideoPipeline,
    make_chunk_runner,
)
