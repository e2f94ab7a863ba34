"""Host I/O: video sources (the file reader, the synthetic road stream
rendered on the device), the LKRAW container and its native reader, chunk
prefetchers and the output sinks; counterpart of ``lk_tpu.io``, with its
exports (OpenCV is imported only by what reads or writes video files)."""

from lk_tpu_torch.io.video import (  # noqa: F401
    SyntheticRoadStream,
    VideoReader,
    open_stream,
)
from lk_tpu_torch.io.sink import (  # noqa: F401
    read_object,
    read_vp_csv,
    save_object,
    save_segments_pickle,
    save_vp_csv,
)
from lk_tpu_torch.io.raw import RawFrameReader, write_lkraw  # noqa: F401
