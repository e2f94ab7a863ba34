"""CLI apps mirroring the five reference scripts, and the serving
benchmark: counterpart of ``lk_tpu.apps`` (SURVEY.md §1 L7/L8).

``python -m lk_tpu_torch.apps <final|vp_detect|classify|masking|roadlines|
serve> [args...]`` or the per-module entry points, with ``lk_tpu``'s flags.
The pipelines run on the card; ``main``, ``run_vp_app``, the tracker apps'
compute functions and serve's ``run_server`` take a ``device`` keyword
(default "cuda").  Presentation (``--write-video``, the PNG flags,
``--display``) needs OpenCV or matplotlib and raises ``ImportError`` on a
host without them; the computation needs neither."""
