"""Wall-clock timing: counterpart of ``lk_tpu.utils.runtime.Timer``.

``lk_tpu``'s other runtime helper, ``enable_compilation_cache`` (JAX's
persistent compile cache), has no counterpart: the port's compiled kernels
are cached by ``lk_tpu_torch._build`` in its build directory.
"""

from __future__ import annotations

import time


class Timer:
    """Host wall-clock span: ``with Timer() as t: ...; t.dt`` (seconds).

    Work queued on the card is not waited for: to time it, the caller
    synchronizes (``torch.cuda.synchronize()``) before the span closes."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        return False
