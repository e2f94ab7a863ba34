"""Build and load the package's CUDA kernels.

The ``.cu`` sources under ``csrc/`` are compiled with ``nvcc`` at first use
into ``lk_tpu_torch/_build/<key>/``, ``key`` being a hash of the sources and
the flags, as one shared library with a plain C interface that ``ctypes``
loads.  A later process with the same sources loads the library it finds.
Nothing is downloaded; ``nvcc`` comes from ``CUDA_HOME``, ``PATH`` or the
toolkit's default prefix.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = ("csrc/fused_lk_level.cu",)
# sm_90a: Hopper.  --fmad=false: no FMA contraction (see the .cu header).
# -Xptxas -v: registers, shared memory and spills of each kernel, kept in
# the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Set when this process compiled the library (None: loaded a cached build).
build_seconds: float | None = None
build_log: str = ""


def _nvcc() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update(s.encode())
        h.update((_PKG / s).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _PKG / "_build" / h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    global build_seconds, build_log
    so = out_dir / "liblk_kernels.so"
    if so.exists():
        build_log = (out_dir / "build.log").read_text() \
            if (out_dir / "build.log").exists() else ""
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"liblk_kernels.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_PKG / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing
    build_seconds, build_log = seconds, log
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from lk_tpu_torch.flow.lk_kernels import bind

            lib = ctypes.CDLL(str(_compile(build_dir())))
            bind(lib)
            _lib = lib
    return _lib
