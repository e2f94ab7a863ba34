"""Build and load the package's CUDA kernels.

The ``.cu`` sources under ``csrc/`` are compiled with ``nvcc`` at first use
into ``lk_tpu_torch/_build/<key>/``, ``key`` being a hash of the sources, the
headers they share and the flags: one ``nvcc`` per source, all started
together, then one link into
a shared library with a plain C interface that ``ctypes`` loads.  A later
process with the same sources loads the library it finds.  Nothing is
downloaded; ``nvcc`` comes from ``CUDA_HOME``, ``PATH`` or the toolkit's
default prefix.

Every wrapper launches through ``launch``: the C launchers act on the
calling thread's current device (``cudaFuncSetAttribute``, the occupancy
queries, the launch itself), so ``launch`` makes the tensor's device
current around the call and passes that device's current stream.
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

import torch

_PKG = Path(__file__).resolve().parent
SOURCES = ("csrc/fused_lk_level.cu", "csrc/finish.cu",
           "csrc/window_gather.cu", "csrc/pyr_down.cu", "csrc/local_warp.cu",
           "csrc/fused_level_pre.cu", "csrc/vp_scan.cu")
HEADERS = ("csrc/warp_tile.cuh",)
# sm_90a: Hopper.  --fmad=false: no FMA contraction (see the .cu header).
# -Xptxas -v: registers, shared memory and spills of each kernel, kept in
# the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for s in SOURCES + HEADERS:
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = out_dir / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(_PKG / src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}")
    tmp = out_dir / f"liblk_kernels.{tag}.so"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        logs.append(f"$ {' '.join(cmd)}\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link failed with code {link.returncode}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError("; ".join(failed) + ":\n" + log)
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing
    build_seconds, build_log = time.perf_counter() - t0, log
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from lk_tpu_torch.flow import lk_kernels, sparse, warp_kernels
            from lk_tpu_torch.geometry import vanishing
            from lk_tpu_torch.ops import blur, finish

            lib = ctypes.CDLL(str(_compile(build_dir())))
            for module in (lk_kernels, finish, sparse, blur, warp_kernels,
                           vanishing):
                module.bind(lib)
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    """The CUDA runtime's text for an error code of a C launcher."""
    return _lib.lk_error_string(code).decode() if _lib is not None else "?"


def launch(fn, t: torch.Tensor, name: str, *args) -> None:
    """``fn(*args, stream)`` with ``t``'s device current and that device's
    current stream; raises if the C launcher returns a CUDA error."""
    with torch.cuda.device(t.device):
        rc = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({error_string(rc)})")
