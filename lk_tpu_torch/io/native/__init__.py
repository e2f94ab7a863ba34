"""ctypes bindings for the native framestore: counterpart of
``lk_tpu.io.native``, with its own copy of ``framestore.cpp``.

The library is built with ``g++`` at first use into
``lk_tpu_torch/_build/framestore-<hash of the source>/`` (git-ignored),
written under a temporary name and renamed into place, so processes that
build at once never load a half-written file.  ``get_lib()`` returns None
when no toolchain is available; ``io.raw`` then reads the same bytes with
numpy.  This is a host-side I/O path: no device work depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "framestore.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "_build"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of the current source lives."""
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"framestore-{key}" / "libframestore.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread",
                            str(_SRC), "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, subprocess.CalledProcessError):
        return None
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    for name in ("fs_width", "fs_height", "fs_channels"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.fs_nframes.argtypes = [ctypes.c_void_p]
    lib.fs_nframes.restype = ctypes.c_int64
    lib.fs_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
    ]
    lib.fs_next_batch.restype = ctypes.c_int
    lib.fs_close.argtypes = [ctypes.c_void_p]
    lib.fs_close.restype = None
    lib.fs_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.fs_write.restype = ctypes.c_int
    _lib = lib
    return _lib
