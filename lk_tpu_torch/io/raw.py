"""LKRAW container IO: native prefetching reader + NumPy fallback/writer
(counterpart of ``lk_tpu.io.raw``; same file format, either package reads
the other's files).

LKRAW is the framework's zero-decode frame container (header "LKRW",
u32 width/height/channels/nframes, then raw u8 frames).  The native reader
(io/native/framestore.cpp) stages frames on a producer thread so the Python
side only does a wait-free copy per batch.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional

import numpy as np

from lk_tpu_torch.io.native import get_lib

_HDR = struct.Struct("<4sIIII")


def write_lkraw(path: str, frames: np.ndarray) -> str:
    """frames: (N, H, W) or (N, H, W, C) uint8."""
    f = np.ascontiguousarray(frames, dtype=np.uint8)
    if f.ndim == 3:
        f = f[..., None]
    n, h, w, c = f.shape
    lib = get_lib()
    if lib is not None:
        buf = f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if lib.fs_write(path.encode(), buf, w, h, c, n) == 0:
            return path
    with open(path, "wb") as fh:
        fh.write(_HDR.pack(b"LKRW", w, h, c, n))
        fh.write(f.tobytes())
    return path


class RawFrameReader:
    """Batch reader over an LKRAW file; native prefetch when available."""

    def __init__(self, path: str, ring: int = 16, downscale: int = 1):
        if downscale not in (1, 2):
            raise ValueError(f"downscale must be 1 or 2, got {downscale}")
        self.path = path
        self.downscale = downscale
        self._lib = get_lib()
        self._h = None
        if self._lib is not None:
            self._h = self._lib.fs_open(path.encode(), ring, downscale)
        if self._h:
            self.width = self._lib.fs_width(self._h)
            self.height = self._lib.fs_height(self._h)
            self.channels = self._lib.fs_channels(self._h)
            self.nframes = self._lib.fs_nframes(self._h)
            self._np = None
        else:
            # NumPy fallback: mmap + strided view
            with open(path, "rb") as fh:
                hdr_bytes = fh.read(_HDR.size)
            if len(hdr_bytes) < _HDR.size:
                raise ValueError(
                    f"not an LKRAW file (truncated header): {path}")
            magic, w, h, c, n = _HDR.unpack(hdr_bytes)
            if magic != b"LKRW" or w * h * c == 0:
                raise ValueError(f"not an LKRAW file: {path}")
            # Clamp to full frames actually present (matches fs_open).
            avail = (os.path.getsize(path) - _HDR.size) // (h * w * c)
            n = min(n, max(avail, 0))
            # downscale is applied in next_batch
            data = np.memmap(path, dtype=np.uint8, mode="r",
                             offset=_HDR.size, shape=(n, h, w, c))
            self._np = data
            self.width = w // downscale
            self.height = h // downscale
            self.channels = c
            self.nframes = n
            self._pos = 0

    @property
    def native(self) -> bool:
        return self._h is not None

    def next_batch(self, n: int) -> Optional[np.ndarray]:
        shape = (n, self.height, self.width, self.channels)
        if self._h:
            out = np.empty(shape, np.uint8)
            got = self._lib.fs_next_batch(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n
            )
            if got == 0:
                return None
            return out[:got]
        if self._pos >= self.nframes:
            return None
        got = min(n, self.nframes - self._pos)
        chunk = np.asarray(self._np[self._pos:self._pos + got])
        self._pos += got
        if self.downscale == 2:
            # truncate odd dims first (matches the native path's floor-half
            # output size; ceil/floor mixing breaks the 2x2 average)
            c = chunk[:, : self.height * 2, : self.width * 2].astype(np.uint16)
            c = (c[:, ::2, ::2] + c[:, 1::2, ::2] + c[:, ::2, 1::2]
                 + c[:, 1::2, 1::2] + 2) >> 2
            chunk = c.astype(np.uint8)
        return chunk

    def close(self):
        if self._h:
            self._lib.fs_close(self._h)
            self._h = None

    def __iter__(self):
        while True:
            b = self.next_batch(8)
            if b is None:
                break
            for f in b:
                yield f
