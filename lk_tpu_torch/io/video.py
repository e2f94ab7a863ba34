"""Video ingest: file decode (OpenCV, host side) and synthetic dashcam
streams rendered on the device: counterpart of ``lk_tpu.io.video``
(``VideoReader``, ``SyntheticRoadStream``, ``open_stream``).

``SyntheticRoadStream`` needs no OpenCV.  It reproduces ``lk_tpu``'s
recipe: the texture is drawn from the same ``np.random.default_rng(seed)``
calls in the same order, blurred with OpenCV's float Gaussian kernel
(ksize = round(8 sigma + 1) | 1, BORDER_REFLECT_101) in OpenCV's own order
of operations (``gaussian_blur``: bit-equal to ``cv.GaussianBlur`` on the
CPU where the width is a multiple of 16, so that OpenCV's vector loop
covers every column), and each frame is the texture zoomed about
the VP with float bilinear coordinates (the affine map's f32 entries
applied in f64, then rounded to f32), REFLECT_101, clipped and truncated
to u8, as ``cv.warpAffine`` does in OpenCV 5.  The arithmetic is f32/f64
elementwise operations only, so a stream on the card gives the same bits
as on the CPU; against ``lk_tpu``'s stream under OpenCV 5.0 a rare pixel
differs by one u8 level (a float's last bit flips the truncation).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from lk_tpu_torch.ops.blur import reflect101_index

_PAD = 1.6            # texture bigger than the frame so zoom-out stays in
_BLOCK = 16           # frames rendered per device gather (bounds memory)


class VideoReader:
    """Sequential BGR frame reader over a file (cv2, host side).

    Exposes (width, height) props like VideoCapture (LK_Final.py:426-428).
    """

    def __init__(self, path: str):
        from lk_tpu_torch.viz import require

        cv = require("cv2", "decoding a video file")
        self.cap = cv.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError(f"Could not open video {path!r}")
        self.width = int(self.cap.get(cv.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.cap.get(cv.CAP_PROP_FPS) or 30.0)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ret, frame = self.cap.read()
            if not ret:
                break
            yield frame

    def close(self):
        self.cap.release()


def gaussian_taps(sigma: float) -> Tuple[float, ...]:
    """OpenCV's Gaussian kernel for a float image (getGaussianKernel with
    ksize = round(8 sigma + 1) | 1), as f32 values."""
    k = int(round(sigma * 8 + 1)) | 1
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2
    t = np.exp(-x * x / (2 * sigma * sigma))
    return tuple(float(v) for v in (t / t.sum()).astype(np.float32))


def _fma(x: torch.Tensor, k: float, acc: torch.Tensor) -> torch.Tensor:
    """f32 ``x * k + acc`` rounded once, as a fused multiply-add: the
    product of two f32 values is exact in f64."""
    return (x.to(torch.float64) * k + acc.to(torch.float64)).to(torch.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv.GaussianBlur(img, (0, 0), sigma) of an f32 (H, W) image, in
    OpenCV's order of operations: the row pass a fused multiply-add per
    tap in tap order, the column pass the centre tap, then each symmetric
    pair of rows added and fused-multiply-added outward; BORDER_REFLECT_101
    on both axes."""
    taps = gaussian_taps(sigma)
    p = len(taps) // 2
    h, w = img.shape
    xp = img.index_select(1, reflect101_index(w, p, p, img.device))
    acc = torch.zeros_like(img)
    for i, t in enumerate(taps):
        acc = _fma(xp[:, i:i + w], t, acc)
    yp = acc.index_select(0, reflect101_index(h, p, p, img.device))
    out = _fma(yp[p:p + h], taps[p], torch.zeros_like(img))
    for j in range(1, p + 1):
        out = _fma(yp[p + j:p + j + h] + yp[p - j:p - j + h], taps[p + j],
                   out)
    return out


class SyntheticRoadStream:
    """Forward-driving scene: texture expanding radially from a fixed VP.

    frame_{t}(p) = texture(vp + (p - vp) / zoom^t): every feature streams
    away from the vanishing point, downward in the lower half — matching
    the dashcam geometry the reference's ROI/angle filters assume.

    The texture (``tex``, f32 (1.6 H, 1.6 W)) lives on ``device`` and the
    frames are rendered there; ``frame(t)`` and iteration give u8 numpy
    frames (BGR, three equal channels, or gray with ``color=False``),
    ``gray_frames`` a batch of u8 gray frames as a tensor on the device.
    """

    def __init__(
        self,
        width: int = 1280,
        height: int = 720,
        vp: Optional[Tuple[float, float]] = None,
        zoom: float = 1.02,
        seed: int = 0,
        n_frames: int = 120,
        color: bool = True,
        device="cuda",
    ):
        self.width = width
        self.height = height
        self.n_frames = n_frames
        self.zoom = zoom
        self.color = color
        self.device = torch.device(device)
        self.vp = vp if vp is not None else (width * 0.5, height * 0.45)
        rng = np.random.default_rng(seed)
        th, tw = int(height * _PAD), int(width * _PAD)
        fine = rng.random((th, tw)).astype(np.float32) * 255
        coarse = rng.random((th, tw)).astype(np.float32) * 255
        tex = (gaussian_blur(torch.from_numpy(fine).to(self.device), 1.5)
               + gaussian_blur(torch.from_numpy(coarse).to(self.device), 6.0))
        lo, hi = tex.min(), tex.max()
        self.tex = (tex - lo) / (hi - lo) * 255
        self.tex_off = ((tw - width) / 2.0, (th - height) / 2.0)

    def _axis(self, scales: torch.Tensor, n: int, v: float, off: float,
              n_tex: int):
        """Per frame and output index along one axis: the two source
        indices (REFLECT_101) and the f32 fraction."""
        dev = self.device
        # the affine map's entries as f32 (warpAffine's float32 matrix),
        # applied in f64, the coordinate rounded to f32
        a = scales.to(torch.float32).to(torch.float64)[:, None]
        c = ((1 - scales) * v + off).to(torch.float32).to(
            torch.float64)[:, None]
        g = (a * torch.arange(n, dtype=torch.float64, device=dev)
             + c).to(torch.float32)
        i0 = torch.floor(g)
        frac = g - i0
        i0 = i0.to(torch.int64)

        def refl(i):
            i = i.abs()
            return torch.where(i >= n_tex, 2 * n_tex - 2 - i, i).clamp(
                0, n_tex - 1)

        return refl(i0), refl(i0 + 1), frac

    def gray_frames(self, t0: int, n: int) -> torch.Tensor:
        """Frames t0 .. t0+n-1 as (n, H, W) u8 gray on the device."""
        out = torch.empty((n, self.height, self.width), dtype=torch.uint8,
                          device=self.device)
        for b in range(0, n, _BLOCK):
            k = min(_BLOCK, n - b)
            out[b:b + k] = self._render(t0 + b, k)
        return out

    def _render(self, t0: int, n: int) -> torch.Tensor:
        dev = self.device
        th, tw = self.tex.shape
        ts = torch.arange(t0, t0 + n, dtype=torch.float64, device=dev)
        scales = torch.pow(torch.tensor(self.zoom, dtype=torch.float64,
                                        device=dev), -ts)
        vx, vy = self.vp
        ox, oy = self.tex_off
        x0, x1, fx = self._axis(scales, self.width, vx, ox, tw)
        y0, y1, fy = self._axis(scales, self.height, vy, oy, th)
        flat = self.tex.reshape(-1)

        def at(yy, xx):      # (n, H) rows x (n, W) columns -> (n, H, W)
            return flat[yy[:, :, None] * tw + xx[:, None, :]]

        fx, fy = fx[:, None, :], fy[:, :, None]
        v = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
             + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))
        return v.clamp(0, 255).to(torch.uint8)

    def _host(self, g: torch.Tensor) -> np.ndarray:
        g8 = g.cpu().numpy()
        return np.repeat(g8[..., None], 3, axis=-1) if self.color else g8

    def frame(self, t: int) -> np.ndarray:
        return self._host(self.gray_frames(t, 1)[0])

    def __iter__(self) -> Iterator[np.ndarray]:
        for t0 in range(0, self.n_frames, _BLOCK):
            n = min(_BLOCK, self.n_frames - t0)
            yield from self._host(self.gray_frames(t0, n))


def open_stream(spec: str, **kw):
    """"synthetic" or a file path -> frame iterable with width/height attrs."""
    if spec == "synthetic":
        return SyntheticRoadStream(**kw)
    if not os.path.exists(spec):
        raise FileNotFoundError(spec)
    return VideoReader(spec)

