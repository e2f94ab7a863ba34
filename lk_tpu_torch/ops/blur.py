"""Gaussian smoothing and the pyramid step: counterpart of
``lk_tpu.ops.blur`` (``_sep_filter_axis``, ``sep_filter2d``,
``gaussian_blur3``, ``pyr_down``).

Small separable stencils are f32 shifted adds over a REFLECT_101-padded
axis, the taps summed in order: ``((x[-1]*t0 + x[0]*t1) + x[1]*t2)``.
``gaussian_blur3`` is the [1,2,1]/4 kernel, horizontal pass first, so each
output is ``(0.25l + 0.5c) + 0.25r`` per axis (cv.GaussianBlur 3x3 sigma 0).

cv.pyrDown semantics: the 5-tap [1,4,6,4,1]/16 filter on both axes with
BORDER_REFLECT_101 borders, even-pixel decimation and output size ceil(n/2)
per axis.

Each axis is filtered as f32 shifted adds over gathered rows (columns), in
tap order, and decimated in the same step.  Every output element is the
same five-term sum whatever the leading batch shape, so a chunk of frames
decimates bit-identically to the frames one at a time — which a
convolution library does not promise (it may choose a different algorithm
for a batch than for one frame).

``pyr_down`` dispatches on the device of its input: a CPU tensor goes to
``pyr_down_reference`` (the plain version above), a CUDA tensor to the
pyrDown kernel ``lk_tpu_torch/csrc/pyr_down.cu`` — one launch for all the
leading dims' planes, bit-equal to the plain version — with no fallback
between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_GAUSS3 = (0.25, 0.5, 0.25)
_GAUSS5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)

# Launches of the pyrDown kernel, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


@functools.lru_cache(maxsize=64)
def reflect101_index(n: int, before: int, after: int,
                     device: torch.device) -> torch.Tensor:
    """Source indices of an axis of length n padded by ``before``/``after``
    with BORDER_REFLECT_101 (cba|abcd|cba), as ``jnp.pad(mode="reflect")``."""
    if n < 2 or before >= n or after >= n:
        raise ValueError(f"reflect pad ({before}, {after}) of length {n}")
    i = torch.arange(-before, n + after, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def _sep_filter_axis(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with a small symmetric kernel, REFLECT_101
    border, taps summed in order (``lk_tpu.ops.blur._sep_filter_axis``)."""
    x = x.to(torch.float32)
    k = len(taps)
    pad = k // 2
    n = x.shape[axis]
    xp = x.index_select(axis, reflect101_index(n, pad, pad, x.device))
    out = None
    for i, t in enumerate(taps):
        term = xp.narrow(axis, i, n) * t
        out = term if out is None else out + term
    return out


def sep_filter2d(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable 2-D filter over the trailing (H, W) axes, W first."""
    return _sep_filter_axis(_sep_filter_axis(x, taps, -1), taps, -2)


def gaussian_blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 sigma-0 Gaussian blur, float path (cv2 float32 semantics)."""
    return sep_filter2d(img, _GAUSS3)


@functools.lru_cache(maxsize=64)
def _reflect101_taps(n: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Source indices of the five taps of every even output position
    (cached: building them per call is ~30 tiny launches per axis)."""
    centre = 2 * torch.arange((n + 1) // 2, device=device)
    taps = []
    for k in range(len(_GAUSS5)):
        i = centre + (k - 2)
        i = torch.where(i < 0, -i, i)
        i = torch.where(i >= n, 2 * n - 2 - i, i)
        taps.append(i.clamp(0, n - 1))   # n == 1 has no reflection partner
    return tuple(taps)


def _filter_decimate(x: torch.Tensor, dim: int) -> torch.Tensor:
    out = None
    for t, idx in zip(_GAUSS5, _reflect101_taps(x.shape[dim], x.device)):
        term = x.index_select(dim, idx) * t
        out = term if out is None else out + term
    return out


def pyr_down(img: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """One pyramid level down over the trailing (H, W) axes:
    (..., H, W) -> (..., ceil(H/2), ceil(W/2)) float32.

    ``fast`` is accepted for signature parity with ``lk_tpu``: there it
    selects bf16-input matmuls, a TPU precision trade.  Here both forms
    are the same exact f32 arithmetic.
    """
    if img.device.type == "cpu":
        return pyr_down_reference(img, fast)
    if img.device.type != "cuda":
        raise ValueError(f"pyr_down: unsupported device {img.device}")
    return _pyr_down_cuda(img)


def pyr_down_reference(img: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Plain PyTorch form of ``pyr_down`` (same signature): rows filtered
    and decimated first, then columns."""
    global plain_calls
    del fast
    plain_calls += 1
    x = img.to(torch.float32)
    return _filter_decimate(_filter_decimate(x, -2), -1)


def _pyr_down_cuda(img: torch.Tensor) -> torch.Tensor:
    global kernel_launches
    from lk_tpu_torch import _build

    if img.ndim < 2 or img.numel() == 0:
        raise ValueError(f"pyr_down takes (..., H, W) planes, got "
                         f"{tuple(img.shape)}")
    h, w = img.shape[-2:]
    x = img.to(torch.float32).reshape(-1, h, w).contiguous()
    n = x.shape[0]
    out = torch.empty((n, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    rc = lib.lk_pyr_down_launch(
        x.data_ptr(), out.data_ptr(), n, h, w,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pyr_down kernel launch failed: CUDA error {rc} "
                           f"({lib.lk_error_string(rc).decode()})")
    kernel_launches += 1
    return out.reshape(*img.shape[:-2], *out.shape[-2:])


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/pyr_down.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lk_pyr_down_launch.argtypes = [p, p, i, i, i, p]
    lib.lk_pyr_down_launch.restype = i
