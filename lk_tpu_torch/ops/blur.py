"""Gaussian smoothing and the pyramid step: counterpart of
``lk_tpu.ops.blur`` (``_sep_filter_axis``, ``sep_filter2d``,
``gaussian_blur3``, ``pyr_down``, ``gaussian_pyramid``).

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

``build_pyramid`` is a whole pyramid: the base edge-replicated out to a
padded size (``edge_pad``), then pyrDown per level.  It and ``pyr_down``
dispatch on the device of their input: a CPU tensor goes to the plain
version (``build_pyramid_reference``, ``pyr_down_reference``), a CUDA
tensor to the pyramid kernel ``lk_tpu_torch/csrc/pyr_down.cu`` — one
launch for the pad and every level of all the leading dims' planes
(``pyr_down`` is its one-level, no-pad call), bit-equal to the plain
version — with no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_GAUSS3 = (0.25, 0.5, 0.25)
_GAUSS5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)

# Launches of the pyramid kernel (one per build_pyramid or pyr_down call),
# and calls of the plain versions.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


def _device_cache(fn):
    """``fn``, whose last argument is a device, behind an LRU cache that a
    CUDA graph capture on the calling thread bypasses: a graph would read a
    cached tensor after the cache had evicted and freed it, so a capture
    makes its own."""
    cached = functools.lru_cache(maxsize=64)(fn)

    @functools.wraps(fn)
    def call(*args):
        if (args[-1].type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            return fn(*args)
        return cached(*args)

    return call


@_device_cache
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


@_device_cache
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


def edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Edge-replicate the trailing (H, W) axes of x out to (hp, wp); x
    itself when it has that size."""
    h, w = x.shape[-2:]
    if (hp, wp) == (h, w):
        return x
    ri = torch.arange(hp, device=x.device).clamp(max=h - 1)
    ci = torch.arange(wp, device=x.device).clamp(max=w - 1)
    return x.index_select(-2, ri).index_select(-1, ci)


def _pyramid_geometry(frames: torch.Tensor, n_levels: int, pad_hw):
    """(hp, wp) of the base, after checking the arguments."""
    if frames.ndim < 2 or frames.numel() == 0:
        raise ValueError(f"a pyramid takes (..., H, W) planes, got "
                         f"{tuple(frames.shape)}")
    h, w = frames.shape[-2:]
    hp, wp = (h, w) if pad_hw is None else map(int, pad_hw)
    if hp < h or wp < w:
        raise ValueError(f"pad_hw {(hp, wp)} smaller than the frames "
                         f"{(h, w)}")
    if n_levels < 0 or (n_levels == 0 and (hp, wp) != (h, w)):
        raise ValueError(f"{n_levels} levels (a padded base needs >= 1)")
    return hp, wp


def build_pyramid(frames: torch.Tensor, n_levels: int,
                  pad_hw: tuple[int, int] | None = None) -> tuple:
    """Pyramid of (..., h, w) planes: the base edge-replicated out to
    ``pad_hw`` (default: no pad), then ``n_levels`` pyrDown levels, each
    (..., ceil(h_l/2), ceil(w_l/2)) float32.  When the base needs no pad,
    level 0 is ``frames.to(float32)`` itself."""
    if frames.device.type == "cpu":
        return build_pyramid_reference(frames, n_levels, pad_hw)
    if frames.device.type != "cuda":
        raise ValueError(f"build_pyramid: unsupported device "
                         f"{frames.device}")
    return _pyramid_cuda(frames, n_levels, pad_hw)


def gaussian_pyramid(img: torch.Tensor, max_level: int) -> list:
    """List of max_level + 1 float32 images, level 0 the input
    (cv.buildOpticalFlowPyramid), each level pyrDown of the one before.
    One ``build_pyramid`` call: on the card one launch of the pyramid
    kernel for every level, bit-equal to pyrDown level by level."""
    return list(build_pyramid(img, max_level))


def build_pyramid_reference(frames: torch.Tensor, n_levels: int,
                            pad_hw: tuple[int, int] | None = None) -> tuple:
    """Plain PyTorch form of ``build_pyramid``: ``edge_pad``, then the
    plain pyrDown per level."""
    global plain_calls
    hp, wp = _pyramid_geometry(frames, n_levels, pad_hw)
    if n_levels == 0:
        return (frames.to(torch.float32),)
    plain_calls += 1
    levels = [edge_pad(frames.to(torch.float32), hp, wp)]
    for _ in range(n_levels):
        levels.append(_pyr_down_plain(levels[-1]))
    return tuple(levels)


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
    return _pyramid_cuda(img, 1, None)[1]


def pyr_down_reference(img: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Plain PyTorch form of ``pyr_down`` (same signature)."""
    global plain_calls
    del fast
    plain_calls += 1
    return _pyr_down_plain(img)


def _pyr_down_plain(img: torch.Tensor) -> torch.Tensor:
    """Rows filtered and decimated first, then columns."""
    x = img.to(torch.float32)
    return _filter_decimate(_filter_decimate(x, -2), -1)


def _pyramid_cuda(frames: torch.Tensor, n_levels: int, pad_hw,
                  blocks_per_sm: int = 0) -> tuple:
    """The kernel's launch.  ``blocks_per_sm`` caps its cooperative grid
    below the resident maximum (0: no cap); every grid gives the same
    bits."""
    global kernel_launches
    from lk_tpu_torch import _build

    hp, wp = _pyramid_geometry(frames, n_levels, pad_hw)
    x = frames.to(torch.float32)
    if n_levels == 0:
        return (x,)
    lead, (h, w) = frames.shape[:-2], frames.shape[-2:]
    planes = x.reshape(-1, h, w).contiguous()
    n, dev = planes.shape[0], planes.device
    base = None if (hp, wp) == (h, w) else torch.empty(
        (n, hp, wp), dtype=torch.float32, device=dev)
    outs, lh, lw = [], hp, wp
    for _ in range(n_levels):
        lh, lw = (lh + 1) // 2, (lw + 1) // 2
        outs.append(torch.empty((n, lh, lw), dtype=torch.float32,
                                device=dev))
    ptrs = (ctypes.c_void_p * n_levels)(*(o.data_ptr() for o in outs))
    lib = _build.library()
    _build.launch(lib.lk_pyramid_launch, planes, "pyramid",
                  planes.data_ptr(),
                  None if base is None else base.data_ptr(), ptrs, n, h, w,
                  hp, wp, n_levels, blocks_per_sm)
    kernel_launches += 1
    first = x if base is None else base.reshape(*lead, hp, wp)
    return (first,) + tuple(o.reshape(*lead, *o.shape[-2:]) for o in outs)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/pyr_down.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lk_pyramid_launch.argtypes = [p, p, ctypes.POINTER(p)] + [i] * 7 \
        + [p]
    lib.lk_pyramid_launch.restype = i
