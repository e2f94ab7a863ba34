"""Gaussian pyramid step: counterpart of ``lk_tpu.ops.blur.pyr_down``.

cv.pyrDown semantics: the 5-tap [1,4,6,4,1]/16 filter on both axes with
BORDER_REFLECT_101 borders, even-pixel decimation and output size ceil(n/2)
per axis.

Each axis is filtered as f32 shifted adds over gathered rows (columns), in
tap order, and decimated in the same step.  Every output element is the
same five-term sum whatever the leading batch shape, so a chunk of frames
decimates bit-identically to the frames one at a time — which a
convolution library does not promise (it may choose a different algorithm
for a batch than for one frame).
"""

from __future__ import annotations

import functools

import torch

_GAUSS5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


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
    """One pyramid level down over the trailing (H, W) axes.

    ``fast`` is accepted for signature parity with ``lk_tpu``: there it
    selects bf16-input matmuls, a TPU precision trade.  Here both forms
    are the same exact f32 arithmetic.
    """
    del fast
    x = img.to(torch.float32)
    return _filter_decimate(_filter_decimate(x, -2), -1)
