"""Hough-style road-line voting over accepted flow segments: counterpart
of ``lk_tpu.geometry.hough`` (``segment_line_params``, ``hough_vote``,
``hough_peaks``, ``hough_road_lines``).

Every accepted flow segment votes for the infinite line it lies on in a
(theta, rho) parameter grid, and the whole accumulation is ONE f32 matmul
(``onehot(theta_bins).T @ weighted_onehot(rho_bins)``): no scatters, no
data-dependent control flow, any number of segments.  The product runs in
f32 with TF32 off (``torch.backends.cuda.matmul.allow_tf32``, False by
default; the caller keeps it so): on the card it is the library's f32
matmul, as ``lk_tpu``'s is XLA's.

Parameterization (classic normal form): a line is
``x*cos(theta) + y*sin(theta) = rho`` with ``theta in [0, pi)`` the normal
direction and ``rho in [-rho_max, rho_max]`` the signed distance from the
origin (image coordinates, y down; rho_max = hypot(W, H)).  A segment with
direction d votes for theta = angle(d) + 90deg (mod pi), rho from its
midpoint.  Votes are length-weighted by default.

Peak extraction is a k-step Python loop (``lk_tpu``'s ``lax.scan``): each
step takes the first maximum (``torch.argmax``, as ``jnp.argmax``), refines
it by a 3-tap parabola per axis and suppresses a window around it whose
radii default to the half-width at half maximum of the peak's own profile
(``_hwhm_radius``).  As in ``lk_tpu`` the profiles, and so the HWHM radii,
are read from the ORIGINAL accumulator, not from the suppressed one: a
weaker line between two strong ones can be suppressed by a radius that
saturates at the 16-bin clamp.  The port reproduces that choice
(tests/test_torch_hough.py pins it).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class HoughResult(NamedTuple):
    accumulator: torch.Tensor  # (n_theta, n_rho) float32 votes
    theta: torch.Tensor        # (k,) radians in [0, pi) — peak lines
    rho: torch.Tensor          # (k,) signed px distance from origin
    votes: torch.Tensor        # (k,) peak vote mass (<=0 marks empty slots)


def segment_line_params(start: torch.Tensor, stop: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(theta, rho) of the infinite line through each (N, 2) segment.

    theta in [0, pi); rho signed.  Zero-length segments get theta = pi/2
    and rho = y (atan2(0, 0) = 0) — callers mask them out.
    """
    d = stop - start
    # normal angle: segment direction rotated 90deg, folded into [0, pi)
    theta = torch.remainder(torch.atan2(d[..., 1], d[..., 0]) + math.pi / 2,
                            math.pi)
    mid = 0.5 * (start + stop)
    rho = mid[..., 0] * torch.cos(theta) + mid[..., 1] * torch.sin(theta)
    return theta, rho


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


def hough_vote(
    start: torch.Tensor,
    stop: torch.Tensor,
    mask: torch.Tensor,
    image_size: Tuple[int, int],
    n_theta: int = 180,
    n_rho: int = 256,
    length_weighted: bool = True,
) -> torch.Tensor:
    """Accumulate (N,) masked segments into an (n_theta, n_rho) vote grid.

    rho votes are bilinearly split between the two nearest bins; theta
    uses the nearest bin (the 0/pi wrap flips rho's sign)."""
    w, h = image_size
    rho_max = math.hypot(float(w), float(h))
    theta, rho = segment_line_params(start, stop)
    weight = torch.where(mask, 1.0, 0.0).to(torch.float32)
    if length_weighted:
        weight = weight * torch.linalg.vector_norm(stop - start, dim=-1)

    t_raw = torch.round(theta / math.pi * n_theta).to(torch.int64).clamp(
        0, n_theta)
    # (pi-eps, rho) is the SAME line as (0, -rho): folding to bin 0 flips
    # rho's sign with it
    rho = torch.where(t_raw == n_theta, -rho, rho)
    t_hot = _one_hot(t_raw % n_theta, n_theta)

    r_pos = (rho + rho_max) / (2.0 * rho_max) * (n_rho - 1)
    r_pos = r_pos.clamp(0.0, float(n_rho - 1))
    r_lo = torch.floor(r_pos).to(torch.int64)
    frac = r_pos - r_lo
    r_hot = (_one_hot(r_lo, n_rho) * (1.0 - frac)[:, None]
             + _one_hot(torch.clamp(r_lo + 1, max=n_rho - 1), n_rho)
             * frac[:, None])
    return torch.matmul((t_hot * weight[:, None]).T, r_hot)


_PROF_R = 16   # half-width of the per-peak profile window (bins)


def _axis_profile_theta(acc, t, r, n_theta, n_rho, offs):
    """(2*_PROF_R+1,) profile along theta through peak (t, r); across the
    0/pi wrap the neighbor is read at the MIRRORED rho bin."""
    raw = t + offs
    tt = torch.remainder(raw, n_theta)
    crossed = (raw < 0) | (raw >= n_theta)
    rr = torch.where(crossed, n_rho - 1 - r, r)
    return acc.reshape(-1)[tt * n_rho + rr]


def _axis_profile_rho(acc, t, r, n_rho, offs):
    """(2*_PROF_R+1,) profile along rho through peak (t, r), edge-clamped."""
    rr = torch.clamp(r + offs, 0, n_rho - 1)
    return acc.reshape(-1)[t * n_rho + rr]


def _parabolic_offset(prof):
    """Sub-bin offset of the apex from a 3-tap parabola at the profile
    center; 0 on a flat neighborhood."""
    c = _PROF_R
    ym, y0, yp = prof[c - 1], prof[c], prof[c + 1]
    denom = ym - 2.0 * y0 + yp
    ok = torch.abs(denom) > 1e-12
    safe = torch.where(ok, denom, 1.0)
    off = torch.where(ok, 0.5 * (ym - yp) / safe, 0.0)
    return off.clamp(-0.5, 0.5)


def _first_true(b: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D bool tensor, _PROF_R + 1 if none."""
    none = torch.tensor(_PROF_R + 1, device=b.device)
    return torch.where(b.any(), torch.argmax(b.to(torch.uint8)), none)


def _hwhm_radius(prof, val, max_r):
    """Half-width-at-half-max suppression radius: the first offset (either
    side) where the profile drops below half the peak value, clamped to
    [2, max_r]."""
    c = _PROF_R
    below = prof < 0.5 * val
    right = _first_true(below[c:])
    left = _first_true(torch.flip(below[:c + 1], (0,)))
    return torch.clamp(torch.maximum(left, right), 2, max_r)


def hough_peaks(
    acc: torch.Tensor,
    k: int = 4,
    image_size: Tuple[int, int] = (1, 1),
    suppress_theta: Optional[int] = None,
    suppress_rho: Optional[int] = None,
) -> HoughResult:
    """Top-k accumulator peaks: greedy non-max suppression + sub-bin
    refinement.  Theta distance wraps (bin 0 and bin n_theta-1 are
    neighbors, with the rho mirror).  Suppression radii default to each
    peak's HWHM on the original accumulator (clamped [2, _PROF_R]); pass
    suppress_theta/suppress_rho for fixed radii."""
    n_theta, n_rho = acc.shape
    w, h = image_size
    rho_max = math.hypot(float(w), float(h))
    dev = acc.device
    ti = torch.arange(n_theta, device=dev)
    ri = torch.arange(n_rho, device=dev)
    offs = torch.arange(-_PROF_R, _PROF_R + 1, device=dev)
    grid = acc
    ts, rs, vals = [], [], []
    for _ in range(k):
        flat = torch.argmax(grid)
        t, r = flat // n_rho, flat % n_rho
        val = grid[t, r]
        # profiles from the ORIGINAL accumulator (lk_tpu's choice)
        prof_t = _axis_profile_theta(acc, t, r, n_theta, n_rho, offs)
        prof_r = _axis_profile_rho(acc, t, r, n_rho, offs)
        sup_t = (_hwhm_radius(prof_t, val, _PROF_R) if suppress_theta is None
                 else torch.tensor(suppress_theta, device=dev))
        sup_r = (_hwhm_radius(prof_r, val, _PROF_R) if suppress_rho is None
                 else torch.tensor(suppress_rho, device=dev))
        # where the SHORTER theta path crosses the wrap the same line sits
        # at the mirrored rho bin: suppress there too
        diff = torch.abs(ti - t)
        dt = torch.minimum(diff, n_theta - diff)
        crossed = (n_theta - diff) < diff
        rho_near = torch.abs(ri[None, :] - r) <= sup_r
        rho_mirr = torch.abs(ri[None, :] - (n_rho - 1 - r)) <= sup_r
        win = (dt[:, None] <= sup_t) & torch.where(crossed[:, None],
                                                   rho_mirr, rho_near)
        t_sub = t.to(torch.float32) + _parabolic_offset(prof_t)
        # rho-edge peaks have clamped (non-data) neighbors: no offset
        r_off = torch.where((r == 0) | (r == n_rho - 1),
                            torch.zeros((), device=dev),
                            _parabolic_offset(prof_r))
        r_sub = r.to(torch.float32) + r_off
        grid = torch.where(win, -math.inf, grid)
        ts.append(t_sub)
        rs.append(r_sub)
        vals.append(val)
    ts, rs, vals = torch.stack(ts), torch.stack(rs), torch.stack(vals)
    theta = torch.remainder(ts, float(n_theta)) * (math.pi / n_theta)
    rho = rs / (n_rho - 1) * (2.0 * rho_max) - rho_max
    # a refined theta that wrapped below 0 names the same line at NEGATED
    # rho
    rho = torch.where(ts < 0.0, -rho, rho)
    return HoughResult(accumulator=acc, theta=theta, rho=rho, votes=vals)


def hough_road_lines(
    start: torch.Tensor,
    stop: torch.Tensor,
    mask: torch.Tensor,
    image_size: Tuple[int, int],
    k: int = 4,
    n_theta: int = 180,
    n_rho: int = 256,
    length_weighted: bool = True,
) -> HoughResult:
    """Vote + peak-extract in one call (the app-facing entry)."""
    acc = hough_vote(start, stop, mask, image_size, n_theta, n_rho,
                     length_weighted)
    return hough_peaks(acc, k, image_size)   # adaptive HWHM suppression
