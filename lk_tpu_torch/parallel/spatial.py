"""Spatial (row-sharded) dense LK with halo exchange: counterpart of
``lk_tpu.parallel.spatial``.

Rows of a frame are sharded over the ``spatial`` mesh axis, one block per
rank; halos move between ring neighbours with ``dist.batch_isend_irecv``
on the axis's process group.  Under gloo with card tensors the halo rows
go through host memory (gloo moves CPU tensors only); NCCL sends them
from the card.

Halo envelope (the correctness contract, as lk_tpu's):

* One iteration of a dense LK level at pixel p reads image data within
  ``win_h//2 + max_disp + 2`` rows (window + warp reach + interpolation
  margin) and, through the coherence box sums, the *flow* of neighbours
  within ``win_h//2`` rows.
* Flow in the exchanged halo is computed from truncated data, so its error
  front moves inward ``win_h//2`` rows per further iteration.  A single
  exchange therefore needs
  ``halo = max_disp + win_h//2 + 4 + (n_iters - 1) * (win_h//2)``
  to keep every interior row exact for the full iteration count.  Every
  operation of the level is a stencil in a fixed order (shifted adds, no
  reduction whose order depends on the array), so interior rows equal the
  unsharded level bit for bit.
* ``exchange_per_iter=True`` instead re-exchanges a one-iteration halo
  (``max_disp + win_h//2 + 4``) before every iteration.  The XLA level's
  per-pixel eps early stop is carried across rounds and frozen pixels are
  masked outside the level call.  The mask tests the clipped delta
  ``f_new - f`` of the round, as lk_tpu/parallel/spatial.py:150-153 does,
  where the unsharded level tests the unclipped step ``du^2 + dv^2``; the
  port reproduces that choice (a pixel saturating at max_disp freezes
  here), pinned by tests/test_torch_parallel.py at the displacement bound.
  The fused kernels have no eps stop, so there the mask stays off.

At the frame's top and bottom ``halo_exchange`` pads with the edge row
replicated (lk_tpu's semantics): the level then sees replicated rows where
the unsharded one sees its own border, a belt of ``halo`` rows that
differs.  ``parallel.auto`` runs the same level without that padding, so
its edge rows match the unsharded solve too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow.dense import dense_lk_level


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through host memory: gloo moves CPU
    tensors only."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def neighbour_rows(x: torch.Tensor, halo: int, group):
    """(rows above, rows below): the ``halo`` last rows of the previous
    rank's block and the ``halo`` first rows of the next rank's, None at
    the frame's top and bottom (and for ``halo`` 0).  x: (local_h, ...);
    every block of the group must hold at least ``halo`` rows."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if halo == 0 or n == 1:
        return None, None
    if x.shape[0] < halo:
        raise ValueError(f"a {x.shape[0]}-row block cannot give a "
                         f"{halo}-row halo")
    staged = _staged(x, group)
    wire = torch.device("cpu") if staged else x.device
    ops, above, below = [], None, None
    for peer_at, rows in ((idx - 1, x[:halo]), (idx + 1, x[-halo:])):
        if not 0 <= peer_at < n:
            continue
        peer = dist.get_global_rank(group, peer_at)
        buf = torch.empty(rows.shape, dtype=x.dtype, device=wire)
        ops += [dist.P2POp(dist.isend, rows.to(wire).contiguous(), peer,
                           group),
                dist.P2POp(dist.irecv, buf, peer, group)]
        if peer_at < idx:
            above = buf
        else:
            below = buf
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        above = None if above is None else above.to(x.device)
        below = None if below is None else below.to(x.device)
    return above, below


def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Pad a row block with ``halo`` rows from its ring neighbours.

    x: (local_h, ...).  Returns (local_h + 2*halo, ...); at the frame's top
    and bottom the halo is the block's own edge row replicated (the
    reference's border handling)."""
    above, below = neighbour_rows(x, halo, group)
    if above is None:
        above = x[:1].expand((halo,) + x.shape[1:])
    if below is None:
        below = x[-1:].expand((halo,) + x.shape[1:])
    return torch.cat([above, x, below])


def _pad_rows(x, halo, group, edges: bool):
    """(x with its halo, rows added on top): ``halo_exchange``'s padding
    with ``edges``; without it, nothing is added at the frame's edges."""
    if edges:
        return halo_exchange(x, halo, group), halo
    above, below = neighbour_rows(x, halo, group)
    parts = [t for t in (above, x, below) if t is not None]
    return torch.cat(parts), 0 if above is None else halo


def iteration_halo(cfg: LKConfig, max_disp: int) -> int:
    """Rows one outer iteration can reach: window + warp + interp margin."""
    return max_disp + cfg.win_size[1] // 2 + 4


def single_exchange_halo(cfg: LKConfig, dense_cfg: DenseLKConfig,
                         max_disp: int) -> int:
    """The one exchange that keeps every interior row exact for all of the
    level's ``outer_iters`` (module docstring)."""
    return (iteration_halo(cfg, max_disp)
            + (dense_cfg.outer_iters - 1) * (cfg.win_size[1] // 2))


def level_rows(prev, nxt, flow, group, cfg: LKConfig,
               dense_cfg: DenseLKConfig, max_disp: int,
               exchange_per_iter: bool, edges: bool) -> torch.Tensor:
    """This rank's rows of one sharded dense LK level: prev, nxt (local_h,
    W), flow (local_h, W, 2) -> flow (local_h, W, 2)."""
    local_h = prev.shape[0]

    def run(prev_h, next_h, flow_h, top, dcfg):
        res = dense_lk_level(prev_h, next_h, flow_h, cfg, dcfg,
                             max_disp=max_disp)
        return res.flow[top:top + local_h]

    if not exchange_per_iter:
        halo = single_exchange_halo(cfg, dense_cfg, max_disp)
        prev_h, top = _pad_rows(prev, halo, group, edges)
        next_h, _ = _pad_rows(nxt, halo, group, edges)
        flow_h, _ = _pad_rows(flow, halo, group, edges)
        return run(prev_h, next_h, flow_h, top, dense_cfg)

    base = iteration_halo(cfg, max_disp)
    one_iter = dataclasses.replace(dense_cfg, outer_iters=1,
                                   iter_schedule=())
    # the XLA level stops a pixel once its step falls below eps; chopping
    # the loop into one-iteration calls would restart that test each
    # round, so the converged mask is carried across rounds and frozen
    # pixels are masked outside the call (the box sums read start-of-round
    # flow, so a frozen pixel feeds its neighbours what the unsharded
    # iteration would).  The fused kernels have no eps stop.
    track_eps = not dense_cfg.use_pallas_fused
    eps2 = cfg.eps * cfg.eps
    # frames do not change across iterations: exchange them once
    prev_h, top = _pad_rows(prev, base, group, edges)
    next_h, _ = _pad_rows(nxt, base, group, edges)
    f = flow.to(torch.float32)
    active = torch.ones(f.shape[:2], dtype=torch.bool, device=f.device)
    for _ in range(dense_cfg.outer_iters):
        flow_h, _ = _pad_rows(f, base, group, edges)
        f_new = run(prev_h, next_h, flow_h, top, one_iter)
        if not track_eps:
            f = f_new
            continue
        delta = f_new - f
        f = torch.where(active[..., None], f_new, f)
        active = active & (delta[..., 0] * delta[..., 0]
                           + delta[..., 1] * delta[..., 1] > eps2)
    return f


def spatial_dense_lk_level(mesh: DeviceMesh, cfg: LKConfig = LKConfig(),
                           dense_cfg: DenseLKConfig = DenseLKConfig(),
                           max_disp: int = 8, axis_name: str = "spatial",
                           exchange_per_iter: bool = True):
    """Build a row-sharded dense LK level: f(prev, next, flow_init) -> flow.

    prev, next: (H, W) and flow_init (H, W, 2), rows sharded over
    ``axis_name``: DTensors, or this rank's row blocks; the flow comes back
    the same way.  Interior rows match the single-device level for |flow|
    <= max_disp (module docstring); the level runs the port's
    ``dense_lk_level``, so under ``use_pallas_fused`` every round launches
    the fused kernel."""
    group = mesh.get_group(axis_name)

    def run(prev, nxt, flow_init):
        glob: Optional[DTensor] = prev if isinstance(prev, DTensor) else None
        prev, nxt, flow_init = (x.to_local() if isinstance(x, DTensor)
                                else x for x in (prev, nxt, flow_init))
        f = level_rows(prev.to(torch.float32), nxt.to(torch.float32),
                       flow_init, group, cfg, dense_cfg, max_disp,
                       exchange_per_iter, edges=True)
        if glob is None:
            return f
        return DTensor.from_local(f, glob.device_mesh, glob.placements,
                                  run_check=False)

    return run
