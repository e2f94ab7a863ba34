"""Row-sharded full pyramidal dense LK: counterpart of
``lk_tpu.parallel.auto``.

lk_tpu hands the whole solve to GSPMD, which partitions it over row shards
and inserts the halo collectives.  PyTorch has no such partitioner, so
here the halos are explicit:

* **The pyramid** is built on the row blocks: cv.pyrDown's 5-tap stride-2
  stencil needs two source rows on each side of an output's centre, so
  each rank takes a few rows from its neighbours, starts its block on an
  even row (pyrDown's centres) and keeps the outputs it owns.  Level l+1
  row i belongs to the rank that holds level l row 2i.
* **Each level** runs through the single-exchange spatial level
  (``parallel.spatial``), exact on the rows a rank owns.  The flow is
  upsampled x2 on the blocks, with one row from each neighbour.
* **A level whose blocks are shorter than its halo** is gathered whole on
  every rank (so are the coarser ones), solved whole, and each rank keeps
  its rows of the upsampled flow.  GSPMD ends up doing the same at the
  coarse levels in effect.
* **The frame's top and bottom** keep the level's own border handling: the
  edge ranks pad nothing there (``halo_exchange``'s replicated rows would
  leave a belt of deviating rows), so every row, edge rows included,
  equals the unsharded ``dense_pyramidal_lk``.

As in lk_tpu, the path takes the XLA level (``use_pallas_*`` off): the
fused kernels tile the level, and a tile's reference displacement depends
on where the tile starts, which a row block moves.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow.dense import (_effective_cfg, _upsample_flow,
                                     dense_lk_level, level_configs,
                                     pyramid_base_geometry)
from lk_tpu_torch.ops.blur import build_pyramid, edge_pad, pyr_down
from lk_tpu_torch.ops.resize import upsample2_linear
from lk_tpu_torch.parallel.spatial import (_staged, level_rows,
                                           neighbour_rows,
                                           single_exchange_halo)

_PYR_HALO = 3      # rows from each neighbour for pyrDown (2, +1 to start even)


def _gather_rows(x: torch.Tensor, counts: List[int], group) -> torch.Tensor:
    """The whole level from every rank's row block (blocks of ``counts``
    rows, in rank order), on every rank."""
    pad = max(counts)
    staged = _staged(x, group)
    send = x.cpu() if staged else x
    if send.shape[0] < pad:
        send = torch.cat([send, send.new_zeros(
            (pad - send.shape[0],) + send.shape[1:])])
    bufs = [torch.empty(send.shape, dtype=send.dtype, device=send.device)
            for _ in counts]
    dist.all_gather(bufs, send.contiguous(), group=group)
    full = torch.cat([b[:c] for b, c in zip(bufs, counts)])
    return full.to(x.device) if staged else full


def _bounds(counts: List[int]) -> List[int]:
    out = [0]
    for c in counts:
        out.append(out[-1] + c)
    return out


def sharded_dense_pyramidal_lk(mesh: DeviceMesh, cfg: LKConfig = LKConfig(),
                               dense_cfg: Optional[DenseLKConfig] = None,
                               axis: str = "spatial"):
    """Build f(prev, next) -> flow with rows sharded over ``axis``.

    prev/next: (H, W) as DTensors sharded on rows, or this rank's row
    blocks (any split, in rank order); returns this rank's (rows, W, 2) of
    the level-0 flow the same way."""
    if dense_cfg is None:
        dense_cfg = DenseLKConfig()
    assert not (dense_cfg.use_pallas_warp or dense_cfg.use_pallas_fused), (
        "the row-sharded solve takes the XLA level; the fused kernels' "
        "tiles would move with the row blocks")
    group = mesh.get_group(axis)
    idx, n = dist.get_rank(group), dist.get_world_size(group)

    def run(prev, nxt):
        glob = prev if isinstance(prev, DTensor) else None
        prev, nxt = (x.to_local() if isinstance(x, DTensor) else x
                     for x in (prev, nxt))
        counts = [None] * n
        dist.all_gather_object(counts, int(prev.shape[0]), group=group)
        h_true, w_true = sum(counts), prev.shape[1]
        ecfg = _effective_cfg(cfg, dense_cfg, (h_true, w_true))
        top = ecfg.max_level
        hp, wp = pyramid_base_geometry(h_true, w_true, ecfg, dense_cfg)
        counts[-1] += hp - h_true            # the base's edge pad, below
        pair = torch.stack([prev, nxt]).to(torch.float32)
        if idx == n - 1 or wp != w_true:
            pair = edge_pad(pair, pair.shape[1] + (hp - h_true
                                                   if idx == n - 1 else 0),
                            wp)
        level_cfgs = level_configs(dense_cfg, top)
        flow = _solve(pair, counts, ecfg, dense_cfg, level_cfgs, top, group,
                      idx)
        if idx == n - 1:
            flow = flow[:flow.shape[0] - (hp - h_true)]
        flow = flow[:, :w_true]
        if glob is None:
            return flow
        return DTensor.from_local(flow, glob.device_mesh, glob.placements,
                                  run_check=False)

    return run


def _solve(pair, counts, cfg, dense_cfg, level_cfgs, top, group, idx):
    """This rank's rows of the level-0 flow from its rows of the (2, rows,
    W) base pair (module docstring)."""
    # row bounds of every rank at every level: level l+1 row i belongs to
    # the rank holding level l row 2i
    bounds = [_bounds(counts)]
    heights = [bounds[0][-1]]
    for _ in range(top):
        bounds.append([(b + 1) // 2 for b in bounds[-1]])
        heights.append((heights[-1] + 1) // 2)
    halos = [single_exchange_halo(cfg, level_cfgs[lv],
                                  dense_cfg.level_disp(lv))
             for lv in range(top + 1)]
    # the sharded levels: 0 .. n_sh - 1, every block at least its halo
    n_sh = 0
    while n_sh <= top and min(b - a for a, b in zip(
            bounds[n_sh][:-1], bounds[n_sh][1:])) >= halos[n_sh]:
        n_sh += 1

    # pyramid: the sharded levels on the blocks, the rest whole
    blocks = [pair]
    for lv in range(1, n_sh):
        blocks.append(_pyr_down_rows(blocks[-1], bounds[lv - 1], group, idx))
    whole = []
    if n_sh <= top:
        if n_sh == 0:
            base = _gather_rows(pair.movedim(1, 0), _counts(bounds[0]),
                                group).movedim(0, 1)
        else:
            below = _gather_rows(blocks[-1].movedim(1, 0),
                                 _counts(bounds[n_sh - 1]),
                                 group).movedim(0, 1)
            base = pyr_down(below)
        whole = [None] * n_sh + list(build_pyramid(base, top - n_sh))

    # coarse to fine
    flow = None
    for lv in range(top, -1, -1):
        c, disp = level_cfgs[lv], dense_cfg.level_disp(lv)
        if lv >= n_sh:
            h, w = whole[lv].shape[-2:]
            if flow is None:
                flow = torch.zeros((h, w, 2), dtype=torch.float32,
                                   device=pair.device)
            else:
                flow = _upsample_flow(flow.movedim(-1, 0), h, w).movedim(0, -1)
            flow = dense_lk_level(whole[lv][0], whole[lv][1], flow, cfg, c,
                                  max_disp=disp).flow
            continue
        a, b = bounds[lv][idx], bounds[lv][idx + 1]
        w = blocks[lv].shape[-1]
        if flow is None:
            flow = torch.zeros((b - a, w, 2), dtype=torch.float32,
                               device=pair.device)
        elif lv + 1 >= n_sh:          # from the whole coarser flow
            flow = _upsample_flow(flow.movedim(-1, 0), heights[lv],
                                  w).movedim(0, -1)[a:b]
        else:
            flow = _upsample_rows(flow, bounds[lv + 1], a, b, heights[lv],
                                  w, group, idx)
        flow = level_rows(blocks[lv][0], blocks[lv][1], flow, group, cfg, c,
                          disp, exchange_per_iter=False, edges=False)
    return flow


def _counts(bounds: List[int]) -> List[int]:
    return [b - a for a, b in zip(bounds[:-1], bounds[1:])]


def _pyr_down_rows(block, bounds, group, idx):
    """This rank's rows of the next pyramid level from its (2, rows, W)
    block of this one (``bounds``: every rank's rows here)."""
    a, b = bounds[idx], bounds[idx + 1]
    rows = block.movedim(1, 0)                       # (rows, 2, W)
    above, below = neighbour_rows(rows, _PYR_HALO, group)
    ext = torch.cat([t for t in (above, rows, below) if t is not None]
                    ).movedim(0, 1)
    first = a - (0 if above is None else _PYR_HALO)  # ext row 0's level row
    start = first + (first % 2)                      # an even centre
    out = pyr_down(ext[:, start - first:])
    lo = (a + 1) // 2                                 # first owned output
    return out[:, lo - start // 2:lo - start // 2 + ((b + 1) // 2 - lo)]


def _upsample_rows(flow, coarse_bounds, a, b, h, w, group, idx):
    """Rows [a, b) of the x2 upsampled flow (level height h) from this
    rank's rows of the coarser flow, with one row from each neighbour."""
    above, below = neighbour_rows(flow, 1, group)
    ext = torch.cat([t for t in (above, flow, below) if t is not None])
    s0 = coarse_bounds[idx] - (0 if above is None else 1)
    up = upsample2_linear(ext.movedim(-1, 0), 2 * ext.shape[0], w) * 2.0
    return up.movedim(0, -1)[a - 2 * s0:b - 2 * s0]
