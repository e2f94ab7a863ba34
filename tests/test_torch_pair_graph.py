"""The per-pair program's split into coarse levels and the finest level
(CPU, the port alone).

``dense_flow_from_levels`` runs levels top..1 (``_coarse_levels``), then
level 0 (the call it returns): the split along which ``dense_pyramidal_lk``
replays its CUDA graph on the card.  Held bit for bit to the single level
loop it replaced, kept here as it was, for paths A, B and C; and CPU calls
never reach the graph cache.  The graph itself is tested on the card
(tests/test_torch_cuda.py).
"""

import pytest
import torch

from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow import dense as td

torch.set_num_threads(1)

CFG = LKConfig()
PATHS = {
    "A": DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True),
    "B": DenseLKConfig(use_pallas_warp=True, fused_grads_in_kernel=False),
    "C": DenseLKConfig(),
    # one level: the finest level is the top, the coarse part only seeds
    "A_one_level": DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True,
                                 pyramid_levels=1),
}


def _pair(h, w, seed=0):
    """Blurred noise and a copy moved (2.4, 1) px."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((1, 1, h + 8, w + 8), generator=g) * 255
    k = torch.ones((1, 1, 5, 5)) / 25
    img = torch.nn.functional.conv2d(img, k)[0, 0, :h, :w].contiguous()
    a, b = torch.roll(img, (1, 2), (0, 1)), torch.roll(img, (1, 3), (0, 1))
    return img, 0.6 * a + 0.4 * b


def _single_loop(prev_levels, next_levels, cfg, dense_cfg, true_hw,
                 init_flow=None, return_top_flow=False):
    """``dense_flow_from_levels`` as one loop over every level, as it was
    before the split."""
    cfg = td._effective_cfg(cfg, dense_cfg, true_hw)
    h_true, w_true = true_hw
    top = cfg.max_level
    h_top, w_top = prev_levels[top].shape[-2:]
    dev = prev_levels[top].device
    if init_flow is None:
        flow = torch.zeros((h_top, w_top, 2), dtype=torch.float32,
                           device=dev)
    else:
        flow = init_flow.to(torch.float32)
        if tuple(flow.shape[:2]) != (h_top, w_top):
            flow = td.edge_pad(flow.movedim(-1, 0), h_top,
                               w_top).movedim(0, -1)
    level_cfgs = td.level_configs(dense_cfg, top)

    def _grads_path(level):
        c = level_cfgs[level]
        return c.use_pallas_fused and c.fused_grads_in_kernel

    coarse_ok = [False] * (top + 1)
    for level in range(top if dense_cfg.fused_coarse_chain else 0):
        c = level_cfgs[level]
        if not (_grads_path(level) and _grads_path(level + 1)
                and c.outer_iters == 1):
            continue
        h, w = prev_levels[level].shape[-2:]
        h2, w2 = prev_levels[level + 1].shape[-2:]
        if (h2, w2) != (h // 2, w // 2):
            continue
        g_res, th, tw, hp, wp = td.pallas_level_geometry(h, w, c)
        coarse_ok[level] = (not g_res and (hp, wp) == (h, w)
                            and th % 16 == 0 and tw % 256 == 0)
    result = None
    top_flow = None
    planes = False
    for level in range(top, -1, -1):
        use_coarse = level != top and coarse_ok[level] and planes
        if level != top and not use_coarse:
            h, w = prev_levels[level].shape[-2:]
            if not planes:
                flow = flow.movedim(-1, 0)
            flow = td._upsample_flow(flow, h, w).movedim(0, -1)
        want_planes = level > 0 and coarse_ok[level - 1]
        result = td.dense_lk_level(
            prev_levels[level], next_levels[level],
            None if use_coarse else flow, cfg, level_cfgs[level],
            max_disp=dense_cfg.level_disp(level),
            coarse_planes_init=flow if use_coarse else None,
            planes_out=want_planes)
        flow = result.flow
        planes = want_planes
        if level == top and return_top_flow:
            top_flow = flow.movedim(0, -1) if planes else flow
    if tuple(result.flow.shape[:2]) != (h_true, w_true):
        result = td.DenseFlowResult(flow=result.flow[:h_true, :w_true],
                                    min_eig=result.min_eig[:h_true, :w_true],
                                    valid=result.valid[:h_true, :w_true])
    if return_top_flow:
        return result, top_flow
    return result


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("hw", [(64, 512), (82, 512), (67, 141)])
@pytest.mark.parametrize("path", list(PATHS))
def test_split_equals_single_loop(path, hw, seeded):
    """Flow, min_eig, valid and the top flow equal bit for bit, from zeros
    and from a seeded top flow (sized for the unpadded top, so edge-padded
    where the base is padded)."""
    dcfg = PATHS[path]
    prev, nxt = _pair(*hw)
    cfg = td._effective_cfg(CFG, dcfg, hw)
    levels = td.build_frame_levels(torch.stack([prev, nxt]), cfg, dcfg)
    pl, nl = [lv[0] for lv in levels], [lv[1] for lv in levels]
    init = None
    if seeded:
        top = cfg.max_level
        g = torch.Generator().manual_seed(3)
        init = torch.rand((hw[0] >> top, hw[1] >> top, 2), generator=g) - 0.5
    got, got_top = td.dense_flow_from_levels(pl, nl, cfg, dcfg, hw,
                                             init_flow=init,
                                             return_top_flow=True)
    want, want_top = _single_loop(pl, nl, cfg, dcfg, hw, init_flow=init,
                                  return_top_flow=True)
    assert _equal(got, want)
    assert torch.equal(got_top, want_top)
    assert _equal(td.dense_flow_from_levels(pl, nl, cfg, dcfg, hw,
                                            init_flow=init), want)


@pytest.mark.parametrize("path", ["A", "C"])
def test_cpu_calls_never_reach_the_graph_cache(path):
    """Every CPU call runs op by op and counts as eager; no key is made."""
    prev, nxt = _pair(64, 160, seed=1)
    td.reset_counters()
    keys = len(td._pair_graphs)
    first = td.dense_pyramidal_lk(prev, nxt, CFG, dense_cfg=PATHS[path])
    again = [td.dense_pyramidal_lk(prev, nxt, CFG, dense_cfg=PATHS[path])
             for _ in range(2)]
    assert td.pair_graph_counts == {"captures": 0, "replays": 0, "eager": 3}
    assert len(td._pair_graphs) == keys == 0
    assert all(_equal(first, r) for r in again)
    td.reset_counters()
    assert td.pair_graph_counts == {"captures": 0, "replays": 0, "eager": 0}
