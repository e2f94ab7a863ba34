"""The port's level geometry and video plan equal lk_tpu's (pure integers).

The reference tiles and the plan's accept/reject decide the numerics (each
tile warps with its own reference displacement; a rejected plan takes the
per-call path), so the port must reproduce them exactly."""

import dataclasses

import pytest

from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow import dense as jd
from lk_tpu.flow import pallas_kernels as pk
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.flow import lk_kernels as lk
from torch_parity import port_cfg

SHAPES = [(1080, 1920), (720, 1280), (544, 960), (272, 480), (128, 1024),
          (64, 384),
          # 119 true rows clamp to 3 levels while the 128-row padded base
          # would allow 4 (dense.py's depth-clamp case)
          (119, 1024)]

CONFIGS = {
    "production": (LKConfig(),
                   DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True)),
    "default": (LKConfig(), DenseLKConfig()),
    "fused": (LKConfig(), DenseLKConfig(use_pallas_fused=True)),
    "test_video": (LKConfig(max_level=1),
                   DenseLKConfig(use_pallas_fused=True, iter_schedule=(1, 4),
                                 pyramid_levels=2, video_chunk=3,
                                 scharr_mxu=False)),
    "warm": (LKConfig(),
             DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True,
                           video_warm_start=True,
                           iter_schedule=(1, 1, 1, 2))),
    "max_level_honored": (LKConfig(max_level=3),
                          DenseLKConfig(use_pallas_fused=True,
                                        pyramid_levels=0)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("hw", SHAPES)
def test_plan_matches_lk_tpu(hw, name):
    cfg, dcfg = CONFIGS[name]
    tcfg, tdcfg = port_cfg(cfg), port_cfg(dcfg)
    h, w = hw
    assert (dataclasses.asdict(td._effective_cfg(tcfg, tdcfg, hw))
            == dataclasses.asdict(jd._effective_cfg(cfg, dcfg, hw)))
    base_t = td.pyramid_base_geometry(h, w, tcfg, tdcfg)
    assert base_t == jd.pyramid_base_geometry(h, w, cfg, dcfg)
    ecfg = jd._effective_cfg(cfg, dcfg, hw)
    plan_t = td._video_level_plan(port_cfg(ecfg), tdcfg, base_t, true_hw=hw)
    plan_j = jd._video_level_plan(ecfg, dcfg, base_t, true_hw=hw)
    assert (plan_t is None) == (plan_j is None)
    if plan_t is not None:
        # lk_tpu's entries carry one more field, the unified pad tuple
        assert [tuple(p) for p in plan_t] == [tuple(p)[:8] for p in plan_j]
        for p, q in zip(plan_t, plan_j):
            assert td._unified_pad_geometry(p.th, p.tw, p.disp,
                                            p.local) == q.pads
    # the per-level geometry of every level the per-call path would see
    hs, ws = base_t
    for level in range(ecfg.max_level + 1):
        lcfg = dataclasses.replace(
            dcfg, outer_iters=dcfg.level_iters(level),
            use_pallas_fused=True, warp_local=dcfg.level_local(level),
            fused_resident_max_h=(dcfg.fused_resident_max_h
                                  if level == ecfg.max_level else 0))
        for c in (dcfg, lcfg):
            assert (td.pallas_level_geometry(hs, ws, port_cfg(c))
                    == jd.pallas_level_geometry(hs, ws, c))
        hs, ws = -(-hs // 2), -(-ws // 2)


def test_production_plan_at_1080p():
    """The plan the main path runs: base 1088x2048, L0..L2 one iteration on
    272x512 tiles, the 136x256 top resident with 6 iterations."""
    cfg, dcfg = (port_cfg(c) for c in CONFIGS["production"])
    hw = (1080, 1920)
    base = td.pyramid_base_geometry(*hw, cfg, dcfg)
    assert base == (1088, 2048)
    plan = td._video_level_plan(td._effective_cfg(cfg, dcfg, hw), dcfg, base,
                                true_hw=hw)
    assert [(p.h, p.w, p.th, p.tw, p.resident, p.iters, p.local, p.disp)
            for p in plan] == [
        (1088, 2048, 272, 512, False, 1, 3, 32),
        (544, 1024, 272, 512, False, 1, 4, 16),
        (272, 512, 272, 512, False, 1, 5, 8),
        (136, 256, 136, 256, True, 6, 5, 4),
    ]


@pytest.mark.parametrize("w", [16, 100, 384, 480, 512, 513, 640, 960, 1000,
                               1024, 1280, 1920, 2048, 3000])
def test_pick_tile_w_matches_lk_tpu(w):
    assert lk.pick_tile_w(w) == pk.pick_tile_w(w)
