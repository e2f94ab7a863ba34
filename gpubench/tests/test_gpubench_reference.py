"""The dense reference: its static plan at the cell's size, and its
agreement with the program's plain versions at sizes the CPU runs in
seconds, against the gap the bfloat16 control opens on the same pair.

The reference is written from lk_tpu's stated semantics, not from the
program, so these are two independent readings of one definition: float64
against float32 leaves gaps of a few 1e-6 px, the control's rounding of
the frames some 1e-2 px."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import harness, scenes
from gpubench.drivers._base import lk_configs
from gpubench.reference import dense as ref

CONFIG = json.loads((harness.HERE / "configs" / "dense1080.json").read_text())
TRAFFIC = json.loads((harness.HERE / "traffic" / "video.json").read_text())


def test_the_interior_leaves_out_the_padded_edges():
    assert ref.interior(1080, 1920, CONFIG) == (1016, 1856)
    assert ref.interior(96, 160, CONFIG) == (96, 160)


def test_the_plan_at_1080p():
    plan = ref.Plan(1080, 1920, CONFIG["lk"], CONFIG["dense"])
    assert plan.top == 3 and plan.base == (1088, 2048)
    assert plan.sizes == [(1088, 2048), (544, 1024), (272, 512), (136, 256)]
    assert [g[1:3] for g in plan.geom] == [(272, 512), (272, 512),
                                           (272, 512), (136, 256)]
    assert [g[0] for g in plan.geom] == [False, False, False, True]
    assert plan.coarse == [True, True, True, False]
    assert [plan.iters(lv) for lv in range(4)] == [1, 1, 1, 6]


@pytest.mark.parametrize("hw", [(96, 160), (270, 480), (544, 1024)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_reference_agrees_with_the_plain_program(hw):
    from lk_tpu_torch import config as port_config
    from lk_tpu_torch.flow import dense

    torch.set_num_threads(2)
    t = dict(TRAFFIC, frames_per_clip=2)
    t["texture"] = dict(t["texture"], margin=32)
    lk, dense_cfg = lk_configs(port_config, CONFIG)
    for clip in scenes.dense_scenes(t, hw[0], hw[1], 2 ** 31 + 7, "cpu"):
        r = dense.dense_pyramidal_lk(clip[0], clip[1], lk,
                                     dense_cfg=dense_cfg)
        want = ref.pair_flow(clip[0], clip[1], CONFIG)
        got = ref.gaps((r.flow, r.min_eig, r.valid), want, CONFIG)
        control = ref.gaps(ref.pair_flow(clip[0], clip[1], CONFIG,
                                         low_precision=True), want, CONFIG)
        assert got["flow_gap_px"] < 1e-4 and got["min_eig_gap"] < 1e-5, got
        assert got["flow_mean_gap_px"] < 1e-5, got
        assert control["flow_gap_px"] > 1e-2, control
        assert control["flow_mean_gap_px"] > 1e-3, control
        assert control["min_eig_gap"] > 1e-3, control
        assert torch.equal(r.valid, want[2])
