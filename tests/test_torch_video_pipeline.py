"""The single-stream VP pipeline end to end: lk_tpu_torch's
``make_chunk_runner`` step and ``VideoPipeline`` (device="cpu", the plain
pyramid) against lk_tpu's on the same frames of
``lk_tpu.io.video.SyntheticRoadStream``.

Tolerances, and why: both sides take the same decisions, but the tracker's
window sums, the pyramid's coarse levels and the VP ring sums are taken in
another order (and XLA on the CPU contracts products into FMAs), so
positions differ in their last bits: csv rows, VP updates and states'
points <= 1e-3 px, with the same row counts, masks and shown frames;
cross points, which near-parallel flow lines amplify by 1/sin of their
angle, <= 1e-3 px + 1e-4 relative.

Against the committed golden files of tests/test_golden_trajectory.py
(lk_tpu's recorded outputs): the same row counts, atol 0.05 px, that
file's own tolerance."""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu.models import PRESETS
from lk_tpu.pipeline import runner as jrunner
from lk_tpu_torch.pipeline import runner as trunner
from lk_tpu_torch.pipeline import state as tstate
from torch_parity import port_cfg

W, H, F, CHUNK = 430, 242, 24, 8
CFGS = {name: dataclasses.replace(PRESETS[name], width=W)
        for name in ("final", "classify")}


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticRoadStream(width=W, height=H, n_frames=F, zoom=1.03,
                                seed=4, vp=(W * 0.47, H * 0.44))
    return [scene.frame(t) for t in range(F)]


@pytest.fixture(scope="module")
def runs(frames):
    """Per preset, lk_tpu's VideoPipeline and the port's over the frames."""
    out = {}
    for name, cfg in CFGS.items():
        j = jrunner.VideoPipeline(cfg, src_size=(W, H), chunk=CHUNK)
        j.run(iter(frames))
        t = trunner.VideoPipeline(port_cfg(cfg), src_size=(W, H),
                                  chunk=CHUNK, device="cpu")
        t.run(iter(frames))
        out[name] = j, t
    return out


@pytest.mark.parametrize("preset", list(CFGS))
def test_video_pipeline_matches_lk_tpu(runs, preset):
    j, t = runs[preset]
    assert t.frames_done == j.frames_done == F - 1
    assert t.consumed_init_frame and j.consumed_init_frame
    assert len(t.csv_rows) == len(j.csv_rows) > 5
    np.testing.assert_allclose(np.array(t.csv_rows), np.array(j.csv_rows),
                               rtol=0, atol=1e-3)
    assert [v is None for v in t.vp_per_frame] == [
        v is None for v in j.vp_per_frame]
    assert len(t.cross_points) == len(j.cross_points)
    np.testing.assert_allclose(np.array(t.cross_points),
                               np.array(j.cross_points), rtol=1e-4,
                               atol=1e-3)
    assert len(t.segments) == len(j.segments)
    np.testing.assert_allclose(
        np.array([s["stop"] for s in t.segments]),
        np.array([s["stop"] for s in j.segments]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.array(t.motion_rows),
                               np.array(j.motion_rows), rtol=0, atol=1e-4)


def test_single_stream_state_shapes(runs):
    """The single-stream state keeps lk_tpu's single-stream shapes (no
    stream axis), leaf for leaf."""
    j, t = runs["final"]
    jl = jax.tree_util.tree_leaves(j.state)
    tl = [x for x in _leaves(t.state)]
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [y for x in tree for y in _leaves(x)]


def test_one_chunk_of_step_from_shared_state(frames):
    """Both packages run one chunk of the single-stream step from lk_tpu's
    state after the first-frame detection, on lk_tpu's preprocessed
    frames."""
    cfg = CFGS["final"]
    h = cfg.derived_height(H, W)
    run_j, init_j, _ = jrunner._cached_runner(cfg, (W, h))
    pre = jrunner._cached_preprocess(cfg, h, W)
    grays = jax.vmap(pre)(jnp.asarray(np.stack(frames[:CHUNK + 1])))
    jst = jax.device_get(init_j(grays[0]))
    j_state, j_out = jax.device_get(run_j(jst, grays[1:]))

    tcfg = port_cfg(cfg)
    run_t, _, _ = trunner.make_chunk_runner(tcfg, (W, h), device="cpu")
    start = tstate.without_stream_axis(
        tstate.state_from_numpy(jst._asdict(), tcfg, device="cpu"))
    assert start.pts.shape == jst.pts.shape
    t_state, t_out = run_t(start, torch.from_numpy(np.array(grays[1:])))

    for k in ("update_mask", "cp_mask", "show_mask", "vp_hidden",
              "line_mask", "pts_valid", "live_count", "vp_init"):
        np.testing.assert_array_equal(getattr(t_out, k).numpy(),
                                      np.asarray(getattr(j_out, k)),
                                      err_msg=k)
    m = np.asarray(j_out.update_mask)
    assert m.any()
    np.testing.assert_allclose(t_out.update_rows.numpy()[m],
                               np.asarray(j_out.update_rows)[m], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(t_out.vp_xy.numpy(), np.asarray(j_out.vp_xy),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t_state.valid.numpy(),
                                  np.asarray(j_state.valid))
    np.testing.assert_allclose(t_state.pts.numpy(), np.asarray(j_state.pts),
                               rtol=0, atol=1e-3)
    assert int(t_state.tp_ult) == int(j_state.tp_ult)


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        rows = list(csv.reader(f))[1:]
    return np.array([[float(a), float(b)] for a, b in rows], np.float64)


def _check_golden(name, got):
    want = _golden(name)
    got = np.asarray(got, np.float64).reshape(-1, 2)
    assert len(got) == len(want), (name, len(got), len(want))
    np.testing.assert_allclose(got, want, atol=0.05, err_msg=name)


def test_golden_seed42():
    """vps_synthetic_seed42.csv: the default config on an 860x484 clip."""
    from lk_tpu_torch.config import PipelineConfig

    scene = SyntheticRoadStream(width=860, height=484, zoom=1.03, seed=42,
                                n_frames=36)
    pipe = trunner.VideoPipeline(PipelineConfig(), src_size=(860, 484),
                                 chunk=8, device="cpu")
    pipe.run(iter(scene))
    _check_golden("vps_synthetic_seed42.csv", pipe.csv_rows)


def _multievent_frames():
    """tests/test_golden_trajectory.py's three scene phases with distinct
    VPs (init -> track -> jump -> hide -> re-init twice)."""
    frames = []
    for vp, seed in [((160, 100), 3), ((270, 120), 9), ((205, 140), 5)]:
        s = SyntheticRoadStream(width=430, height=242, zoom=1.05, seed=seed,
                                n_frames=40, vp=vp)
        frames += [s.frame(t) for t in range(40)]
    return frames


@pytest.mark.parametrize("preset", ["final", "classify"])
def test_golden_multievent(preset):
    """vps_multievent_<preset>.csv and vpf_multievent_<preset>.csv (the
    shown VP per frame, -1 where hidden)."""
    cfg = port_cfg(dataclasses.replace(PRESETS[preset], width=430,
                                       hide_vp_thold=10))
    pipe = trunner.VideoPipeline(cfg, src_size=(430, 242), chunk=10,
                                 device="cpu")
    pipe.run(iter(_multievent_frames()))
    _check_golden(f"vps_multievent_{preset}.csv", pipe.csv_rows)
    trace = [v if v is not None else (-1.0, -1.0) for v in pipe.vp_per_frame]
    _check_golden(f"vpf_multievent_{preset}.csv", trace)
