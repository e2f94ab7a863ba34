"""The dense chain end to end: lk_tpu_torch against lk_tpu on the same
numpy frames (CPU; lk_tpu's Pallas makers in interpret mode).

The tolerances are those of tests/test_torch_lk_level.py carried through
the pyramid: lk_tpu's kernels round box-sum and coarse-upsample data to
bf16 (pallas_kernels.py:573-575, 665); the port is exact f32.  With those
casts mapped to f32 the two chains agree to f32 summation order."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lk_tpu.flow.pallas_kernels as pk
from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow import dense as jd
from lk_tpu_torch.flow import dense as td
from torch_parity import (AFFINE, affine_clip, f32_jnp, interpret_pallas,
                          port_cfg)

CFG = LKConfig(max_level=1)
DCFG = DenseLKConfig(use_pallas_fused=True, iter_schedule=(1, 4),
                     pyramid_levels=2, video_chunk=3, scharr_mxu=False)
# the port's own copies of the same configs
TCFG, TDCFG = port_cfg(CFG), port_cfg(DCFG)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _gt_epe(flow, margin=24):
    """Mean EPE against the exact affine flow, interior pixels."""
    h, w = flow.shape[-3:-1]
    ys, xs = np.mgrid[margin:h - margin, margin:w - margin].astype(np.float32)
    gx = AFFINE[0, 0] * xs + AFFINE[0, 1] * ys + AFFINE[0, 2] - xs
    gy = AFFINE[1, 0] * xs + AFFINE[1, 1] * ys + AFFINE[1, 2] - ys
    f = np.asarray(flow)[..., margin:h - margin, margin:w - margin, :]
    return float(np.hypot(f[..., 0] - gx, f[..., 1] - gy).mean())


def _assert_results_close(jr, tr, flow_max, flow_mean, eig_rel, flips):
    """Flow is compared where both sides agree on the gate: a pixel whose
    min_eig sits on the threshold may pass on one side only, and then one
    side solves while the other keeps its input (the flips bound)."""
    fj, ft = np.asarray(jr.flow), tr.flow.numpy()
    assert fj.shape == ft.shape
    same = np.asarray(jr.valid) == tr.valid.numpy()
    assert (~same).mean() <= flips, (~same).mean()
    d = np.abs(fj - ft)[same]
    assert d.max() < flow_max, d.max()
    assert d.mean() < flow_mean, d.mean()
    me_j, me_t = np.asarray(jr.min_eig), tr.min_eig.numpy()
    rel = np.abs(me_j - me_t).max() / np.abs(me_j).max()
    assert rel < eig_rel, rel


@pytest.fixture(scope="module")
def clip():
    return affine_clip(np.random.default_rng(1234), 128, 1024, 8)


@pytest.fixture(scope="module")
def port_chunked(clip):
    return td.dense_pyramidal_lk_video(torch.from_numpy(clip), TCFG, TDCFG)


def test_video_matches_lk_tpu(clip, port_chunked):
    """8 frames = 2 chunks of 3 pairs + a 1-pair chunk in the port (lk_tpu
    runs that pair through its per-frame chain): flow, min_eig and valid
    within the bf16 tolerance."""
    jr = jd.dense_pyramidal_lk_video(jnp.asarray(clip), CFG, DCFG)
    _assert_results_close(jr, port_chunked, flow_max=0.05, flow_mean=5e-3,
                          eig_rel=5e-3, flips=1e-3)
    assert _gt_epe(jr.flow) < 0.1
    assert _gt_epe(port_chunked.flow) < 0.1


def test_video_matches_lk_tpu_f32(clip, port_chunked, monkeypatch):
    """The same chain with lk_tpu's bf16 casts mapped to f32: the pyramids
    and every level agree to f32 summation order."""
    monkeypatch.setattr(pk, "jnp", f32_jnp())
    jr = jd.dense_pyramidal_lk_video(jnp.asarray(clip), CFG, DCFG)
    _assert_results_close(jr, port_chunked, flow_max=1e-3, flow_mean=1e-5,
                          eig_rel=1e-5, flips=1e-4)


@pytest.mark.parametrize("n_pairs", [3, 4, 5, 7])
def test_chunked_equals_per_frame(clip, n_pairs, monkeypatch):
    """The port's chunked chain equals its per-frame chain bit for bit, at
    chunk 4: one short chunk, no leftover, leftover 1 and leftover 3, the
    leftover pairs one shorter chunk with one pyramid build."""
    frames = torch.from_numpy(clip[:n_pairs + 1])
    builds = []
    real = td.build_pyramid

    def counted(x, *a, **k):
        builds.append(x.shape[0])
        return real(x, *a, **k)

    monkeypatch.setattr(td, "build_pyramid", counted)
    chunked = td.dense_pyramidal_lk_video(
        frames, TCFG, dataclasses.replace(TDCFG, video_chunk=4))
    # one build of each chunk's frames
    assert builds == [min(4, n_pairs - c) + 1 for c in range(0, n_pairs, 4)]
    per_frame = td.dense_pyramidal_lk_video(
        frames, TCFG, dataclasses.replace(TDCFG, video_chunk=0))
    assert chunked.flow.shape == (n_pairs, 128, 1024, 2)
    for a, b in zip(chunked, per_frame):
        assert torch.equal(a, b)


def test_ground_truth_epe(port_chunked):
    assert port_chunked.flow.shape == (7, 128, 1024, 2)
    assert _gt_epe(port_chunked.flow.numpy()) < 0.1


def test_warm_start_matches_lk_tpu(clip):
    """Opt-in warm start (top level seeded with the previous pair's flow,
    warm_top_iters there) on 5 frames."""
    dcfg = dataclasses.replace(DCFG, video_warm_start=True, video_chunk=0)
    jr = jd.dense_pyramidal_lk_video(jnp.asarray(clip[:5]), CFG, dcfg)
    tr = td.dense_pyramidal_lk_video(torch.from_numpy(clip[:5]), TCFG,
                                     port_cfg(dcfg))
    _assert_results_close(jr, tr, flow_max=0.05, flow_mean=5e-3,
                          eig_rel=5e-3, flips=1e-3)
    assert _gt_epe(tr.flow.numpy()) < 0.1


def test_per_pair_matches_lk_tpu(clip):
    """dense_pyramidal_lk on a 99x301 pair: the per-call path, which pads
    each level to its tile geometry, upsamples between levels (to 2n-1 at
    the odd sizes) and crops."""
    prv, nxt = clip[0, :99, :301], clip[1, :99, :301]
    jr = jd.dense_pyramidal_lk(jnp.asarray(prv), jnp.asarray(nxt), CFG,
                               dense_cfg=DCFG)
    tr = td.dense_pyramidal_lk(torch.from_numpy(prv.copy()),
                               torch.from_numpy(nxt.copy()), TCFG,
                               dense_cfg=TDCFG)
    _assert_results_close(jr, tr, flow_max=0.05, flow_mean=5e-3,
                          eig_rel=5e-3, flips=1e-3)


def test_multistream_is_per_stream(clip):
    frames = torch.from_numpy(np.stack([clip[:3], clip[3:6]]))
    ms = td.dense_pyramidal_lk_multistream(frames, TCFG, TDCFG)
    assert ms.flow.shape == (2, 2, 128, 1024, 2)
    for s in range(2):
        one = td.dense_pyramidal_lk_video(frames[s], TCFG, TDCFG)
        for a, b in zip(ms, one):
            assert torch.equal(a[s], b)


def test_levels_from_numpy_round_trip(clip):
    """lk_tpu's carried per-frame state (unified prepadded levels) strips to
    the port's unpadded levels, which its chain then runs on."""
    hw = clip.shape[1:]
    ecfg = jd._effective_cfg(CFG, DCFG, hw)
    base = jd.pyramid_base_geometry(*hw, ecfg, DCFG)
    plan_j = jd._video_level_plan(ecfg, DCFG, base, true_hw=hw)
    plan_t = td._video_level_plan(port_cfg(ecfg), TDCFG, base, true_hw=hw)
    padded = [np.asarray(x) for x in jd.build_frame_levels_prepadded(
        jnp.asarray(clip[0]), CFG, DCFG, plan_j)]
    ours = td.levels_from_numpy(padded, plan_t, device="cpu")
    ref = td.build_frame_levels(torch.from_numpy(clip[0]), TCFG, TDCFG)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        # lk_tpu's fast pyr_down is a matmul: f32 summation order only
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-3)
