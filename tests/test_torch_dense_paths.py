"""The per-pair dense paths: lk_tpu_torch against lk_tpu on the same numpy
frames (CPU; lk_tpu's Pallas makers in interpret mode).

* Path A, ``__graft_entry__.entry()``'s config
  (``use_pallas_warp=True, pallas_pyramid=True``): the base pre-padded to
  ``pyramid_base_geometry`` (82x512 -> 96x512 here), the pyramid from
  lk_tpu's pyrDown pair kernel, the grads-fused level everywhere.  lk_tpu
  rounds the pyrDown column pass, the box sums and (``scharr_mxu``) the
  Scharr data to bf16; the port is exact f32.  As lk_tpu runs: flow <= 0.05
  px max and 5e-3 mean where both gates agree (test_torch_dense.py's bf16
  bound), min_eig 2e-2 relative (the bf16 Scharr, as
  tests/test_pallas_warp.py bounds it); with the bf16 casts mapped to f32,
  1e-3 / 1e-5 px.
* Path B, the warp-only / precomputed-A config
  (``use_pallas_warp=True, fused_grads_in_kernel=False``), and its
  ``use_pallas_fused`` form (the precomputed level at every level); path C,
  the default config's XLA level.  No bf16 on either side: lk_tpu's pyramid
  matmul and jitted iteration loop differ from the port in summation order
  and FMA contraction only, so 1e-3 / 1e-5 px, min_eig 1e-5 relative,
  flips 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lk_tpu.flow.pallas_kernels as pk
from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow import dense as jd
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.flow import lk_kernels, warp_kernels
from lk_tpu_torch.ops import blur
from torch_parity import (AFFINE, affine_clip, f32_jnp, interpret_pallas,
                          port_cfg)

CFG = LKConfig()
PATHS = {
    "A": DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True),
    "B": DenseLKConfig(use_pallas_warp=True, fused_grads_in_kernel=False),
    "B_fused": DenseLKConfig(use_pallas_fused=True,
                             fused_grads_in_kernel=False),
    "C": DenseLKConfig(),
}
BF16 = dict(flow_max=0.05, flow_mean=5e-3, eig_rel=2e-2, flips=1e-3)
F32 = dict(flow_max=1e-3, flow_mean=1e-5, eig_rel=1e-5, flips=1e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@pytest.fixture(scope="module")
def clip():
    return affine_clip(np.random.default_rng(1234), 128, 512, 5)


def _gt_epe(flow, margin=24):
    """Mean EPE against the exact affine flow, interior pixels."""
    h, w = flow.shape[-3:-1]
    ys, xs = np.mgrid[margin:h - margin, margin:w - margin].astype(np.float32)
    gx = AFFINE[0, 0] * xs + AFFINE[0, 1] * ys + AFFINE[0, 2] - xs
    gy = AFFINE[1, 0] * xs + AFFINE[1, 1] * ys + AFFINE[1, 2] - ys
    f = np.asarray(flow)[..., margin:h - margin, margin:w - margin, :]
    return float(np.hypot(f[..., 0] - gx, f[..., 1] - gy).mean())


def _assert_close(jr, tr, flow_max, flow_mean, eig_rel, flips):
    """Flow compared where both sides agree on the gate (a pixel whose
    min_eig sits on the threshold may pass on one side only)."""
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


def _pair(clip, h, w):
    return clip[0, :h, :w].copy(), clip[1, :h, :w].copy()


def _both(prv, nxt, dcfg):
    jr = jd.dense_pyramidal_lk(jnp.asarray(prv), jnp.asarray(nxt), CFG,
                               dense_cfg=dcfg)
    tr = td.dense_pyramidal_lk(torch.from_numpy(prv), torch.from_numpy(nxt),
                               port_cfg(CFG), dense_cfg=port_cfg(dcfg))
    return jr, tr


def test_xla_level_matches_lk_tpu(clip):
    """dense_lk_level, default config (shift-select warp, zero-border box
    sums, eps freeze), 96x160, 6 iterations, max_disp 8."""
    prv, nxt = _pair(clip, 96, 160)
    f0 = np.zeros((96, 160, 2), np.float32)
    jr = jd.dense_lk_level(jnp.asarray(prv), jnp.asarray(nxt),
                           jnp.asarray(f0), CFG, DenseLKConfig(), max_disp=8)
    tr = td.dense_lk_level(torch.from_numpy(prv), torch.from_numpy(nxt),
                           torch.from_numpy(f0), port_cfg(CFG),
                           port_cfg(DenseLKConfig()), max_disp=8)
    _assert_close(jr, tr, **F32)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_path_a_matches_lk_tpu(clip, precision, monkeypatch):
    """entry()'s program at 82x512: the base pads to 96x512 (the 1080p
    program's 1080 -> 1088 in small)."""
    prv, nxt = _pair(clip, 82, 512)
    dcfg = PATHS["A"]
    assert td.pyramid_base_geometry(82, 512, port_cfg(CFG),
                                    port_cfg(dcfg)) == (96, 512)
    if precision == "f32":
        monkeypatch.setattr(pk, "jnp", f32_jnp())
    jr, tr = _both(prv, nxt, dcfg)
    _assert_close(jr, tr, **(BF16 if precision == "bf16" else F32))
    assert tr.flow.shape == (82, 512, 2)
    assert _gt_epe(tr.flow.numpy()) < 0.1


@pytest.mark.parametrize("path", ["B", "B_fused"])
def test_path_b_matches_lk_tpu(clip, path):
    """128x384, 4 levels: B warps L0-L2 with the local warp (tiles 64x384,
    64x192, 64x96 on a 64-row pad) and runs the precomputed level at the
    16x48 top (6 iterations, right-halo refresh live); B_fused runs the
    precomputed level at every level."""
    jr, tr = _both(*_pair(clip, 128, 384), PATHS[path])
    _assert_close(jr, tr, **F32)
    assert _gt_epe(tr.flow.numpy()) < 0.1


@pytest.mark.parametrize("hw", [(96, 160), (99, 301)])
def test_path_c_matches_lk_tpu(clip, hw):
    """The default config: unpadded levels, shift-select warp with
    level_disp bounds; 99x301 clamps to 3 levels and upsamples to odd
    sizes."""
    jr, tr = _both(*_pair(clip, *hw), PATHS["C"])
    _assert_close(jr, tr, **F32)


@pytest.mark.parametrize("path", ["C", "A"])
def test_batched_matches_lk_tpu(clip, path, monkeypatch):
    """dense_pyramidal_lk_batched, B=2 pairs of 64x128 (different crops),
    row-folded with guard bands; A with lk_tpu's bf16 casts mapped to f32."""
    monkeypatch.setattr(pk, "jnp", f32_jnp())
    prv = np.stack([clip[0, :64, :128], clip[1, 30:94, 200:328]])
    nxt = np.stack([clip[1, :64, :128], clip[2, 30:94, 200:328]])
    dcfg = PATHS[path]
    fj = np.asarray(jd.dense_pyramidal_lk_batched(
        jnp.asarray(prv), jnp.asarray(nxt), CFG, dcfg))
    ft = td.dense_pyramidal_lk_batched(
        torch.from_numpy(prv), torch.from_numpy(nxt), port_cfg(CFG),
        port_cfg(dcfg)).numpy()
    assert ft.shape == fj.shape == (2, 64, 128, 2)
    d = np.abs(fj - ft)
    assert d.max() < F32["flow_max"] and d.mean() < F32["flow_mean"]


def test_default_video_is_per_pair(clip):
    """The default-config video (per-frame chain, each frame's pyramid
    built once) equals per-pair dense_pyramidal_lk calls bit for bit."""
    frames = torch.from_numpy(clip[:3, :96, :160].copy())
    tcfg, dcfg = port_cfg(CFG), port_cfg(PATHS["C"])
    video = td.dense_pyramidal_lk_video(frames, tcfg, dcfg)
    for t in range(2):
        one = td.dense_pyramidal_lk(frames[t], frames[t + 1], tcfg,
                                    dense_cfg=dcfg)
        for a, b in zip(video, one):
            assert torch.equal(a[t], b)


def test_path_a_per_pair_is_video_pair(clip):
    """Path A per pair (per-call chain, pair-stacked pyramid) equals the
    chunked video chain's pairs bit for bit; the pair's pyramid (pad and
    both decimations) is one build_pyramid call, and only the plain
    versions run."""
    frames = torch.from_numpy(clip[:5, :82, :512].copy())
    tcfg, dcfg = port_cfg(CFG), port_cfg(PATHS["A"])
    video = td.dense_pyramidal_lk_video(frames, tcfg, dcfg)
    for mod in (blur, lk_kernels, warp_kernels):
        mod.reset_counters()
    one = td.dense_pyramidal_lk(frames[0], frames[1], tcfg, dense_cfg=dcfg)
    assert blur.plain_calls == 1         # one pyramid: pad + 2 levels
    assert lk_kernels.plain_calls == 3
    assert sum(warp_kernels.plain_calls.values()) == 0
    for a, b in zip(video, one):
        assert torch.equal(a[0], b)


def test_path_b_counts(clip):
    """Path B's kernels per pair at 4 levels: the local warp once at each of
    L0-L2, the precomputed level once (6 iterations) at the top, the
    pair's pyramid once."""
    tcfg, dcfg = port_cfg(CFG), port_cfg(PATHS["B"])
    prv, nxt = map(torch.from_numpy, _pair(clip, 128, 384))
    for mod in (blur, lk_kernels, warp_kernels):
        mod.reset_counters()
    td.dense_pyramidal_lk(prv, nxt, tcfg, dense_cfg=dcfg)
    assert warp_kernels.plain_calls == {"local_warp": 3,
                                        "fused_lk_level_precomputed": 1}
    assert lk_kernels.plain_calls == 0
    assert blur.plain_calls == 1
