"""The bf16 options of the dense level: lk_tpu_torch against lk_tpu on the
same numpy inputs (CPU; lk_tpu's Pallas makers in interpret mode).

* ``box_sum(sum_dtype=bfloat16)`` pads and adds in bf16, every add rounded
  to bf16.  lk_tpu's ``box_sum`` called op by op does the same: bit-equal.
  Under ``jax.jit`` XLA keeps the column pass's last add in f32 (excess
  precision); the port takes the literal rounding (ROADMAP.md Queue 3), so
  it is that one rounding away from the jitted result, at most 2**-8 of
  the sum.
* ``local_warp(window_dtype=bfloat16)``: next rounded once to bf16, the
  arithmetic f32; against ``pallas_local_warp(window_dtype=bfloat16)`` the
  f32 warp's bound (1e-4: the interpreted kernel runs under XLA, which may
  contract a product into an FMA), and bit-equal to the f32 warp of the
  rounded plane.
* Paths B (warp-only / precomputed-A) and C (the XLA level) with
  ``bf16_box_sums``, with and without ``bf16_warp_window``, against
  lk_tpu's ``dense_pyramidal_lk`` under the same config.  The A sums run
  op by op on both sides (min_eig 1e-5 relative, no gate flip); the b sums
  run inside lk_tpu's compiled iteration loop, whose kept f32 add and FMA
  contractions move some bf16 roundings (2**-8 of a sum each): flow 0.1 px
  max (measured 0.050 at 128x384) and 5e-3 px mean (measured 0.0027).
  The window alone changes nothing that rounds differently: the f32
  bounds of tests/test_torch_dense_paths.py, 1e-3 / 1e-5 px.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lk_tpu.flow.pallas_kernels as pk
from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow import dense as jd
from lk_tpu.ops.boxfilter import box_sum as j_box_sum
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.flow import warp_kernels as wk
from lk_tpu_torch.ops.boxfilter import box_sum
from torch_parity import AFFINE, affine_clip, interpret_pallas, port_cfg

CFG = LKConfig()
B = DenseLKConfig(use_pallas_warp=True, fused_grads_in_kernel=False)
PATHS = {
    "B16": (dataclasses.replace(B, bf16_box_sums=True,
                                bf16_warp_window=True), (128, 384)),
    "B_box16": (dataclasses.replace(B, bf16_box_sums=True), (128, 384)),
    "B_window16": (dataclasses.replace(B, bf16_warp_window=True),
                   (128, 384)),
    "C16": (DenseLKConfig(bf16_box_sums=True), (96, 160)),
}
BF16_SUMS = dict(flow_max=0.1, flow_mean=5e-3, eig_rel=1e-5, flips=1e-4)
F32 = dict(flow_max=1e-3, flow_mean=1e-5, eig_rel=1e-5, flips=1e-4)
ULP_REL = 2.0 ** -8      # one bf16 rounding, relative


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@pytest.fixture(scope="module")
def clip():
    return affine_clip(np.random.default_rng(1234), 128, 512, 2)


@pytest.mark.parametrize("border", ["zero", "edge", "reflect"])
@pytest.mark.parametrize("shape", [(40, 72), (2, 33, 47)])
def test_box_sum_bf16_per_add_rounding(rng, border, shape):
    """Bit-equal to lk_tpu's box_sum op by op; one rounding from its jitted
    result, and no further; f32 sums bit-equal too."""
    x = (rng.standard_normal(shape) * 40).astype(np.float32)
    win = (15, 13)
    got = box_sum(torch.from_numpy(x), win, border=border,
                  sum_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    eager = np.asarray(j_box_sum(jnp.asarray(x), win, border=border,
                                 sum_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), eager)
    jitted = np.asarray(jax.jit(lambda a: j_box_sum(
        a, win, border=border, sum_dtype=jnp.bfloat16))(jnp.asarray(x)))
    d = np.abs(got.numpy() - jitted)
    assert (d <= ULP_REL * np.abs(jitted)).all(), d.max()
    assert (d > 0).any()             # the jitted side does keep the add
    np.testing.assert_array_equal(
        box_sum(torch.from_numpy(x), win, border=border).numpy(),
        np.asarray(j_box_sum(jnp.asarray(x), win, border=border)))


def test_box_sum_output_dtype():
    """Cast back to the input's float dtype, f32 for integer input."""
    x = torch.arange(60, dtype=torch.int32).reshape(6, 10)
    assert box_sum(x, (3, 3)).dtype == torch.float32
    assert box_sum(x, (3, 3), sum_dtype=torch.bfloat16).dtype == torch.float32
    xb = x.to(torch.bfloat16)
    assert box_sum(xb, (3, 3)).dtype == torch.bfloat16
    np.testing.assert_array_equal(
        box_sum(x, (3, 3)).numpy(),
        np.asarray(j_box_sum(jnp.asarray(x.numpy()), (3, 3))))


def test_local_warp_bf16_matches_pallas(rng):
    """A zoom flow with outliers beyond +-local at 64x768 (tiles 64x384,
    local 4, max_disp 16)."""
    h, w = 64, 768
    img = (rng.random((h, w)) * 255).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([(xs - w / 2) * 0.02 + 1.5, (ys - h / 2) * 0.02 - 1.0],
                    -1).astype(np.float32)
    idx = rng.integers(0, h * w, 200)
    flow.reshape(-1, 2)[idx] += rng.uniform(-20, 20, (200, 2))
    kw = dict(max_disp=16, tile_h=64, tile_w=384, local=4)
    want = np.asarray(pk.pallas_local_warp(
        jnp.asarray(img), jnp.asarray(flow), window_dtype=jnp.bfloat16, **kw))
    planes = torch.from_numpy(flow).permute(2, 0, 1).contiguous()
    t_img = torch.from_numpy(img)
    got = wk.local_warp(t_img, planes, window_dtype=torch.bfloat16, **kw)
    assert np.abs(got.numpy() - want).max() <= 1e-4
    rounded = t_img.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(got, wk.local_warp(rounded, planes, **kw))
    assert torch.equal(got, wk.local_warp(t_img.to(torch.bfloat16), planes,
                                          window_dtype=torch.bfloat16, **kw))
    assert not torch.equal(got, wk.local_warp(t_img, planes, **kw))
    with pytest.raises(TypeError, match="window_dtype"):
        wk.local_warp(t_img, planes, window_dtype=torch.float16, **kw)


def _gt_epe(flow, margin=24):
    """Mean EPE against the exact affine flow, interior pixels."""
    h, w = flow.shape[-3:-1]
    ys, xs = np.mgrid[margin:h - margin, margin:w - margin].astype(np.float32)
    gx = AFFINE[0, 0] * xs + AFFINE[0, 1] * ys + AFFINE[0, 2] - xs
    gy = AFFINE[1, 0] * xs + AFFINE[1, 1] * ys + AFFINE[1, 2] - ys
    f = np.asarray(flow)[..., margin:h - margin, margin:w - margin, :]
    return float(np.hypot(f[..., 0] - gx, f[..., 1] - gy).mean())


@pytest.mark.parametrize("path", list(PATHS))
def test_bf16_paths_match_lk_tpu(clip, path):
    """B16 warps L0-L2 with the bf16 local warp and runs the precomputed
    level (bf16 A, f32 warp) at the top; C16 is the default config's level
    with bf16 sums."""
    dcfg, (h, w) = PATHS[path]
    prv, nxt = clip[0, :h, :w].copy(), clip[1, :h, :w].copy()
    jr = jd.dense_pyramidal_lk(jnp.asarray(prv), jnp.asarray(nxt), CFG,
                               dense_cfg=dcfg)
    wk.reset_counters()
    tr = td.dense_pyramidal_lk(torch.from_numpy(prv), torch.from_numpy(nxt),
                               port_cfg(CFG), dense_cfg=port_cfg(dcfg))
    if path.startswith("B"):
        assert wk.plain_calls == {"local_warp": 3,
                                  "fused_lk_level_precomputed": 1}
    tol = BF16_SUMS if dcfg.bf16_box_sums else F32
    fj, ft = np.asarray(jr.flow), tr.flow.numpy()
    assert fj.shape == ft.shape == (h, w, 2)
    same = np.asarray(jr.valid) == tr.valid.numpy()
    assert (~same).mean() <= tol["flips"], (~same).mean()
    d = np.abs(fj - ft)[same]
    assert d.max() < tol["flow_max"], d.max()
    assert d.mean() < tol["flow_mean"], d.mean()
    me_j, me_t = np.asarray(jr.min_eig), tr.min_eig.numpy()
    rel = np.abs(me_j - me_t).max() / np.abs(me_j).max()
    assert rel < tol["eig_rel"], rel
    assert _gt_epe(ft) < 0.1


def test_bf16_options_change_the_flow(clip):
    """Each option reaches the level: the flow differs from the f32 path's
    (the grads-fused level, which ignores both, does not change)."""
    prv, nxt = (torch.from_numpy(clip[i, :96, :160].copy()) for i in (0, 1))
    tcfg = port_cfg(CFG)

    def flow(dcfg):
        return td.dense_pyramidal_lk(prv, nxt, tcfg,
                                     dense_cfg=port_cfg(dcfg)).flow

    for base in (B, DenseLKConfig()):
        f32 = flow(base)
        assert not torch.equal(flow(dataclasses.replace(
            base, bf16_box_sums=True)), f32)
    assert not torch.equal(flow(dataclasses.replace(
        B, bf16_warp_window=True)), flow(B))
    fused = DenseLKConfig(use_pallas_fused=True)
    assert torch.equal(flow(dataclasses.replace(
        fused, bf16_box_sums=True, bf16_warp_window=True)), flow(fused))
