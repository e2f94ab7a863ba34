"""The fused LK level: the port against lk_tpu's four grads-in-kernel Pallas
makers (TPU kernels #1-#4), run in interpret mode on the same numpy inputs.

Each case runs twice:

* ``bf16`` — the makers as they are.  They round the box-sum data and the
  coarse-flow upsample data to bf16 for the MXU band matmuls
  (pallas_kernels.py:573-575, 665); the port is exact f32.  That rounding
  is the whole tolerance: <= 0.05 px max, 5e-3 px mean.
* ``f32`` — the same makers with their bf16 casts mapped to f32 (only in
  this test).  Then the two sides differ by f32 summation order alone, and
  any semantic slip — a tile seam warped with the neighbour's reference, a
  halo reading the current flow outside the level — shows as a 1e-1 px
  error against a 1e-4 px bound.

Interior and border bands (and tile seams) are checked separately: a
mismatch confined to them is a border/seam bug, not rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lk_tpu.flow.pallas_kernels as pk
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.flow import lk_kernels as lk
from torch_parity import affine_clip, f32_jnp, interpret_pallas

THR = 1e-4   # LKConfig.min_eig_threshold

TOL = {
    # bf16 rounding of the TPU kernels' box-sum and upsample data
    "bf16": dict(flow_max=0.05, flow_mean=5e-3, eig_rel=5e-3, flips=1e-3),
    # f32 on both sides: summation order only
    "f32": dict(flow_max=1e-4, flow_mean=1e-5, eig_rel=1e-5, flips=1e-4),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@pytest.fixture(params=["bf16", "f32"])
def precision(request, monkeypatch):
    if request.param == "f32":
        monkeypatch.setattr(pk, "jnp", f32_jnp())
    return request.param


def _unified(frames, th, tw, disp, local):
    """lk_tpu's unified prepadded layout of a (N, h, w) stack, and the
    port's unpadded stack recovered from it by levels_from_numpy."""
    pt, pb, pl_, pr = pk.unified_pad_geometry(th, tw, disp, local)
    padded = np.pad(frames, ((0, 0), (pt, pb), (pl_, pr)), mode="edge")
    h, w = frames.shape[1:]
    p = td._LevelPlan(h, w, th, tw, (th, tw) == (h, w), 1, local, disp)
    (ours,) = td.levels_from_numpy([padded], (p,), device="cpu")
    assert torch.equal(ours, torch.from_numpy(frames))
    return padded, ours


def _assert_close(precision, fj, ft, me_j=None, me_t=None, va_j=None,
                  va_t=None, seams=()):
    """fj/ft: (..., 2, h, w) flow planes; seams: (axis, index) tile edges."""
    tol = TOL[precision]
    d = np.abs(np.asarray(fj) - np.asarray(ft))
    h, w = d.shape[-2:]
    border = np.ones((h, w), bool)
    border[8:-8, 8:-8] = False
    bands = {"interior": ~border, "border": border}
    for axis, at in seams:
        band = np.zeros((h, w), bool)
        if axis == 0:
            band[max(at - 8, 0):at + 8] = True
        else:
            band[:, max(at - 8, 0):at + 8] = True
        bands[f"seam {axis}@{at}"] = band
    for name, band in bands.items():
        worst = d[..., band].max()
        assert worst < tol["flow_max"], (name, worst)
    assert d.mean() < tol["flow_mean"], d.mean()
    if me_j is not None:
        me_j, me_t = np.asarray(me_j), np.asarray(me_t)
        rel = np.abs(me_j - me_t).max() / np.abs(me_j).max()
        assert rel < tol["eig_rel"], rel
        flips = (np.asarray(va_j) != np.asarray(va_t)).mean()
        assert flips <= tol["flips"], flips


@pytest.mark.parametrize("seeded", [False, True])
def test_resident_matches_maker(rng, precision, seeded):
    """#3 make_fused_lk_level_grads_resident: one 64x384 tile, 3 IC
    iterations, zero and non-zero seed."""
    h, w, disp, local = 64, 384, 6, 4
    prv, nxt = affine_clip(rng, h, w, 2)
    seed = np.zeros((h, w, 2), np.float32)
    if seeded:
        seed += (rng.random((h, w, 2)).astype(np.float32) - 0.5) * 2.0
        seed += np.float32([1.0, -0.5])
    run = pk.make_fused_lk_level_grads_resident(
        jnp.asarray(nxt), jnp.asarray(prv), n_iters=3, min_eig_threshold=THR,
        max_disp=disp, local=local, planes_out=True, scharr_mxu=False)
    fj, mj, vj = run(jnp.asarray(seed))
    ft, mt, vt = lk.fused_lk_level(
        torch.from_numpy(prv)[None], torch.from_numpy(nxt)[None],
        torch.from_numpy(seed).permute(2, 0, 1)[None].contiguous(),
        tile_h=h, tile_w=w, max_disp=disp, local=local, n_iters=3,
        min_eig_threshold=THR)
    _assert_close(precision, fj, ft[0], mj, mt[0], vj, vt[0])


@pytest.mark.parametrize("write_stats", [True, False])
def test_tiled_coarse_matches_maker(rng, precision, write_stats):
    """#4 make_fused_lk_level_grads, prepadded coarse-in: 128x512 level on
    64x256 tiles, disp 6, local 4 (tests/test_pallas_warp.py's setup)."""
    h, w, th, tw, disp, local = 128, 512, 64, 256, 6, 4
    frames = affine_clip(rng, h, w, 2)
    coarse = ((rng.random((2, h // 2, w // 2)) - 0.5) * 2.0).astype(
        np.float32)
    padded, ours = _unified(frames, th, tw, disp, local)
    run = pk.make_fused_lk_level_grads(
        jnp.asarray(padded[1]), jnp.asarray(padded[0]), n_iters=1,
        min_eig_threshold=THR, max_disp=disp, tile_h=th, tile_w=tw,
        local=local, coarse_flow=True, planes_out=True, prepadded=True,
        write_stats=write_stats, scharr_mxu=False)
    fj, mj, vj = run(jnp.asarray(coarse))
    ft, mt, vt = lk.fused_lk_level(
        ours[:1], ours[1:], torch.from_numpy(coarse)[None], tile_h=th,
        tile_w=tw, max_disp=disp, local=local, coarse_in=True,
        write_stats=write_stats, min_eig_threshold=THR)
    assert (mj is None) == (mt is None) == (not write_stats)
    _assert_close(precision, fj, ft[0],
                  *((mj, mt[0], vj, vt[0]) if write_stats else ()),
                  seams=((0, th), (1, tw)))


def test_tiled_iterations_match_maker(rng, precision):
    """#4 make_fused_lk_level_grads, full-resolution flow, 2 Jacobi
    iterations over 2x2 tiles (the ping-pong form): the halo reads the
    neighbours' previous-iteration flow inside the level and the initial
    flow outside it."""
    h, w, th, tw, disp, local = 128, 512, 64, 256, 6, 4
    prv, nxt = affine_clip(rng, h, w, 2)
    init = ((rng.random((h, w, 2)) - 0.5) * 3.0).astype(np.float32)
    run = pk.make_fused_lk_level_grads(
        jnp.asarray(nxt), jnp.asarray(prv), n_iters=2, min_eig_threshold=THR,
        max_disp=disp, tile_h=th, tile_w=tw, local=local, planes_out=True,
        scharr_mxu=False)
    fj, mj, vj = run(jnp.asarray(init))
    ft, mt, vt = lk.fused_lk_level(
        torch.from_numpy(prv)[None], torch.from_numpy(nxt)[None],
        torch.from_numpy(init).permute(2, 0, 1)[None].contiguous(),
        tile_h=th, tile_w=tw, max_disp=disp, local=local, n_iters=2,
        min_eig_threshold=THR)
    _assert_close(precision, fj, ft[0], mj, mt[0], vj, vt[0],
                  seams=((0, th), (1, tw)))


def test_tiled_iterations_right_halo(rng, precision, monkeypatch):
    """The side the port takes (flow/lk_kernels.py docstring, ROADMAP
    Queue 3; pallas_kernels.py:535-548, 935-941): at n_iters > 1 with
    tile_w % 128 != 0 the ping-pong kernel writes 128-aligned widths, so
    the last tile column's right halo picks up the current flow's edge.
    The port reproduces it: equal to the maker everywhere, the right band
    included.  Keeping the initial flow there instead (``right_spill`` 0)
    would differ by far more than rounding in the rightmost 2 * HALO
    columns."""
    from lk_tpu_torch.flow import warp_kernels as wk

    h, w, th, tw, disp, local = 128, 384, 64, 192, 6, 4
    band = 2 * lk.HALO
    prv, nxt = affine_clip(rng, h, w, 2)
    init = ((rng.random((h, w, 2)) - 0.5) * 3.0).astype(np.float32)
    run = pk.make_fused_lk_level_grads(
        jnp.asarray(nxt), jnp.asarray(prv), n_iters=2, min_eig_threshold=THR,
        max_disp=disp, tile_h=th, tile_w=tw, local=local, planes_out=True,
        scharr_mxu=False)
    fj, mj, vj = run(jnp.asarray(init))

    def port():
        return lk.fused_lk_level(
            torch.from_numpy(prv)[None], torch.from_numpy(nxt)[None],
            torch.from_numpy(init).permute(2, 0, 1)[None].contiguous(),
            tile_h=th, tile_w=tw, max_disp=disp, local=local, n_iters=2,
            min_eig_threshold=THR)

    ft, mt, vt = port()
    _assert_close(precision, fj, ft[0], mj, mt[0], vj, vt[0],
                  seams=((0, th), (1, tw), (1, w - band)))
    monkeypatch.setattr(wk, "right_spill", lambda tile_w: 0)
    kept = port()[0][0].numpy()
    fj = np.asarray(fj)
    assert np.abs(fj[..., w - band:] - kept[..., w - band:]).max() > 0.1


def test_single_tile_tiled_level_matches_maker(rng, precision):
    """#4 make_fused_lk_level_grads on one 64x240 tile, 2 iterations (the
    tiled kernel where the resident one would fit, as dense.py picks it
    under fused_resident_max_h): ``resident=False`` takes the tiled
    kernel's right-halo refresh (8 columns at 240), equal to the maker
    everywhere."""
    h, w, disp, local = 64, 240, 6, 4
    prv, nxt = affine_clip(rng, h, w, 2)
    init = ((rng.random((h, w, 2)) - 0.5) * 3.0).astype(np.float32)
    run = pk.make_fused_lk_level_grads(
        jnp.asarray(nxt), jnp.asarray(prv), n_iters=2, min_eig_threshold=THR,
        max_disp=disp, tile_h=h, tile_w=w, local=local, planes_out=True,
        scharr_mxu=False)
    fj, mj, vj = run(jnp.asarray(init))
    ft, mt, vt = lk.fused_lk_level(
        torch.from_numpy(prv)[None], torch.from_numpy(nxt)[None],
        torch.from_numpy(init).permute(2, 0, 1)[None].contiguous(),
        tile_h=h, tile_w=w, max_disp=disp, local=local, n_iters=2,
        min_eig_threshold=THR, resident=False)
    _assert_close(precision, fj, ft[0], mj, mt[0], vj, vt[0],
                  seams=((1, w - 2 * lk.HALO),))


def test_batched_resident_matches_maker(rng, precision):
    """#1 make_fused_lk_level_grads_resident_batched: K=3 cold pairs of a
    64x384 top level, 3 iterations."""
    h, w, disp, local = 64, 384, 6, 4
    padded, ours = _unified(affine_clip(rng, h, w, 4), h, w, disp, local)
    run = pk.make_fused_lk_level_grads_resident_batched(
        jnp.asarray(padded), (h, w), n_iters=3, min_eig_threshold=THR,
        max_disp=disp, local=local, scharr_mxu=False)
    fj, mj, vj = run(None)
    ft, mt, vt = lk.fused_lk_level(
        ours[:-1], ours[1:], torch.zeros((3, 2, h, w)), tile_h=h, tile_w=w,
        max_disp=disp, local=local, n_iters=3, min_eig_threshold=THR)
    _assert_close(precision, fj, ft, mj, mt, vj, vt)


def test_batched_coarse_matches_maker(rng, precision):
    """#2 make_fused_lk_level_grads_batched: K=3 pairs of a 128x512
    coarse-in level on 64x256 tiles, with stats."""
    h, w, th, tw, disp, local = 128, 512, 64, 256, 6, 4
    padded, ours = _unified(affine_clip(rng, h, w, 4), th, tw, disp, local)
    coarse = ((rng.random((3, 2, h // 2, w // 2)) - 0.5) * 2.0).astype(
        np.float32)
    run = pk.make_fused_lk_level_grads_batched(
        jnp.asarray(padded), (h, w), min_eig_threshold=THR, max_disp=disp,
        tile_h=th, tile_w=tw, local=local, scharr_mxu=False)
    fj, mj, vj = run(jnp.asarray(coarse))
    ft, mt, vt = lk.fused_lk_level(
        ours[:-1], ours[1:], torch.from_numpy(coarse), tile_h=th, tile_w=tw,
        max_disp=disp, local=local, coarse_in=True, min_eig_threshold=THR)
    _assert_close(precision, fj, ft, mj, mt, vj, vt,
                  seams=((0, th), (1, tw)))


@pytest.mark.parametrize("coarse_in", [False, True])
def test_pairs_independent_of_k(rng, coarse_in):
    """Per pair, the K-pair call equals the single-pair call bit for bit
    (what makes the chunked video equal the per-frame chain)."""
    h, w, th, tw = 64, 512, 32, 256
    frames = torch.from_numpy(affine_clip(rng, h, w, 4))
    if coarse_in:
        flow = torch.from_numpy(((rng.random((3, 2, h // 2, w // 2)) - 0.5)
                                 * 2.0).astype(np.float32))
        kw = dict(tile_h=th, tile_w=tw, coarse_in=True)
    else:
        flow = torch.from_numpy(((rng.random((3, 2, h, w)) - 0.5) * 2.0)
                                .astype(np.float32))
        kw = dict(tile_h=h, tile_w=w, n_iters=2)
    chunk = lk.fused_lk_level(frames[:-1], frames[1:], flow, max_disp=8,
                              local=5, **kw)
    for f in range(3):
        one = lk.fused_lk_level(frames[f:f + 1], frames[f + 1:f + 2],
                                flow[f:f + 1], max_disp=8, local=5, **kw)
        for a, b in zip(chunk, one):
            assert torch.equal(a[f], b[0])


def test_cpu_inputs_take_the_plain_version(rng):
    """CPU tensors go to the plain version, and only they: the counters
    show it, and an unsupported device raises instead of falling back."""
    frames = torch.from_numpy(affine_clip(rng, 32, 64, 2))
    lk.reset_counters()
    lk.fused_lk_level(frames[:1], frames[1:], torch.zeros(1, 2, 32, 64),
                      tile_h=32, tile_w=64, max_disp=4, local=3, n_iters=2)
    assert lk.plain_calls == 1
    assert sum(lk.kernel_launches_by_variant.values()) == 0
    meta = torch.empty((1, 32, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lk.fused_lk_level(meta, meta, torch.empty((1, 2, 32, 64),
                                                  device="meta"),
                          tile_h=32, tile_w=64, max_disp=4, local=3)
    assert lk.plain_calls == 1
