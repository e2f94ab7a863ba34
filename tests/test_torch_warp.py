"""The warps and the precomputed-A level: lk_tpu_torch against lk_tpu on the
same numpy inputs (CPU; lk_tpu's Pallas makers in interpret mode, as
tests/test_pallas_warp.py runs them).

* ``ops.warp`` against ``lk_tpu.ops.warp``, op by op: bit-equal (the
  separable warp's one non-zero select term is the two-gather lerp).
* The plain ``local_warp`` against ``pallas_local_warp`` and the plain
  precomputed level against ``make_fused_lk_level``: both sides f32 with the
  same operations; the interpreted Pallas kernel runs under XLA, which may
  contract a product into an FMA, so the bound is 1e-4 (measured ~3e-5).
"""

import ctypes
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lk_tpu.flow.pallas_kernels as pk
from lk_tpu.ops import warp as jw
from lk_tpu.ops.boxfilter import box_sum
from lk_tpu.ops.gradients import scharr_derivatives
from lk_tpu_torch.flow import warp_kernels as wk
from lk_tpu_torch.ops import warp as tw
from torch_parity import affine_clip, interpret_pallas

TOL = 1e-4    # interpreted Pallas (XLA may contract FMAs) vs plain f32


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _planes(flow_hw2):
    return _t(flow_hw2).permute(2, 0, 1).contiguous()


@pytest.mark.parametrize("r", [1, 4, 32])
def test_shift_select_warp_bit_equal(rng, r):
    """Random flow up to +-6 px, clamped at +-r, edges included."""
    h, w = 40, 72
    img = (rng.random((h, w)) * 255).astype(np.float32)
    flow = ((rng.random((h, w, 2)) - 0.5) * 12).astype(np.float32)
    want = np.asarray(jw.shift_select_warp(jnp.asarray(img),
                                           jnp.asarray(flow), (r, r)))
    got = tw.shift_select_warp(_t(img), _t(flow), (r, r)).numpy()
    np.testing.assert_array_equal(got, want)


def test_warp_by_flow_and_bilinear_sample_bit_equal(rng):
    h, w = 40, 72
    img = (rng.random((h, w)) * 255).astype(np.float32)
    flow = ((rng.random((h, w, 2)) - 0.5) * 30).astype(np.float32)
    np.testing.assert_array_equal(
        tw.warp_by_flow(_t(img), _t(flow)).numpy(),
        np.asarray(jw.warp_by_flow(jnp.asarray(img), jnp.asarray(flow))))
    x = ((rng.random(57) - 0.2) * w * 1.4).astype(np.float32)
    y = ((rng.random(57) - 0.2) * h * 1.4).astype(np.float32)
    np.testing.assert_array_equal(
        tw.bilinear_sample(_t(img), _t(x), _t(y)).numpy(),
        np.asarray(jw.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                      jnp.asarray(y))))


def _local_warp_pair(img, flow, **kw):
    want = np.asarray(pk.pallas_local_warp(jnp.asarray(img),
                                           jnp.asarray(flow), **kw))
    kw.setdefault("max_disp", 32)
    kw.setdefault("tile_h", pk.TILE_H)
    kw.setdefault("tile_w", pk.TILE_W)
    kw.setdefault("local", pk.LOCAL)
    got = wk.local_warp(_t(img), _planes(flow), **kw).numpy()
    return want, got


@pytest.mark.parametrize(
    "shift", [(0.0, 0.0), (2.5, -1.5), (31.0, 14.0), (-20.5, 9.25)])
def test_local_warp_constant_flow(rng, shift):
    """tests/test_pallas_warp.py's constant shifts at 64x768 (tiles
    64x384, local 6, max_disp 32)."""
    h, w = 64, 768
    img = (rng.random((h, w)) * 255).astype(np.float32)
    flow = np.broadcast_to(np.float32(shift), (h, w, 2)).copy()
    want, got = _local_warp_pair(img, flow)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("local,max_disp", [(6, 32), (3, 32), (4, 16),
                                            (5, 8)])
def test_local_warp_smooth_zoom(rng, local, max_disp):
    """A zoom whose flow varies across a tile by more than the residual
    range: the per-tile reference and the +-local clamp decide pixels.
    The Pallas kernel's defaults, then path B's local and max_disp of its
    levels 0, 1 and 2."""
    h, w = 64, 768
    img = (rng.random((h, w)) * 255).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([(xs - w / 2) * 0.02 + 3.0, (ys - h / 2) * 0.02 - 2.0],
                    -1).astype(np.float32)
    want, got = _local_warp_pair(img, flow, local=local, max_disp=max_disp)
    assert np.abs(got - want).max() <= TOL


def test_local_warp_residual_clamp(rng):
    """test_pallas_warp.py's 16x384 outlier: clamped to the local range,
    identical on both sides."""
    h, w = 16, 384
    img = np.tile(np.arange(w, dtype=np.float32), (h, 1))
    flow = np.zeros((h, w, 2), np.float32)
    flow[0, 0, 0] = 20.0
    want, got = _local_warp_pair(img, flow, tile_h=16)
    assert np.abs(got - want).max() <= TOL
    assert got[0, 0] <= 17.0


@pytest.mark.parametrize("local", [0, 4, 8])
def test_local_warp_launch_arguments(rng, monkeypatch, local):
    """The kernel's path of local_warp, with a stand-in launcher on the
    CPU that writes the plain result where the kernel would: the C
    launcher's arguments in order, one launch per call; a local out of
    range is refused before any launch."""
    from lk_tpu_torch import _build

    h, w, th, tw_ = 64, 96, 32, 48
    img = _t(rng.random((h, w)) * 255)
    flow = _t((rng.random((2, h, w)) - 0.5) * 12)
    kw = dict(max_disp=6, tile_h=th, tile_w=tw_)
    want = wk.local_warp_reference(img, flow, local=local, **kw)
    launches = []

    def launch(fn, t, name, *a):
        launches.append((fn, t, name, a))
        ctypes.memmove(a[3], want.data_ptr(), want.numel() * 4)

    monkeypatch.setattr(wk, "_dispatch", lambda t, name: True)
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        lk_local_warp_launch="warp"))
    monkeypatch.setattr(_build, "launch", launch)
    wk.reset_counters()
    out = wk.local_warp(img, flow, local=local, **kw)
    assert wk.kernel_launches["local_warp"] == 1
    assert sum(wk.plain_calls.values()) == 0
    (fn, t, name, a), = launches
    assert (fn, name) == ("warp", "local_warp")
    assert t is img
    assert a == (img.data_ptr(), flow.data_ptr(),
                 flow.data_ptr() + h * w * 4, out.data_ptr(), h, w, th, tw_,
                 local, 6.0)
    assert torch.equal(out, want)
    for bad in (-1, wk.MAX_LOCAL + 1):
        with pytest.raises(ValueError):
            wk.local_warp(img, flow, local=bad, **kw)
    assert len(launches) == 1
    assert wk.kernel_launches["local_warp"] == 1


def _precomputed_inputs(rng, h, w):
    """A blurred affine pair, a noisy initial flow, and lk_tpu's prologue
    (Scharr, A with edge borders, gate, inv_det) computed op by op."""
    prv, nxt = affine_clip(rng, h, w, 2)
    init = ((rng.random((h, w, 2)) - 0.5) * 3.0).astype(np.float32)
    ix, iy = scharr_derivatives(jnp.asarray(prv))
    win = (15, 15)
    a11 = box_sum(ix * ix, win, border="edge")
    a12 = box_sum(ix * iy, win, border="edge")
    a22 = box_sum(iy * iy, win, border="edge")
    det = a11 * a22 - a12 * a12
    me = (a22 + a11 - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) / 450.0
    inv_det = jnp.where((me >= 0.1024) & (det > 1e-7), 1.0 / det, 0.0)
    return prv, nxt, init, (ix, iy, a11, a12, a22, inv_det)


def _precomputed_pair(rng, h, w, th, tw_, n_iters, disp=6, local=4):
    prv, nxt, init, pro = _precomputed_inputs(rng, h, w)
    run = pk.make_fused_lk_level(jnp.asarray(nxt), jnp.asarray(prv), *pro,
                                 n_iters=n_iters, max_disp=disp, tile_h=th,
                                 tile_w=tw_, local=local)
    want = np.asarray(run(jnp.asarray(init)))

    def port():
        return wk.fused_lk_level_precomputed(
            _t(nxt), _t(prv), *map(_t, pro), _planes(init), n_iters=n_iters,
            max_disp=disp, tile_h=th, tile_w=tw_, local=local
        ).permute(1, 2, 0).numpy()

    return want, port


@pytest.mark.parametrize("n_iters", [1, 2])
def test_precomputed_level_matches_maker(rng, n_iters):
    """128x384 on 64x192 tiles (2x2, seams in both axes), 1 and 2 Jacobi
    iterations; tile_w % 128 != 0, so the right-halo refresh is live."""
    want, port = _precomputed_pair(rng, 128, 384, 64, 192, n_iters)
    got = port()
    assert np.abs(got - want).max() <= TOL


def test_precomputed_level_right_halo(rng, monkeypatch):
    """The side the port takes (flow/warp_kernels.py docstring, ROADMAP
    Queue 3): at the 1080p precomputed-A top-level form — one 136x240 tile,
    6 iterations — the TPU kernel's 128-aligned writes refresh the first 8
    columns right of the level with the current flow's edge.  The port
    reproduces it: equal to the maker everywhere.  Keeping the initial flow
    there instead would differ by far more than rounding in the rightmost
    2 * HALO columns (and, over 6 iterations, further in)."""
    want, port = _precomputed_pair(rng, 136, 240, 136, 240, 6)
    got = port()
    assert np.abs(got - want).max() <= TOL
    monkeypatch.setattr(wk, "right_spill", lambda tile_w: 0)
    kept = port()
    band = 2 * wk.HALO
    assert np.abs(kept[:, -band:] - want[:, -band:]).max() > 0.1


def test_right_spill_geometry():
    """The refreshed columns: what the 128-aligned write overruns, capped
    at the 8-column halo."""
    cases = {240: 8, 384: 0, 480: 8, 48: 8, 250: 6, 512: 0, 124: 4}
    for tile_w, spill in cases.items():
        assert wk.right_spill(tile_w) == spill, tile_w


@pytest.mark.parametrize("n_iters", [1, 2, 3, 6])
def test_precomputed_launch_arguments(rng, monkeypatch, n_iters):
    """The kernel's wrapper, with a stand-in launcher on the CPU that
    writes each iteration's plain result where the kernel would: one
    launch per call for any n_iters; the initial flow read only, as a
    third buffer; both ping-pong buffers distinct (the second absent at
    one iteration); the later iterations' right-halo spill; the buffer of
    the last iteration returned."""
    from lk_tpu_torch import _build

    h, w, th, tw_ = 32, 120, 16, 120
    prv, nxt, init, pro = _precomputed_inputs(rng, h, w)
    args = (_t(nxt), _t(prv), *map(_t, pro), _planes(init))
    kw = dict(max_disp=6, tile_h=th, tile_w=tw_, local=4, win_k=15)
    launches = []

    def launch(fn, t, name, *a):
        launches.append((fn, t, name, a))
        init_p, buf0, buf1 = a[8:11]
        assert a[11:] == (h, w, th, tw_, 4, 15, wk.right_spill(tw_),
                          n_iters, 6.0, -1, 0)
        for i in range(n_iters):
            got = wk.fused_lk_level_precomputed_reference(
                *args, n_iters=i + 1, **kw)
            ctypes.memmove((buf0, buf1)[i % 2], got.data_ptr(),
                           got.numel() * 4)

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        lk_fused_level_pre_launch="pre"))
    monkeypatch.setattr(_build, "launch", launch)
    before = args[-1].clone()
    wk.reset_counters()
    out = wk._fused_level_pre_cuda(*args, n_iters=n_iters, **kw)
    assert wk.kernel_launches["fused_lk_level_precomputed"] == 1
    (fn, t, name, a), = launches
    assert (fn, name) == ("pre", "fused_lk_level_precomputed")
    assert t is args[0]
    assert a[:9] == tuple(x.data_ptr() for x in args)
    init_p, buf0, buf1 = a[8:11]
    assert buf0 not in (None, init_p)
    assert (buf1 is None) if n_iters == 1 else buf1 not in (buf0, init_p)
    assert out.data_ptr() == (buf0, buf1)[(n_iters - 1) % 2]
    assert torch.equal(args[-1], before)
    want = wk.fused_lk_level_precomputed_reference(*args, n_iters=n_iters,
                                                   **kw)
    assert torch.equal(out, want)


def test_cpu_inputs_take_the_plain_versions(rng):
    """CPU tensors go to the plain versions and only they: the counters
    show it, and an unsupported device raises instead of falling back."""
    h, w = 32, 64
    img = _t(rng.random((h, w)) * 255)
    flow = torch.zeros((2, h, w))
    wk.reset_counters()
    wk.local_warp(img, flow, max_disp=4, tile_h=32, tile_w=64, local=3)
    z = torch.zeros((h, w))
    wk.fused_lk_level_precomputed(img, img, z, z, z, z, z, z, flow,
                                  n_iters=2, max_disp=4, tile_h=16,
                                  tile_w=64, local=3)
    assert wk.plain_calls == {"local_warp": 1,
                              "fused_lk_level_precomputed": 1}
    assert sum(wk.kernel_launches.values()) == 0
    meta = torch.empty((h, w), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wk.local_warp(meta, torch.empty((2, h, w), device="meta"),
                      max_disp=4, tile_h=32, tile_w=64, local=3)
    with pytest.raises(ValueError, match="not a multiple of the tile"):
        wk.local_warp(img, flow, max_disp=4, tile_h=24, tile_w=64, local=3)
