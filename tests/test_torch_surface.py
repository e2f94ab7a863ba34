"""The rest of lk_tpu's public surface in the port: lk_tpu_torch against
lk_tpu on the same seeded numpy inputs (CPU), mirroring lk_tpu's own tests
(tests/test_ops_image.py, tests/test_classify.py).

Tolerances, and why: lk_tpu's functions called outside ``jit`` run op by
op, so elementwise code agrees bit for bit (the patch blend, the motion
labels, the pyramid's first pass).  Matrix products and reductions are
summed in another order: the resizes <= 1e-3 on the 0..255 scale (as
tests/test_torch_finish.py bounds resize_area), the pyramid <= 1e-4 (as
tests/test_torch_ops.py bounds pyr_down), the mean speeds and the
vanishing-line regressions 1e-5 relative.  ``padded_build``: lk_tpu's
padded build is a different decimation (banded matmuls into the padded
layout, not bit-equal to its own two-step build), so the port's video is
held to it within the video chain's bound of tests/test_torch_dense.py.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lk_tpu import ops as jops
from lk_tpu.config import DenseLKConfig, LKConfig, PipelineConfig
from lk_tpu.flow import dense as jd
from lk_tpu.geometry import classify as jcl
from lk_tpu.geometry import flowlines as jfl
from lk_tpu.geometry import vanishing as jvp
from lk_tpu.ops import resize as jresize
from lk_tpu_torch import ops
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.geometry import classify as tcl
from lk_tpu_torch.geometry import vanishing as tvp
from lk_tpu_torch.utils import Timer
from torch_parity import affine_clip, interpret_pallas, port_cfg


def _img(rng, shape):
    return rng.integers(0, 256, shape).astype(np.float32)


def test_ops_example_of_the_verify_recipe(rng):
    """``from lk_tpu_torch import ops``: gray, INTER_AREA resize and the 3x3
    blur of a BGR frame, as lk_tpu's ops do it."""
    frame = rng.integers(0, 256, (108, 192, 3), np.uint8)
    gray = ops.bgr_to_gray(torch.from_numpy(frame).to(torch.float32))
    small = ops.gaussian_blur3(ops.resize_area(gray, 48, 86))
    jgray = jops.bgr_to_gray(jnp.asarray(frame, jnp.float32))
    jsmall = jops.gaussian_blur3(jops.resize_area(jgray, 48, 86))
    np.testing.assert_array_equal(gray.numpy(), np.asarray(jgray))
    assert small.shape == (48, 86)
    np.testing.assert_allclose(small.numpy(), np.asarray(jsmall), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("shape,max_level", [((100, 173), 2), ((37, 53), 3),
                                             ((64, 96), 0)])
def test_gaussian_pyramid(rng, shape, max_level):
    """tests/test_ops_image.py:52's shapes, and lk_tpu's levels."""
    img = _img(rng, shape)
    got = ops.gaussian_pyramid(torch.from_numpy(img), max_level)
    want = jops.gaussian_pyramid(jnp.asarray(img), max_level)
    assert isinstance(got, list) and len(got) == max_level + 1
    assert [g.shape for g in got] == [w.shape for w in want]
    if shape == (100, 173):
        assert [g.shape for g in got] == [(100, 173), (50, 87), (25, 44)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_linear_weights():
    """lk_tpu's INTER_LINEAR weights, exactly, and cached."""
    for src, dst in [(60, 45), (90, 70), (17, 40), (5, 5)]:
        np.testing.assert_array_equal(ops.resize.linear_weights(src, dst),
                                      jresize.linear_weights(src, dst))
    assert ops.resize.linear_weights(60, 45) is ops.resize.linear_weights(
        60, 45)


@pytest.mark.parametrize("src,dst", [((60, 90), (45, 70)),
                                     ((2, 33, 40), (50, 61))])
def test_resize_linear(rng, src, dst):
    """tests/test_ops_image.py:66's downscale, and an upscale of a batch."""
    img = _img(rng, src)
    got = ops.resize_linear(torch.from_numpy(img), *dst).numpy()
    want = np.asarray(jops.resize_linear(jnp.asarray(img), *dst))
    assert got.shape == want.shape == src[:-2] + dst
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw,width", [((108, 192), 86), ((1080, 1920), 860),
                                      ((77, 131), 64)])
def test_imutils_width_resize(rng, hw, width):
    """imutils' height, int(h * (width / float(w))), and INTER_AREA."""
    img = _img(rng, hw) if hw[0] < 1000 else _img(rng, (1, 1)) * np.ones(
        hw, np.float32)
    got = ops.resize.imutils_width_resize(torch.from_numpy(img), width)
    want = np.asarray(jresize.imutils_width_resize(jnp.asarray(img), width))
    assert got.shape == want.shape == (int(hw[0] * (width / float(hw[1]))),
                                       width)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("center", [(22.4, 17.8), (2.3, 1.7), (58.6, 48.2),
                                    (-3.5, 20.25), (30.0, 60.9)])
def test_extract_patch(rng, center):
    """tests/test_ops_image.py:108's window, and corners whose slice start
    leaves the image: lax.dynamic_slice's rule (a negative start counts
    from the end, then clamps into the image) while the fractions stay
    those of the unclamped corner; bit-equal to lk_tpu."""
    img = _img(rng, (50, 60))
    c = np.float32(center)
    got = ops.extract_patch(torch.from_numpy(img), torch.from_numpy(c),
                            (15, 13))
    want = np.asarray(jops.extract_patch(jnp.asarray(img), jnp.asarray(c),
                                         (15, 13)))
    assert got.shape == (13, 15)
    np.testing.assert_array_equal(got.numpy(), want)


def _radial_flow(sign):
    h, w = 64, 96
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([(xs - 48.0) * 0.05, (ys - 32.0) * 0.05], -1) * sign


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_classify_dense_flow(rng, sign):
    """tests/test_classify.py:23 and :34 (expansion streams away from the VP,
    contraction toward it), plus lk_tpu's labels and summary, with a mask
    and a lateral component."""
    flow = _radial_flow(sign)
    vp = np.float32([48.0, 32.0])
    s = tcl.classify_dense_flow(torch.from_numpy(flow), torch.from_numpy(vp),
                                min_mag=0.5)
    if sign > 0:
        assert float(s.frac_away) > 0.5 and float(s.frac_toward) < 0.01
        assert float(s.mean_radial) > 0
    else:
        assert float(s.frac_toward) > 0.5 and float(s.mean_radial) < 0
    flow = flow + rng.normal(0, 0.6, flow.shape).astype(np.float32)
    valid = rng.random(flow.shape[:2]) < 0.8
    for v in (None, valid):
        got = tcl.classify_dense_flow(
            torch.from_numpy(flow), torch.from_numpy(vp),
            None if v is None else torch.from_numpy(v))
        want = jcl.classify_dense_flow(
            jnp.asarray(flow), jnp.asarray(vp),
            None if v is None else jnp.asarray(v))
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        for k in ("frac_static", "frac_away", "frac_toward", "frac_lateral"):
            assert getattr(got, k).item() == float(getattr(want, k)), k
        for k in ("mean_radial", "mean_tangential"):
            np.testing.assert_allclose(getattr(got, k).item(),
                                       float(getattr(want, k)), rtol=1e-5,
                                       atol=1e-7)
        assert len(set(got.labels.numpy().ravel().tolist())) == 4
    batched = tcl.classify_dense_flow(
        torch.from_numpy(np.stack([flow, -flow])),
        torch.from_numpy(np.stack([vp, vp])))
    one = tcl.classify_dense_flow(torch.from_numpy(-flow),
                                  torch.from_numpy(vp))
    assert torch.equal(batched.labels[1], one.labels)
    assert batched.frac_away[1].item() == one.frac_away.item()


def _line_frames(rng, t_frames, n):
    """Per frame, n flow lines converging on (200, 100) with noise, and an
    accepted mask (tests/test_torch_geometry.py's VP scan input)."""
    frames = []
    for _ in range(t_frames):
        start = np.stack([rng.uniform(60, 370, n),
                          rng.uniform(130, 230, n)], -1).astype(np.float32)
        d = start - np.float32([200, 100])
        stop = (start + d * rng.uniform(0.02, 0.06, (n, 1))
                + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
        frames.append((start, stop, rng.random(n) < 0.8))
    return frames


def test_vanishing_lines(rng):
    """Per stream, lk_tpu's vanishing lines of the VP state after a seeded
    run of its VP state machine: 3 streams of 30 frames on an 8-slot
    history ring (it wraps), one stream gone quiet so its VP never moves
    (ok False).  Endpoints 1e-5 relative, ok exact."""
    cfg = dataclasses.replace(PipelineConfig(), vp_ref=8)
    size = (430, 242)

    @jax.jit
    def jstep(state, start, stop, accepted):
        lines = jfl.flow_line_stats(start, stop)
        st, out = jvp.process_frame_pairs(state, lines, accepted, cfg, size)
        return jvp.vp_show_step(st, out, cfg)[0]

    states = []
    for b in range(3):
        st = jvp.init_vp_state(cfg)
        for s, e, a in _line_frames(rng, 30, cfg.tp_num):
            st = jstep(st, s, e, a & (b != 2))
        states.append(st)
    assert [bool(s.vp_moved) for s in states] == [True, True, False]
    assert int(states[0].hist_total) > cfg.vp_ref
    tstate = tvp.VPState(*(torch.from_numpy(np.stack(
        [np.asarray(getattr(s, k)) for s in states]).astype(
            np.float32 if np.asarray(getattr(states[0], k)).dtype.kind == "f"
            else (bool if k in ("vp_init", "vp_moved") else np.int64)))
        for k in jvp.VPState._fields))
    (lp, rp, up, dp), ok = tvp.vanishing_lines(tstate, port_cfg(cfg), size)
    for b in range(3):
        (jl, jr, ju, jdn), jok = jvp.vanishing_lines(states[b], cfg, size)
        assert bool(ok[b]) == bool(jok)
        for got, want in zip((lp, rp, up, dp), (jl, jr, ju, jdn)):
            assert got.shape == (3, 2)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-4)


def test_timer():
    """A host wall-clock span."""
    with Timer() as t:
        time.sleep(0.01)
    assert 0.01 <= t.dt < 5.0


# --- padded_build -----------------------------------------------------------

CFG = LKConfig(max_level=1)
DCFG = DenseLKConfig(use_pallas_fused=True, iter_schedule=(1, 4),
                     pyramid_levels=2, video_chunk=3, scharr_mxu=False,
                     padded_build=True)


@pytest.fixture(scope="module")
def clip():
    return affine_clip(np.random.default_rng(1234), 64, 512, 5)


def test_padded_build_video(clip, monkeypatch):
    """5 frames = one chunk of 3 pairs + a 1-pair tail, on the video plan:
    the port's video with padded_build equals the one without bit for bit,
    and is within the video chain's bound of lk_tpu's padded_build video
    (flow 0.05 px max, 5e-3 mean, min_eig 5e-3 relative, flips 1e-3)."""
    interpret_pallas(monkeypatch)
    frames = torch.from_numpy(clip)
    tcfg = port_cfg(CFG)
    got = td.dense_pyramidal_lk_video(frames, tcfg, port_cfg(DCFG))
    plain = td.dense_pyramidal_lk_video(
        frames, tcfg, port_cfg(dataclasses.replace(DCFG, padded_build=False)))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    levels = td.build_frame_levels(frames[0], tcfg, port_cfg(DCFG))
    for a, b in zip(levels, td.build_frame_levels(
            frames[0], tcfg, port_cfg(dataclasses.replace(
                DCFG, padded_build=False)))):
        assert torch.equal(a, b)
    jr = jd.dense_pyramidal_lk_video(jnp.asarray(clip), CFG, DCFG)
    fj, ft = np.asarray(jr.flow), got.flow.numpy()
    assert fj.shape == ft.shape == (4, 64, 512, 2)
    same = np.asarray(jr.valid) == got.valid.numpy()
    assert (~same).mean() <= 1e-3
    d = np.abs(fj - ft)[same]
    assert d.max() < 0.05 and d.mean() < 5e-3, (d.max(), d.mean())
    me_j, me_t = np.asarray(jr.min_eig), got.min_eig.numpy()
    assert np.abs(me_j - me_t).max() / np.abs(me_j).max() < 5e-3


def test_padded_build_raises_where_lk_tpu_raises(clip, monkeypatch):
    """Without fast_pyramid the video plan's build refuses on both sides,
    with lk_tpu's message; the per-pair path builds no plan and runs."""
    interpret_pallas(monkeypatch)
    bad = dataclasses.replace(DCFG, fast_pyramid=False)
    frames = clip[:4]
    with pytest.raises(AssertionError) as j_err:
        jd.dense_pyramidal_lk_video(jnp.asarray(frames), CFG, bad)
    with pytest.raises(ValueError) as t_err:
        td.dense_pyramidal_lk_video(torch.from_numpy(frames),
                                    port_cfg(CFG), port_cfg(bad))
    assert str(t_err.value) == str(j_err.value)
    assert "fast_pyramid=True" in str(t_err.value)
    td.dense_pyramidal_lk(torch.from_numpy(clip[0]),
                          torch.from_numpy(clip[1]), port_cfg(CFG),
                          dense_cfg=port_cfg(bad))
    jd.dense_pyramidal_lk(jnp.asarray(clip[0]), jnp.asarray(clip[1]), CFG,
                          dense_cfg=bad)
