"""Flow lines, cross points, the VP state machine and motion classes:
lk_tpu_torch against lk_tpu on the same numpy inputs (CPU).

Tolerances, and why: lk_tpu's functions called outside ``jit`` run op by
op, so the cross points (divisions and products of raw coordinates) agree
bit for bit, nan for nan.  PyTorch's CPU sqrt and arccos are not always
correctly rounded (XLA's are), so a line's length may differ in its last
bit, which the 2-decimal rounding absorbs except at a rounding boundary
(<= 0.01), and its angle by <= 1e-4 degrees.  The VP scan runs inside a
``lax.while_loop`` in lk_tpu (compiled: FMA contraction, division by a
constant as a reciprocal) and sums the ring in another order: VP
positions <= 1e-4 px, every mask and counter exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lk_tpu.config import PipelineConfig
from lk_tpu.geometry import classify as jcl
from lk_tpu.geometry import crosspoints as jcp
from lk_tpu.geometry import flowlines as jfl
from lk_tpu.geometry import vanishing as jvp
from lk_tpu.models import PRESETS
from lk_tpu_torch.geometry import classify as tcl
from lk_tpu_torch.geometry import crosspoints as tcp
from lk_tpu_torch.geometry import flowlines as tfl
from lk_tpu_torch.geometry import vanishing as tvp
from torch_parity import port_cfg


def _segments(rng, n, quirks=True):
    """n random segments (start, stop) in a 430x242 frame, with vertical,
    horizontal, parallel and zero-length members when ``quirks``."""
    start = rng.uniform(0, 430, (n, 2)).astype(np.float32)
    stop = (start + rng.normal(0, 6, (n, 2))).astype(np.float32)
    if quirks:
        stop[0, 0] = start[0, 0]                     # vertical line
        stop[1, 1] = start[1, 1]                     # horizontal line
        stop[2] = start[2]                           # not moving
        stop[3] = start[3] + (stop[4] - start[4])    # parallel to line 4
        stop[5, 0] = start[5, 0]                     # a second vertical
    return start, stop


def test_flow_line_stats(rng):
    start, stop = _segments(rng, 400)
    js = jfl.flow_line_stats(jnp.asarray(start), jnp.asarray(stop))
    ts = tfl.flow_line_stats(torch.from_numpy(start), torch.from_numpy(stop))
    np.testing.assert_array_equal(ts.moving.numpy(), np.asarray(js.moving))
    dl = np.abs(ts.length.numpy() - np.asarray(js.length))
    assert dl.max() <= 0.01 + 1e-6 and (dl == 0).mean() >= 0.99
    np.testing.assert_allclose(ts.angle.numpy(), np.asarray(js.angle),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("before", [True, False])
def test_flow_line_filter(rng, before):
    """The same stats in (lk_tpu's, to isolate the sequential rule): the
    accepted set exact, avg_len <= 1e-5 relative."""
    start, stop = _segments(rng, 3 * 10, quirks=False)
    js = jfl.flow_line_stats(jnp.asarray(start), jnp.asarray(stop))
    valid = rng.random(30) < 0.8
    ts = tfl.FlowLineStats(*(torch.from_numpy(np.asarray(a)) for a in js))
    avg0 = np.float32([1.5, 2.5, 4.0])
    acc_t, avg_t = tfl.flow_line_filter(
        tfl.FlowLineStats(*(a.reshape((3, 10) + a.shape[1:]) for a in ts)),
        torch.from_numpy(valid.reshape(3, 10)), torch.from_numpy(avg0),
        1.5, 0.05, update_before_test=before)
    for g in range(3):
        sl = slice(10 * g, 10 * g + 10)
        acc_j, avg_j = jfl.flow_line_filter(
            jfl.FlowLineStats(*(a[sl] for a in js)), jnp.asarray(valid[sl]),
            jnp.float32(avg0[g]), 1.5, 0.05, update_before_test=before)
        np.testing.assert_array_equal(acc_t[g].numpy(), np.asarray(acc_j))
        np.testing.assert_allclose(avg_t[g].item(), float(avg_j), rtol=1e-5)


@pytest.mark.parametrize("n", [6, 20])
def test_cross_points_bit_for_bit(rng, n):
    start, stop = _segments(rng, n)
    want = np.asarray(jcp.cross_point_pairs(jnp.asarray(start),
                                            jnp.asarray(stop)))
    got = tcp.cross_point_pairs(torch.from_numpy(start),
                                torch.from_numpy(stop)).numpy()
    assert np.isnan(want).any()                    # the quirks are hit
    np.testing.assert_array_equal(got, want)         # nan == nan here
    # batched form: per row the same
    both = tcp.cross_point_pairs(torch.from_numpy(np.stack([start, stop])),
                                 torch.from_numpy(np.stack([stop, start])))
    np.testing.assert_array_equal(both[0].numpy(), want)
    ii, jj = jcp.PAIR_INDICES(n)
    ti, tj = tcp.PAIR_INDICES(n)
    np.testing.assert_array_equal(ti, ii)
    np.testing.assert_array_equal(tj, jj)


def _line_frames(rng, cfg, t_frames, n):
    """Per frame, n flow lines converging on (200, 100) with noise, and an
    accepted mask — input of the VP scan."""
    frames = []
    for _ in range(t_frames):
        start = np.stack([rng.uniform(60, 370, n),
                          rng.uniform(130, 230, n)], -1).astype(np.float32)
        d = start - np.float32([200, 100])
        stop = (start + d * rng.uniform(0.02, 0.06, (n, 1))
                + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
        frames.append((start, stop, rng.random(n) < 0.8))
    return frames


@pytest.mark.parametrize("preset", ["final", "vp_detect", "classify"])
def test_vp_scan_matches_lk_tpu(rng, monkeypatch, preset):
    """process_frame_pairs + vp_show_step over 24 frames, 3 streams batched
    in the port, each run alone through lk_tpu (one jitted frame step)."""
    cfg = dataclasses.replace(PRESETS[preset], hide_vp_thold=4)
    tcfg = port_cfg(cfg)
    size = (430, 242)
    n_frames = 24
    streams = [_line_frames(rng, cfg, n_frames, cfg.tp_num)
               for _ in range(3)]
    # stream 2 goes quiet for a while: the VP hides and re-initializes
    for t in range(10, 16):
        s, e, a = streams[2][t]
        streams[2][t] = (s, e, np.zeros_like(a))

    # lk_tpu's frame step, jitted once; its line stats and cross points are
    # computed op by op outside and passed in (under jit XLA contracts the
    # cross-point products into FMAs, which near-parallel lines amplify)
    held = []
    monkeypatch.setattr(jvp, "cross_point_pairs", lambda *_: held[-1])

    @jax.jit
    def jstep(state, lines, a, cps):
        held.append(cps)
        st, out = jvp.process_frame_pairs(state, lines, a, cfg, size)
        return jvp.vp_show_step(st, out, cfg)

    jstates = [jvp.init_vp_state(cfg) for _ in range(3)]
    tstate = tvp.init_vp_state(tcfg, 3, device="cpu")
    hidden = 0
    for t in range(n_frames):
        jouts = []
        for b in range(3):
            s, e, a = map(jnp.asarray, streams[b][t])
            jstates[b], out = jstep(jstates[b], jfl.flow_line_stats(s, e), a,
                                    jcp.cross_point_pairs(s, e))
            jouts.append(out)
        # the port on lk_tpu's line stats, to isolate the scan
        s = np.stack([streams[b][t][0] for b in range(3)])
        e = np.stack([streams[b][t][1] for b in range(3)])
        a = np.stack([streams[b][t][2] for b in range(3)])
        jl = [jfl.flow_line_stats(jnp.asarray(s[b]), jnp.asarray(e[b]))
              for b in range(3)]
        lines = tfl.FlowLineStats(*(torch.from_numpy(np.stack(
            [np.asarray(x[k]) for x in jl])) for k in range(5)))
        cps, cand = tvp.frame_candidates(lines, torch.from_numpy(a), tcfg,
                                         size)
        tstate, tout = tvp.process_frame_pairs(tstate, cps, cand, tcfg, size)
        tstate, tout = tvp.vp_show_step(tstate, tout, tcfg)
        for b in range(3):
            jo = jouts[b]
            for k in ("update_mask", "cp_mask", "show_mask", "vp_hidden"):
                np.testing.assert_array_equal(
                    getattr(tout, k)[b].numpy(), np.asarray(getattr(jo, k)),
                    err_msg=f"{k} t={t} b={b}")
            for k in ("update_rows", "cp_xy", "show_row"):
                np.testing.assert_allclose(
                    getattr(tout, k)[b].numpy(), np.asarray(getattr(jo, k)),
                    rtol=0, atol=1e-4, err_msg=f"{k} t={t} b={b}")
            hidden += int(np.asarray(jo.vp_hidden))
    for b in range(3):
        js = jstates[b]
        for k in ("vp_init", "vp_moved", "ring_total", "alias_pos", "vp_ult",
                  "hist_total"):
            assert getattr(tstate, k)[b].item() == int(getattr(js, k)), k
        for k in ("vp_xy", "ring_xy", "hist_xy"):
            np.testing.assert_allclose(getattr(tstate, k)[b].numpy(),
                                       np.asarray(getattr(js, k)), rtol=0,
                                       atol=1e-4)
    assert hidden > 0 and bool(tstate.vp_init.any())


def test_classify_flow_lines(rng):
    """Labels and fractions exact, mean speeds <= 1e-5."""
    start, stop = _segments(rng, 60, quirks=False)
    stop[:10] = start[:10] + rng.normal(0, 0.2, (10, 2))    # below min_mag
    valid = rng.random(60) < 0.7
    vp = np.float32([200, 100])
    want = jcl.classify_flow_lines(jnp.asarray(start), jnp.asarray(stop),
                                   jnp.asarray(valid), jnp.asarray(vp))
    got = tcl.classify_flow_lines(torch.from_numpy(start),
                                  torch.from_numpy(stop),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(vp))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for k in ("frac_static", "frac_away", "frac_toward", "frac_lateral"):
        assert getattr(got, k).item() == float(getattr(want, k)), k
    for k in ("mean_radial", "mean_tangential"):
        np.testing.assert_allclose(getattr(got, k).item(),
                                   float(getattr(want, k)), rtol=0, atol=1e-5)
    assert len(set(got.labels.numpy().tolist())) >= 3


def test_vp_state_init_is_zero():
    cfg = PipelineConfig()
    js = jvp.init_vp_state(cfg)
    ts = tvp.init_vp_state(port_cfg(cfg), 2, device="cpu")
    for k, v in js._asdict().items():
        t = getattr(ts, k)
        assert t.shape == (2,) + np.asarray(v).shape, k
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(v))
