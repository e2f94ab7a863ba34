"""lk_tpu_torch.geometry.hough against lk_tpu.geometry.hough on the CPU.

Tolerances, and why: the vote is one f32 matmul on both sides, its sums
taken in another order, so accumulators agree to 1e-4 relative (of the
largest vote); segment parameters to 1e-5 rad and 1e-3 px (atan2, cos and
sin in f32).  Peaks land in the same (theta, rho) bins, their refined
values within 1e-4 rad and 1e-2 px.

The HWHM choice (ROADMAP Queue 3, lk_tpu/geometry/hough.py:153): both
packages read each peak's suppression profile from the ORIGINAL
accumulator.  ``test_hwhm_on_original_accumulator`` pins the port to it on
a layout where that choice decides: a weak line between two strong ones
is suppressed by a radius that saturates at the 16-bin clamp, where
reading the already-suppressed grid would have kept it."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lk_tpu.geometry import hough as jh
from lk_tpu_torch.geometry import hough as th

SIZE = (430, 242)


def _segments(seed, n=300):
    """Segments along 3 planted lines plus jitter and a few zero-length
    and near-vertical ones."""
    rng = np.random.default_rng(seed)
    starts, stops = [], []
    for (px, py, ang) in ((120, 200, -35), (300, 200, -145), (215, 60, 90)):
        a = math.radians(ang)
        d = np.array([math.cos(a), math.sin(a)])
        for _ in range(n // 3):
            t0 = rng.uniform(-60, 60)
            ln = rng.uniform(2, 20)
            a = np.array([px, py]) + t0 * d + rng.normal(0, 0.4, 2)
            starts.append(a)
            stops.append(a + ln * d + rng.normal(0, 0.2, 2))
    s = np.array(starts, np.float32)
    e = np.array(stops, np.float32)
    e[:5] = s[:5]                                    # zero-length
    mask = rng.random(len(s)) > 0.1
    return s, e, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_params_and_vote(seed):
    s, e, m = _segments(seed)
    jt, jr = jh.segment_line_params(jnp.asarray(s), jnp.asarray(e))
    tt, tr = th.segment_line_params(torch.from_numpy(s), torch.from_numpy(e))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-3)
    for lw in (True, False):
        ja = np.asarray(jh.hough_vote(jnp.asarray(s), jnp.asarray(e),
                                      jnp.asarray(m), SIZE,
                                      length_weighted=lw))
        ta = th.hough_vote(torch.from_numpy(s), torch.from_numpy(e),
                           torch.from_numpy(m), SIZE, length_weighted=lw)
        assert ta.shape == ja.shape == (180, 256)
        assert ta.dtype == torch.float32
        np.testing.assert_allclose(ta.numpy(), ja, rtol=0,
                                   atol=1e-4 * ja.max())


def _bins(res, n_theta=180, n_rho=256, size=SIZE):
    rho_max = math.hypot(*size)
    t = np.round(np.asarray(res.theta) / math.pi * n_theta) % n_theta
    r = np.round((np.asarray(res.rho) + rho_max) / (2 * rho_max)
                 * (n_rho - 1))
    return t, r


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [3, 6])
def test_road_lines_same_peaks(seed, k):
    s, e, m = _segments(seed)
    jr = jh.hough_road_lines(jnp.asarray(s), jnp.asarray(e), jnp.asarray(m),
                             SIZE, k=k)
    tr = th.hough_road_lines(torch.from_numpy(s), torch.from_numpy(e),
                             torch.from_numpy(m), SIZE, k=k)
    for a, b in zip(_bins(tr), _bins(jr)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.rho.numpy(), np.asarray(jr.rho), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(tr.votes.numpy(), np.asarray(jr.votes),
                               rtol=1e-4)


@pytest.mark.parametrize("fixed", [(3, 5), (0, 0), (None, 8)])
def test_peaks_fixed_radius_and_wrap(fixed):
    """Explicit suppression radii, and peaks at the 0/pi wrap (the rho
    mirror) and at the rho edges, on one accumulator."""
    rng = np.random.default_rng(3)
    acc = rng.random((180, 256)).astype(np.float32)
    acc[0, 40] = acc[179, 215] = 50.0        # one line across the wrap
    acc[1, 41], acc[178, 214] = 30.0, 20.0
    acc[90, 0] = acc[60, 255] = 40.0         # rho edges
    acc[120, 100], acc[121, 100], acc[119, 100] = 35.0, 34.0, 10.0
    st, sr = fixed
    j = jh.hough_peaks(jnp.asarray(acc), 6, SIZE, st, sr)
    t = th.hough_peaks(torch.from_numpy(acc), 6, SIZE, st, sr)
    for a, b in zip(_bins(t), _bins(j)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.theta.numpy(), np.asarray(j.theta),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.rho.numpy(), np.asarray(j.rho), rtol=0,
                               atol=1e-2)
    np.testing.assert_array_equal(t.votes.numpy(), np.asarray(j.votes))


def test_hwhm_on_original_accumulator():
    """ROADMAP Queue 3's layout on one rho row: Y (100) at theta 60 with a
    flat shoulder of 47 over theta 44..71 (below Y's half, so Y's own
    radius is 2), X (90) at theta 72 (the shoulder is above X's half),
    and a weaker line C (60) at theta 85.  Read on the original
    accumulator, X's left profile never drops below half within 16 bins:
    its radius saturates at the clamp and suppresses C (13 bins away).
    Read on the grid after Y's suppression it would stop at Y's window,
    10 bins away, and C would survive.  lk_tpu reads the original; so
    does the port: C is not among the first three peaks."""
    acc = np.zeros((180, 256), np.float32)
    r = 128
    acc[44:72, r] = 47.0
    acc[60, r] = 100.0
    acc[72, r] = 90.0
    acc[85, r] = 60.0
    j = jh.hough_peaks(jnp.asarray(acc), 3, SIZE)
    t = th.hough_peaks(torch.from_numpy(acc), 3, SIZE)
    tb, rb = _bins(t)
    np.testing.assert_array_equal(tb, _bins(j)[0])
    np.testing.assert_array_equal(rb, _bins(j)[1])
    np.testing.assert_array_equal(t.votes.numpy(), np.asarray(j.votes))
    assert t.votes.tolist() == [100.0, 90.0, 47.0]
    assert 85 not in tb.tolist()
    assert tb[:2].tolist() == [60, 72]


def test_empty_and_all_masked():
    """No moving segment: an all-zero accumulator, peaks with zero votes,
    as lk_tpu."""
    s = np.zeros((4, 2), np.float32)
    m = np.zeros(4, bool)
    j = jh.hough_road_lines(jnp.asarray(s), jnp.asarray(s + 1),
                            jnp.asarray(m), SIZE)
    t = th.hough_road_lines(torch.from_numpy(s), torch.from_numpy(s + 1),
                            torch.from_numpy(m), SIZE)
    assert float(t.accumulator.abs().sum()) == 0.0
    np.testing.assert_array_equal(t.votes.numpy(), np.asarray(j.votes))
    np.testing.assert_allclose(t.theta.numpy(), np.asarray(j.theta),
                               atol=1e-6)
    np.testing.assert_allclose(t.rho.numpy(), np.asarray(j.rho), atol=1e-3)
