"""Aux modules of lk_tpu_torch on the CPU: homography (against lk_tpu and
cv2, as tests/test_aux.py), profiling, viz, and the presentation imports.

Tolerances, and why: the homography is an 8x8 f32 solve on both sides
(LAPACK here, XLA's LU in lk_tpu): <= 1e-4 of the normalized matrix
against lk_tpu, 1e-3 against cv2's f64 solve (tests/test_aux.py's); the
warp is the same bilinear gather on the same f32 map: <= 1e-3 against
lk_tpu, 1.0 against cv2 in the interior (tests/test_aux.py's: OpenCV
fills the border with zeros where both packages clamp)."""

import os
import sys

import numpy as np
import pytest
import torch

import cv2 as cv
import jax.numpy as jnp

from lk_tpu.ops import homography as jhom
from lk_tpu_torch.ops import homography as thom
from lk_tpu_torch.utils import profiling as prof

SRC = np.float32([[10, 10], [90, 12], [88, 70], [12, 72]])
DST = np.float32([[0, 0], [100, 0], [100, 80], [0, 80]])


def test_perspective_transform_matches():
    ours = thom.get_perspective_transform(SRC, DST, device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == (3, 3)
    ours = ours.numpy()
    jax_ = np.asarray(jhom.get_perspective_transform(SRC, DST))
    ref = cv.getPerspectiveTransform(SRC, DST)
    np.testing.assert_allclose(ours / ours[2, 2], jax_ / jax_[2, 2],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours / ours[2, 2], ref / ref[2, 2],
                               rtol=1e-3, atol=1e-3)
    t = thom.get_perspective_transform(torch.from_numpy(SRC),
                                       torch.from_numpy(DST))
    np.testing.assert_array_equal(t.numpy(), ours)


def test_warp_perspective_matches():
    img = (np.random.default_rng(1234).random((80, 100)) * 255).astype(
        np.float32)
    h = cv.getPerspectiveTransform(SRC, DST)
    ref = cv.warpPerspective(img, h, (100, 80))
    jax_ = np.asarray(jhom.warp_perspective(jnp.asarray(img),
                                            jnp.asarray(h), 80, 100))
    ours = thom.warp_perspective(torch.from_numpy(img), h, 80, 100).numpy()
    assert ours.shape == (80, 100)
    np.testing.assert_allclose(ours, jax_, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ours[5:-5, 5:-5], ref[5:-5, 5:-5], atol=1.0)


def test_fps_meter(monkeypatch):
    """5 ticks at exactly 10 ms on a synthetic clock -> 100 fps."""
    t = iter(0.01 * k for k in range(100))
    monkeypatch.setattr(prof.time, "perf_counter", lambda: next(t))
    m = prof.FrameRateMeter(window=5)
    assert m.fps == 0.0
    for _ in range(5):
        m.tick()
    assert abs(m.fps - 100.0) < 1e-6


def test_spans():
    s = prof.Spans()
    for _ in range(2):
        with s("a"):
            pass
    with pytest.raises(ValueError):
        with s("b"):
            raise ValueError("counted all the same")
    assert s.count["a"] == 2 and s.count["b"] == 1
    assert "a" in s.summary() and "b" in s.summary()


def test_device_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with prof.device_trace(d) as p:
        torch.ones(64).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 100
    assert len(p.key_averages()) > 0


def test_figures_render(tmp_path):
    from lk_tpu_torch import viz

    rng = np.random.default_rng(1234)
    hist = rng.random((50, 2)) * 100 + 300
    cps = rng.random((80, 2)) * 100 + 300
    p1 = viz.plot_vp_figure(hist, cps, (430, 240), 860, 483,
                            out_path=str(tmp_path / "a.png"))
    p2 = viz.vp_distribution_figure(hist[:, 0], hist[:, 1], 860, 483,
                                    out_path=str(tmp_path / "b.png"))
    segs = [dict(start=np.array([10.0, 10.0]), stop=np.array([20.0, 30.0]))]
    p3 = viz.all_lines_image(segs, 860, 483, (430, 240),
                             out_path=str(tmp_path / "c.png"))
    assert all(os.path.getsize(p) > 1000 for p in (p1, p2, p3))


def test_presentation_without_opencv_raises(tmp_path, monkeypatch):
    """Where cv2 or matplotlib is missing, asking for a picture raises an
    ImportError that names what asked; nothing is skipped silently."""
    from lk_tpu_torch import viz

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="flow-lines image"):
        viz.all_lines_image([], 64, 48, out_path=str(tmp_path / "c.png"))
    with pytest.raises(ImportError, match="figure"):
        viz.vp_distribution_figure([1.0], [2.0], 64, 48,
                                   out_path=str(tmp_path / "b.png"))
    assert not os.path.exists(tmp_path / "c.png")
