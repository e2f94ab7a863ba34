"""The per-point sparse tracker of the single-stream pipeline:
lk_tpu_torch's ``track_points`` and ``build_tracking_pyramid`` against
lk_tpu's on the same numpy inputs (CPU: the plain pyramid), and against
cv.calcOpticalFlowPyrLK.

Tolerances, and why:
* pyramid: level 0 exact (a pure re-indexing, the pad reflected again
  where it reaches past the far edge, as ``jnp.pad(mode="reflect")``);
  coarser levels <= 1e-3 on 0..255 data, because lk_tpu's exact pyr_down
  takes its column pass as a matmul (another summation order) where the
  port adds the five taps in order;
* tracker: positions <= 1e-3 px, the same status, err <= 1e-3 relative
  (+1e-4 absolute): the window sums are reductions whose order differs
  between XLA and PyTorch, and the coarse levels differ in their last
  bits;
* against OpenCV: mean EPE < 0.1 px over the points both track, as
  tests/test_flow_sparse.py holds lk_tpu."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lk_tpu.config import LKConfig
from lk_tpu.flow import sparse as js
from lk_tpu_torch.flow import sparse as ts
from torch_parity import port_cfg

H, W = 120, 176
CFG = LKConfig()


def _texture(rng, h, w):
    import cv2 as cv

    img = cv.GaussianBlur((rng.random((h, w)) * 255).astype(np.float32),
                          (0, 0), 2.0)
    img += cv.GaussianBlur((rng.random((h, w)) * 255).astype(np.float32),
                           (0, 0), 6.0)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(
        np.float32)


def _warp(img, m):
    import cv2 as cv

    return cv.warpAffine(img, np.float32(m), (img.shape[1], img.shape[0]),
                         flags=cv.INTER_LINEAR,
                         borderMode=cv.BORDER_REFLECT_101)


def _zoom_rotation(h, w, scale, deg):
    import cv2 as cv

    return cv.getRotationMatrix2D((w / 2, h / 2), deg, scale)


MOTIONS = {
    "translation": [[1, 0, 3.7], [0, 1, -2.2]],
    "zoom_rotation": _zoom_rotation(H, W, 1.04, 2.0),
}


@pytest.fixture(scope="module")
def scene():
    """A texture with a flat square, and points of every kind: interior,
    at and beyond the border, far off the frame, on the flat square, and
    invalid slots."""
    rng = np.random.default_rng(5)
    img = _texture(rng, H, W)
    img[40:80, 110:150] = 128.0                       # flat texture
    interior = rng.uniform([16, 16], [W - 16, H - 16], (24, 2))
    border = np.array([[0, 0], [W - 1, H - 1], [0.5, H / 2], [W - 0.25, 7],
                       [-3.5, 40], [W + 4, 60], [50, -6], [90, H + 9]])
    off = np.array([[-40, -40], [W + 60, H / 2], [W / 2, H + 80]])
    flat = np.array([[125, 55], [130, 62], [140, 70]])
    pts = np.concatenate([interior, border, off, flat]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[rng.choice(24, 5, replace=False)] = False
    return img, pts, valid


def _both(prev, nxt, pts, valid, cfg=CFG):
    want = js.track_points(jnp.asarray(prev), jnp.asarray(nxt),
                           jnp.asarray(pts), jnp.asarray(valid), cfg)
    got = ts.track_points(torch.from_numpy(prev), torch.from_numpy(nxt),
                          torch.from_numpy(pts), torch.from_numpy(valid),
                          port_cfg(cfg))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_track_points_matches_lk_tpu(scene, motion):
    img, pts, valid = scene
    nxt = _warp(img, MOTIONS[motion])
    (jp, jst, je), (tp, tst, te) = _both(img, nxt, pts, valid)
    np.testing.assert_array_equal(tst, jst)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
    np.testing.assert_allclose(te, je, rtol=1e-3, atol=1e-4)
    # every kind of point is there: tracked, lost, flat, passthrough
    assert 20 <= jst.sum() < len(pts) - 8
    assert not tst[-3:].any(), "points on flat texture must be rejected"
    np.testing.assert_array_equal(tp[~valid], pts[~valid])
    assert not tst[~valid].any()


def test_track_points_small_frame_reflects_twice():
    """A 40x64 frame at max_level 2: the 17-pixel pad is wider than the
    coarsest level's 10 rows, so the padded level reflects twice."""
    rng = np.random.default_rng(9)
    img = _texture(rng, 40, 64)
    nxt = _warp(img, [[1, 0, 0.8], [0, 1, 0.6]])
    pts = rng.uniform([2, 2], [62, 38], (12, 2)).astype(np.float32)
    valid = np.ones(12, bool)
    (jp, jst, je), (tp, tst, te) = _both(img, nxt, pts, valid)
    np.testing.assert_array_equal(tst, jst)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
    np.testing.assert_allclose(te, je, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("h,w,max_level", [(64, 128, 2), (40, 64, 2),
                                           (120, 176, 3)])
def test_build_tracking_pyramid_matches_lk_tpu(h, w, max_level):
    """Including sizes where the pad (17) reaches past the coarsest level
    (64 rows at max_level 2 -> 16; 40 -> 10)."""
    rng = np.random.default_rng(h)
    img = (rng.random((h, w)) * 255).astype(np.float32)
    pad = max(CFG.win_size) + 2
    want = js.build_tracking_pyramid(jnp.asarray(img), max_level, pad)
    got = ts.build_tracking_pyramid(torch.from_numpy(img), max_level, pad)
    assert len(got) == len(want) == max_level + 1
    for lv, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape
        if lv == 0:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-3)


@pytest.mark.parametrize("n,before,after", [(1, 3, 3), (2, 5, 1), (5, 17, 17),
                                            (16, 17, 17), (30, 17, 2)])
def test_reflect_index_is_numpy_reflect(n, before, after):
    want = np.pad(np.arange(n), (before, after), mode="reflect")
    got = ts.reflect_index(n, before, after, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_track_points_batch_of_planes_one_pyramid_build():
    """The prev and next pyramids come from one build_pyramid call."""
    from lk_tpu_torch.ops import blur

    rng = np.random.default_rng(1)
    img = torch.from_numpy(_texture(rng, 48, 80))
    blur.reset_counters()
    ts.track_points(img, img, torch.tensor([[40.0, 24.0]]),
                    torch.tensor([True]), port_cfg(CFG))
    assert blur.plain_calls == 1 and blur.kernel_launches == 0


@pytest.mark.parametrize("shift", [(1.0, 0.5), (3.7, -2.2), (8.5, 5.25)])
def test_track_points_epe_vs_opencv(shift):
    """Mean EPE < 0.1 px against cv.calcOpticalFlowPyrLK on the same u8
    frames (tests/test_flow_sparse.py's bound), < 0.25 px against the
    exact shift."""
    import cv2 as cv

    rng = np.random.default_rng(0)
    img = _texture(rng, 240, 320)
    nxt = _warp(img, [[1, 0, shift[0]], [0, 1, shift[1]]])
    prev8, next8 = img.astype(np.uint8), nxt.astype(np.uint8)
    pts = np.stack(np.meshgrid(np.linspace(40, 280, 7),
                               np.linspace(40, 200, 5)), -1).reshape(-1, 2)
    pts = pts.astype(np.float32)
    cv_p, cv_st, _ = cv.calcOpticalFlowPyrLK(
        prev8, next8, pts.reshape(-1, 1, 2), None, winSize=(15, 15),
        maxLevel=2,
        criteria=(cv.TERM_CRITERIA_EPS | cv.TERM_CRITERIA_COUNT, 10, 0.03))
    tp, tst, _ = ts.track_points(
        torch.from_numpy(prev8.astype(np.float32)),
        torch.from_numpy(next8.astype(np.float32)), torch.from_numpy(pts),
        torch.ones(len(pts), dtype=torch.bool), port_cfg(CFG))
    both = tst.numpy() & cv_st.reshape(-1).astype(bool)
    assert both.sum() >= len(pts) * 0.8
    tp = tp.numpy()[both]
    assert np.linalg.norm(tp - cv_p.reshape(-1, 2)[both], axis=1).mean() \
        < 0.1
    assert np.linalg.norm(tp - (pts[both] + np.array(shift)), axis=1).mean() \
        < 0.25
