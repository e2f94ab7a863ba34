"""The LK1/LK2 masked point tracker and Shi–Tomasi corner selection:
lk_tpu_torch's ``make_tracker``, ``donut_mask`` and
``good_features_to_track`` against lk_tpu's on the same frames (CPU).

Tolerances, and why: the corners are the same set exactly (the response
agrees to its last bits and the greedy selection decides the same); the
tracked points <= 1e-3 px with the same masks and live counts, as the
per-point tracker's own tests hold them (tests/test_torch_track_points.py:
window sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lk_tpu.config import FeatureConfig, LKConfig
from lk_tpu.features import shi_tomasi as jst
from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu.pipeline import tracker as jtr
from lk_tpu_torch.features import shi_tomasi as tst
from lk_tpu_torch.pipeline import tracker as ttr
from torch_parity import port_cfg

W, H, T = 320, 180, 9
OUTER, INNER = (0.05, 0.1, 0.95, 0.95), (0.3, 0.3, 0.7, 0.6)
FEATURES = FeatureConfig(max_corners=30)


@pytest.fixture(scope="module")
def grays():
    """T processed gray frames (f32) of a forward-driving scene."""
    import cv2 as cv

    scene = SyntheticRoadStream(width=W, height=H, n_frames=T, zoom=1.04,
                                seed=2)
    out = [cv.GaussianBlur(cv.cvtColor(scene.frame(t), cv.COLOR_BGR2GRAY)
                           .astype(np.float32), (3, 3), 0) for t in range(T)]
    return np.stack(out)


def test_donut_mask_matches_lk_tpu():
    want = np.asarray(jtr.donut_mask(H, W, OUTER, INNER))
    got = ttr.donut_mask(H, W, OUTER, INNER, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_good_features_to_track_matches_lk_tpu(grays, masked):
    mask = np.array(jtr.donut_mask(H, W, OUTER, INNER)) if masked else None
    for t in (0, T - 1):
        jxy, jv = jst.good_features_to_track(
            jnp.asarray(grays[t]), None if mask is None else jnp.asarray(mask),
            FEATURES)
        txy, tv = tst.good_features_to_track(
            torch.from_numpy(grays[t]),
            None if mask is None else torch.from_numpy(mask),
            port_cfg(FEATURES))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
        assert tv.sum() > 10


@pytest.mark.parametrize("policy", ["replace", "append"])
def test_make_tracker_matches_lk_tpu(grays, policy):
    """Both trackers over the same frames, replenishing often (25 of 30
    slots): the same segments, masks and live counts, every frame."""
    mask = np.array(jtr.donut_mask(H, W, OUTER, INNER))
    kw = dict(features=FEATURES, replenish_below=25, policy=policy)
    run_j, init_j = jtr.make_tracker(jnp.asarray(mask), LKConfig(), **kw)
    j_state, j_out = jax.jit(run_j)(init_j(jnp.asarray(grays[0])),
                                     jnp.asarray(grays[1:]))
    j_state, j_out = jax.device_get((j_state, j_out))
    kw["features"] = port_cfg(FEATURES)
    run_t, init_t = ttr.make_tracker(mask, port_cfg(LKConfig()),
                                     device="cpu", **kw)
    t_state, t_out = run_t(init_t(torch.from_numpy(grays[0])),
                           torch.from_numpy(grays[1:]))
    assert isinstance(t_out, ttr.TrackerOutputs)
    np.testing.assert_array_equal(t_out.seg_mask.numpy(),
                                  np.asarray(j_out.seg_mask))
    np.testing.assert_array_equal(t_out.live.numpy(), np.asarray(j_out.live))
    m = np.asarray(j_out.seg_mask)
    assert m.sum() > 50
    for k in ("old_pts", "new_pts"):
        np.testing.assert_allclose(getattr(t_out, k).numpy()[m],
                                   np.asarray(getattr(j_out, k))[m], rtol=0,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(t_state.valid.numpy(),
                                  np.asarray(j_state.valid))
    v = np.asarray(j_state.valid)
    np.testing.assert_allclose(t_state.pts.numpy()[v],
                               np.asarray(j_state.pts)[v], rtol=0, atol=1e-3)
    # replenishment happened: some frame's live count rose
    assert (np.diff(np.asarray(j_out.live)) > 0).any()


def test_run_tracker_frames_chunks(grays):
    """The host loop: the first frame initializes, the rest go through in
    chunks, every output handed on."""
    mask = ttr.donut_mask(H, W, OUTER, INNER, device="cpu")
    run, init = ttr.make_tracker(mask, port_cfg(LKConfig()),
                                 port_cfg(FEATURES), device="cpu")
    seen = []
    frames = [g[..., None].repeat(3, -1) for g in grays]
    n = ttr.run_tracker_frames(run, init, lambda fb: fb[..., 0], iter(frames),
                               chunk=4, on_outputs=lambda o: seen.append(
                                   o.seg_mask.shape[0]), device="cpu")
    assert n == T and seen == [4, 4]
