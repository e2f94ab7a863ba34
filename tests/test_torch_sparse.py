"""The batched sparse tracker and Shi–Tomasi corners: lk_tpu_torch against
lk_tpu on the same numpy inputs (CPU; lk_tpu's Pallas gathers in interpret
mode).

Tolerances, and why:
* window gather: exact against lk_tpu's XLA path (full-frame Scharr, then
  crops), which the plain version repeats operation by operation.  Against
  the Pallas gathers the intensities and superwindows are exact and the
  Scharr planes agree to one ulp at 256 (3.1e-5): in interpret mode the
  kernel body is jitted and XLA on the CPU contracts its smoothing
  products into FMAs;
* fold: level 0 exact (a pure re-indexing); coarser levels <= 1e-3 on
  0..255 data, because lk_tpu's exact pyr_down takes its column pass as a
  matmul (another summation order, REFLECT_101 taps folded into one
  weight) where the port adds the five taps in order;
* tracker: <= 1e-4 px and the same status — the window sums are
  reductions whose order differs between XLA and PyTorch, and XLA on the
  CPU contracts products into FMAs;
* Shi–Tomasi response: <= 1e-5 relative (PyTorch's CPU sqrt is not always
  correctly rounded); corner selection from one response map: exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lk_tpu.config import FeatureConfig, LKConfig
from lk_tpu.features import shi_tomasi as jst
from lk_tpu.flow import sparse as js
from lk_tpu_torch.features import shi_tomasi as tst
from lk_tpu_torch.flow import sparse as ts
from torch_parity import interpret_pallas, port_cfg

B, N, H, W = 3, 8, 96, 160
CFG = LKConfig()
TCFG = port_cfg(CFG)
ROW_BAND = (20, 70)


@pytest.fixture(scope="module")
def pair():
    """B textured frames and their (1.7, -1.2) px shifted successors."""
    import cv2 as cv

    rng = np.random.default_rng(7)
    prev = (rng.random((B, H, W)) * 255).astype(np.float32)
    for i in range(B):
        prev[i] = cv.GaussianBlur(prev[i], (0, 0), 1.5)
    m = np.float32([[1, 0, 1.7], [0, 1, -1.2]])
    nxt = np.stack([cv.warpAffine(prev[i], m, (W, H), flags=cv.INTER_LINEAR,
                                  borderMode=cv.BORDER_REFLECT_101)
                    for i in range(B)])
    pts = np.stack([rng.uniform(20, W - 20, (B, N)),
                    rng.uniform(24, 66, (B, N))], -1).astype(np.float32)
    valid = rng.random((B, N)) < 0.9
    return prev, nxt, pts, valid


def _corners(pts, level, h, w, b):
    """The tracker's corners at ``level`` for points at their own position
    (sparse.py:545-569, no row band): prev (cy, cx), superwindow (sy, sx)
    with sy absolute, as _gather_windows_pallas takes them."""
    win_w, win_h = CFG.win_size
    pad = max(CFG.win_size) + 2
    fph, fpw = h + 2 * pad, w + 2 * pad
    sw_h, sw_w = min(32, fph), min(48, fpw)
    p = pts.reshape(-1, 2) / np.float32(2 ** level)
    base_y = np.repeat(np.arange(b), pts.shape[1]) * (fph + 2) + 1
    ix = np.floor(p[:, 0] - 7).astype(np.int32)
    iy = np.floor(p[:, 1] - 7).astype(np.int32)
    cx = np.clip(ix + pad, 0, fpw - win_w - 1)
    cy = np.clip(iy + pad, 0, fph - win_h - 1) + base_y
    sy = np.clip(iy + pad - (sw_h - win_h - 1) // 2, 0, fph - sw_h) + base_y
    sx = np.clip(ix + 1 + pad - (sw_w - win_w - 1) // 2, 0, fpw - sw_w)
    return [a.astype(np.int32) for a in (cy, cx, sy, sx)], (sw_h, sw_w), fph


@pytest.mark.parametrize("frame_major", [True, False])
@pytest.mark.parametrize("level", [0, 2])
def test_gather_matches_pallas(monkeypatch, pair, level, frame_major):
    """Plain gather vs _gather_windows_pallas with frame_info (the band
    gather, frame-major points) and without (the point gather, shuffled
    points)."""
    interpret_pallas(monkeypatch)
    prev, nxt, pts, _ = pair
    pf = js.fold_tracking_levels(jnp.asarray(prev), CFG)[level]
    nf = js.fold_tracking_levels(jnp.asarray(nxt), CFG)[level]
    h, w = -(-H // 2 ** level), -(-W // 2 ** level)
    (cy, cx, sy, sx), (sw_h, sw_w), fph = _corners(pts, level, h, w, B)
    if not frame_major:
        perm = np.random.default_rng(3).permutation(cy.shape[0])
        cy, cx, sy, sx = (a[perm] for a in (cy, cx, sy, sx))
    raw_j, sw_j = js._gather_windows_pallas(
        pf, nf, jnp.asarray(cy), jnp.asarray(cx), jnp.asarray(sy),
        jnp.asarray(sx), 15, 15, sw_h, sw_w,
        frame_info=(B, fph + 2) if frame_major else None)
    raw_t, sw_t = ts.gather_windows(
        torch.from_numpy(np.array(pf)), torch.from_numpy(np.array(nf)),
        *(torch.from_numpy(a) for a in (cy, cx, sy, sx)), 15, 15, sw_h, sw_w)
    raw_j = np.asarray(raw_j)
    np.testing.assert_array_equal(raw_t.numpy()[:, 0], raw_j[:, 0])
    np.testing.assert_allclose(raw_t.numpy()[:, 1:], raw_j[:, 1:], rtol=0,
                               atol=3.1e-5)
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gather_matches_xla_path(pair, level):
    """Exact against lk_tpu's pallas_windows=False gather: full-frame
    scharr_derivatives of the folded level (op by op), then the crops."""
    from lk_tpu.ops.gradients import scharr_derivatives

    prev, nxt, pts, _ = pair
    pf = np.asarray(js.fold_tracking_levels(jnp.asarray(prev), CFG)[level])
    nf = np.asarray(js.fold_tracking_levels(jnp.asarray(nxt), CFG)[level])
    h, w = -(-H // 2 ** level), -(-W // 2 ** level)
    (cy, cx, sy, sx), (sw_h, sw_w), _ = _corners(pts, level, h, w, B)
    ix, iy = scharr_derivatives(jnp.asarray(pf))
    stack3 = np.stack([pf, np.asarray(ix), np.asarray(iy)])
    raw_t, sw_t = ts.gather_windows(
        torch.from_numpy(pf.copy()), torch.from_numpy(nf.copy()),
        *(torch.from_numpy(a) for a in (cy, cx, sy, sx)), 15, 15, sw_h, sw_w)
    for k in range(cy.shape[0]):
        np.testing.assert_array_equal(
            raw_t[k].numpy(), stack3[:, cy[k]:cy[k] + 16, cx[k]:cx[k] + 16])
        np.testing.assert_array_equal(
            sw_t[k].numpy(), nf[sy[k]:sy[k] + sw_h, sx[k]:sx[k] + sw_w])


def test_gather_clamps_corners_as_dynamic_slice(pair):
    """Out-of-range corners clamp into the array (dynamic_slice's rule)."""
    prev, nxt, _, _ = pair
    pf = torch.from_numpy(prev[0])
    nf = torch.from_numpy(nxt[0])
    c = torch.tensor([-5, 0, H - 3, 10 ** 6])
    raw, sw = ts.gather_windows(pf, nf, c, c, c, c, 15, 15, 32, 48)
    assert raw.shape == (4, 3, 16, 16) and sw.shape == (4, 32, 48)
    assert torch.equal(raw[0, 0], pf[:16, :16])
    assert torch.equal(raw[3, 0], pf[-16:, -16:])
    assert torch.equal(sw[2], nf[H - 32:, H - 3:H - 3 + 48])


@pytest.mark.parametrize("row_band", [None, ROW_BAND])
def test_fold_matches_lk_tpu(pair, row_band):
    prev = pair[0]
    want = js.fold_tracking_levels(jnp.asarray(prev), CFG, row_band=row_band)
    got = ts.fold_tracking_levels(torch.from_numpy(prev), TCFG,
                                  row_band=row_band)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("row_band", [None, ROW_BAND])
def test_fold_layout_exact(pair, row_band):
    """The fold itself is exact: each frame's level reflect-padded (one
    guard row per seam) and stacked, or the band's rows taken from the
    frame, as numpy lays it out from the port's own pyramid."""
    from lk_tpu_torch.ops.blur import pyr_down

    prev = torch.from_numpy(pair[0])
    got = ts.fold_tracking_levels(prev, TCFG, row_band=row_band)
    pad = 17
    bands = ts._level_row_bands(H, TCFG, row_band)
    lv = prev
    for level in range(3):
        x = lv.numpy()
        bd = bands[level]
        if bd is not None and bd[0] >= pad + 1 and bd[1] + pad + 1 <= x.shape[1]:
            x = np.pad(x[:, bd[0] - pad - 1:bd[1] + pad + 1],
                       ((0, 0), (0, 0), (pad, pad)), mode="reflect")
        else:
            if bd is not None:
                x = x[:, bd[0]:bd[1]]
            x = np.pad(x, ((0, 0), (pad + 1, pad + 1), (pad, pad)),
                       mode="reflect")
        np.testing.assert_array_equal(got[level].numpy(),
                                      x.reshape(-1, x.shape[-1]))
        lv = pyr_down(lv)


@pytest.mark.parametrize("row_band", [None, ROW_BAND])
def test_tracker_matches_lk_tpu(pair, row_band):
    """track_points_batched_prepped (lk_tpu's XLA gather path): <= 1e-4 px,
    the same status, err <= 1e-4; next's fold is returned for the carry."""
    prev, nxt, pts, valid = pair
    pj = js.fold_tracking_levels(jnp.asarray(prev), CFG, row_band=row_band)
    p1j, stj, errj, _ = js.track_points_batched_prepped(
        pj, jnp.asarray(nxt), jnp.asarray(pts), jnp.asarray(valid), CFG,
        row_band=row_band)
    pt = ts.fold_tracking_levels(torch.from_numpy(prev), TCFG,
                                 row_band=row_band)
    p1, st, err, nf = ts.track_points_batched_prepped(
        pt, torch.from_numpy(nxt), torch.from_numpy(pts),
        torch.from_numpy(valid), TCFG, row_band=row_band)
    np.testing.assert_array_equal(st.numpy(), np.asarray(stj))
    assert st.numpy().sum() >= 0.7 * valid.sum()
    np.testing.assert_allclose(p1.numpy(), np.asarray(p1j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(err.numpy(), np.asarray(errj), rtol=0,
                               atol=1e-4)
    # tracked the (1.7, -1.2) shift
    d = (p1.numpy() - pts)[st.numpy()]
    np.testing.assert_allclose(d.mean(0), [1.7, -1.2], atol=0.05)
    for a, b in zip(nf, ts.fold_tracking_levels(torch.from_numpy(nxt), TCFG,
                                                row_band=row_band)):
        assert torch.equal(a, b)


def test_tracker_wrapper_equals_prepped(pair):
    prev, nxt, pts, valid = pair
    args = [torch.from_numpy(a) for a in (prev, nxt, pts, valid)]
    a = ts.track_points_batched(*args, TCFG)
    b = ts.track_points_batched_prepped(
        ts.fold_tracking_levels(args[0], TCFG), *args[1:], TCFG)[:3]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tracker_uses_plain_gather_on_cpu(pair):
    prev, nxt, pts, valid = pair
    ts.reset_counters()
    ts.track_points_batched(*(torch.from_numpy(a)
                              for a in (prev, nxt, pts, valid)), TCFG)
    assert (ts.plain_calls, ts.kernel_launches) == (CFG.max_level + 1, 0)


@pytest.mark.parametrize("h0,band", [(483, (260, 420)), (242, (130, 210)),
                                     (242, None), (96, (0, 96))])
def test_level_row_bands(h0, band):
    assert ts._level_row_bands(h0, TCFG, band) == js._level_row_bands(
        h0, CFG, band)


@pytest.fixture(scope="module")
def scene():
    from lk_tpu.io.video import SyntheticRoadStream

    s = SyntheticRoadStream(width=200, height=120, seed=5, color=False)
    return s.frame(0).astype(np.float32), s.frame(3).astype(np.float32)


@pytest.mark.parametrize("block", [3, 7])
def test_min_eig_response(scene, block):
    img = np.stack(scene)
    want = np.asarray(jst.min_eig_response(jnp.asarray(img), block))
    got = tst.min_eig_response(torch.from_numpy(img), block).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cfg", [FeatureConfig(),
                                 FeatureConfig(max_corners=20,
                                               quality_level=0.05,
                                               min_distance=5.0)])
def test_good_features_from_response(scene, cfg):
    """Exact: the same response map, masks and greedy rule; the port
    selects for a batch of (frame, mask) pairs at once."""
    resp = np.asarray(jst.min_eig_response(jnp.asarray(scene[0]), 7))
    h, w = resp.shape
    masks = np.zeros((3, h, w), np.float32)
    masks[0, 40:100, 20:120] = 1
    masks[1, 60:, 100:] = 1
    masks[2] = 1
    got_xy, got_v = tst.good_features_from_response(
        torch.from_numpy(resp)[None], torch.from_numpy(masks),
        port_cfg(cfg))
    for m in range(3):
        xy, v = jst.good_features_from_response(
            jnp.asarray(resp), jnp.asarray(masks[m]), cfg)
        np.testing.assert_array_equal(got_v[m].numpy(), np.asarray(v))
        np.testing.assert_array_equal(got_xy[m].numpy(), np.asarray(xy))
    xy, v = jst.good_features_from_response(jnp.asarray(resp), None, cfg)
    txy, tv = tst.good_features_from_response(torch.from_numpy(resp), None,
                                              port_cfg(cfg))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(xy))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))


def test_lkconfig_flags_ignored(pair):
    """pallas_windows / fast_pyramid select TPU kernels or TPU precision
    trades in lk_tpu; the port accepts them and computes the same."""
    prev, nxt, pts, valid = pair
    args = [torch.from_numpy(a) for a in (prev, nxt, pts, valid)]
    a = ts.track_points_batched(*args, TCFG)
    b = ts.track_points_batched(*args, dataclasses.replace(
        TCFG, pallas_windows=True, fast_pyramid=True))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
