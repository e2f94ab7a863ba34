"""The apps end to end on the CPU: lk_tpu_torch.apps' ``main`` (and the
tracker apps' compute functions, serve's ``run_server``) against
lk_tpu.apps' on the same frames.

The frames are injected through ``open_frames`` on both sides: lk_tpu's
SyntheticRoadStream (cv2) at 430x242, so that both packages see the same
bytes (the port's own stream differs from it on rare pixels by one level,
tests/test_torch_io_video.py).

Tolerances, and why (tests/test_torch_video_pipeline.py's): both sides
take the same decisions, but window sums, coarse pyramid levels and VP
ring sums are taken in another order, so positions differ in their last
bits: csv rows, motion rows and segments <= 1e-3 px with the same row
counts.  roadlines' lengths are rounded to 0.01 px before they are
recorded, so a 1e-3 px difference may move one by a rounding step: <=
0.011 px; angles <= 1e-2 degrees; its Hough peaks in the same theta bins,
theta and rho within 2e-2.  serve: tests/test_torch_apps_serve.py."""

import csv
import os

import numpy as np
import pytest

from lk_tpu.apps import _common as j_common
from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu_torch.apps import _common as t_common

W, H, F = 430, 242, 17


def _scene(seed=4, n=F):
    return SyntheticRoadStream(width=W, height=H, n_frames=n, zoom=1.03,
                               seed=seed, vp=(W * 0.47, H * 0.44))


@pytest.fixture
def inject(monkeypatch):
    """Both packages' open_frames return the same lk_tpu stream (the apps
    import it by name from _common, so each app module is patched too)."""
    scene = _scene()

    def patch(app):
        import importlib

        jm = importlib.import_module(f"lk_tpu.apps.{app}")
        monkeypatch.setattr(j_common, "open_frames", lambda args: scene)
        if hasattr(jm, "open_frames"):
            monkeypatch.setattr(jm, "open_frames", lambda args: scene)
        monkeypatch.setattr(t_common, "open_frames",
                            lambda args, device="cuda": scene)
        return jm, importlib.import_module(f"lk_tpu_torch.apps.{app}")

    return patch


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], np.float64)


@pytest.mark.parametrize("app", ["final", "vp_detect", "classify"])
def test_vp_app_matches_lk_tpu(app, inject, tmp_path):
    jm, tm = inject(app)
    argv = ["--synthetic", "--frames", str(F), "--chunk", "8", "--quiet"]
    extra = {}
    for side in ("j", "t"):
        extra[side] = ["--out-dir", str(tmp_path / side)]
        if app == "classify":
            extra[side] += ["--motion-csv", str(tmp_path / f"{side}.csv")]
    j = jm.main(argv + extra["j"])
    t = tm.main(argv + extra["t"], device="cpu")
    assert t.device.type == "cpu"
    assert t.frames_done == j.frames_done == F - 1
    assert len(t.csv_rows) == len(j.csv_rows) > 3
    np.testing.assert_allclose(np.array(t.csv_rows), np.array(j.csv_rows),
                               rtol=0, atol=1e-3)
    assert [v is None for v in t.vp_per_frame] == [
        v is None for v in j.vp_per_frame]
    hj, rj = _read_csv(tmp_path / "j" / "vps_synthetic.csv")
    ht, rt = _read_csv(tmp_path / "t" / "vps_synthetic.csv")
    assert ht == hj == ["x", "y"] and rt.shape == rj.shape
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-3)
    if app == "classify":
        hj, mj = _read_csv(tmp_path / "j.csv")
        ht, mt = _read_csv(tmp_path / "t.csv")
        assert ht == hj == ["static", "away", "toward", "lateral"]
        assert mt.shape == mj.shape == (F - 1, 4)
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-3)


def _spy(monkeypatch, module):
    """Record what ``module.compute`` (the compute part main calls)
    returns."""
    seen = []
    orig = module.compute

    def spy(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "compute", spy)
    return seen


def test_masking_matches_lk_tpu(inject, tmp_path, monkeypatch):
    jm, tm = inject("masking")
    seen = _spy(monkeypatch, tm)
    argv = ["--synthetic", "--frames", "13", "--chunk", "6", "--quiet"]
    j = jm.main(argv + ["--tracks-png", str(tmp_path / "j.png")])
    t = tm.main(argv + ["--tracks-png", str(tmp_path / "t.png")],
                device="cpu")
    assert len(t) == len(j) > 50
    np.testing.assert_allclose(np.array(t, np.float64),
                               np.array(j, np.float64), rtol=0, atol=1e-3)
    assert os.path.getsize(tmp_path / "t.png") > 0
    (res,) = seen
    assert res.segments is t and res.frames == 13
    assert (res.width, res.height) == (960, int(H * 960 / W))


def test_roadlines_matches_lk_tpu(inject, tmp_path, monkeypatch):
    jm, tm = inject("roadlines")
    seen = _spy(monkeypatch, tm)
    argv = ["--synthetic", "--frames", "13", "--chunk", "6", "--quiet"]
    png = {s: ["--dist-png", str(tmp_path / f"{s}d.png"), "--freq-png",
               str(tmp_path / f"{s}f.png"), "--hough-png",
               str(tmp_path / f"{s}h.png")] for s in "jt"}
    jl, ja, jh = jm.main(argv + png["j"])
    tl, ta, th = tm.main(argv + png["t"], device="cpu")
    assert len(tl) == len(jl) > 20
    np.testing.assert_allclose(tl, jl, rtol=0, atol=0.011)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-2)
    n_theta, n_rho = jh.accumulator.shape
    for a, b in ((th.theta.numpy(), np.asarray(jh.theta)),
                 (th.rho.numpy(), np.asarray(jh.rho))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(
        np.round(th.theta.numpy() / np.pi * n_theta) % n_theta,
        np.round(np.asarray(jh.theta) / np.pi * n_theta) % n_theta)
    assert all(os.path.getsize(p) > 0 for p in png["t"][1::2])
    (res,) = seen
    assert res.lengths is tl and res.hough is th and res.frames == 13
    assert res.start.shape == res.stop.shape == (len(tl), 2)
    assert res.start.dtype == np.float32


def test_vp_app_file_source_and_artifacts(tmp_path, monkeypatch):
    """vp_detect on a video file (decoded by the port's VideoReader): its
    default overlay video, the figures, the segments pickle and a
    checkpoint that vp_detect resumes from and final refuses; the csv is
    named after the file."""
    import cv2 as cv

    from lk_tpu_torch.apps import final, vp_detect
    from lk_tpu_torch.io.sink import read_object

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "clip.avi")
    out = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"MJPG"), 30, (W, H))
    scene = _scene(n=9)
    for t in range(9):
        out.write(scene.frame(t))
    out.release()
    pipe = vp_detect.main(
        [path, "--chunk", "4", "--quiet", "--plot-vp", "vp.png",
         "--all-lines-png", "lines.png", "--stats-png", "stats.png",
         "--save-segments", "segs.pkl", "--checkpoint", "ck.npz"],
        device="cpu")
    assert pipe.frames_done == 8
    for f in ("vps/vps_clip.csv", "saved_video/clip.avi", "vp.png",
              "lines.png", "stats.png", "segs.pkl", "ck.npz"):
        assert os.path.getsize(tmp_path / f) > 0, f
    assert len(read_object("segs.pkl")) == len(pipe.segments)
    cap = cv.VideoCapture("saved_video/clip.avi")
    assert int(cap.get(cv.CAP_PROP_FRAME_COUNT)) == 9
    cap.release()
    more = vp_detect.main([path, "--chunk", "4", "--quiet", "--resume",
                           "ck.npz", "--out-dir", "resumed"], device="cpu")
    assert more.frames_done == 9 and not more.consumed_init_frame
    with pytest.raises(ValueError, match="identity mismatch"):
        final.main([path, "--chunk", "4", "--quiet", "--resume", "ck.npz",
                    "--out-dir", "other"], device="cpu")
