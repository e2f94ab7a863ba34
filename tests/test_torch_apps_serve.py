"""The serving app on the CPU: lk_tpu_torch.apps.serve's ``run_server``
against lk_tpu's MultiStreamPipeline fed as lk_tpu.apps.serve feeds it,
its modes against each other, and its device staging against lk_tpu's cv2
staging.  serve runs here at the preset width 430 (lk_tpu's presets
copied with width=430), so a 430x242 source is not resized.

Tolerances, and why: the same staged u8 frames give rows within 1e-3 px
of lk_tpu's (tests/test_torch_video_pipeline.py's reason: sums taken in
another order).  --async-drains, --live-ingest and --stage-window feed the
port the same frames as the default pass: the same rows exactly.  The
port's device staging (gray, f32 INTER_AREA, rounded) against lk_tpu's
cv2 staging (cvtColor, u8 INTER_AREA) of the same BGR frames: <= 1 u8
level on <= 0.1 % of the pixels (OpenCV's u8 resize rounds its own
fixed-point sums; measured: equal at 430x242 -> 320x180, max 1 level on
0.003 % at serve's default 1280x720 -> 860x483).  The rows that staging
gives: scripts/torch_staging_vs_cv2.py (PERF.md)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lk_tpu.io.video import SyntheticRoadStream
from torch_parity import port_cfg

W, H = 430, 242


def _serve_args(tm, *extra, streams=3, frames=13, width=W, height=H):
    return tm.build_parser().parse_args(
        ["--streams", str(streams), "--frames", str(frames), "--chunk", "6",
         "--width", str(width), "--height", str(height), "--quiet",
         *extra])


@pytest.fixture
def serve_small(monkeypatch):
    """serve at the preset width W (a W x H source is not resized)."""
    from lk_tpu.models import PRESETS as JP
    from lk_tpu_torch.apps import serve as tm

    presets = {k: port_cfg(dataclasses.replace(v, width=W))
               for k, v in JP.items()}
    monkeypatch.setattr(tm, "PRESETS", presets)
    return tm


def _cv2_staging(scenes, n, h, w):
    import cv2 as cv

    u8 = np.empty((n, len(scenes), h, w), np.uint8)
    for b, sc in enumerate(scenes):
        for t in range(n):
            g = cv.cvtColor(sc.frame(t), cv.COLOR_BGR2GRAY)
            u8[t, b] = cv.resize(g, (w, h), interpolation=cv.INTER_AREA)
    return u8


def _rows(server):
    return [np.array(p.csv_rows, np.float64).reshape(-1, 2)
            for p in server.pipes]


def test_serve_matches_lk_tpu(serve_small, monkeypatch):
    """The same staged frames through the port's run_server and lk_tpu's
    MultiStreamPipeline (as lk_tpu.apps.serve feeds it)."""
    from lk_tpu.apps import serve as jserve
    from lk_tpu.models import PRESETS as JP
    from lk_tpu.pipeline.runner import MultiStreamPipeline

    tm = serve_small
    args = _serve_args(tm)
    scenes = [SyntheticRoadStream(width=W, height=H, n_frames=13, seed=s,
                                  vp=(W * (0.45 + 0.01 * s), H * 0.45))
              for s in range(3)]
    u8 = _cv2_staging(scenes, 13, H, W)
    monkeypatch.setattr(tm, "stage",
                        lambda sc, n, h, w: torch.from_numpy(u8))
    run = tm.run_server(args, device="cpu")
    assert run.agg > 0 and run.server.frames_done == 3 * 12
    cfg = dataclasses.replace(JP["final"], width=W, out_cap=48)
    ref = MultiStreamPipeline(cfg, src_size=(W, H), n_streams=3, chunk=6)
    jserve._feed_all(ref, jnp.asarray(u8), args)
    ref.drain()
    for a, b in zip(_rows(run.server), _rows(ref)):
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_serve_modes_agree(serve_small):
    """--async-drains, --live-ingest and --stage-window feed the same
    frames as the default pre-staged pass: the same rows exactly;
    --device-preprocess resizes unrounded f32 on the device (its own
    rows), every stream with VP output."""
    tm = serve_small
    base = _rows(tm.run_server(_serve_args(tm, frames=9),
                               device="cpu").server)
    assert all(len(r) for r in base)
    for flags in (["--async-drains"], ["--live-ingest"],
                  ["--stage-window", "5"]):
        run = tm.run_server(_serve_args(tm, *flags, frames=9), device="cpu")
        got = _rows(run.server)
        assert all(np.array_equal(a, b) for a, b in zip(got, base)), flags
        assert (run.decode_busy_s is not None) == ("--live-ingest" in flags)
    run = tm.run_server(_serve_args(tm, "--device-preprocess", frames=9,
                                    width=640, height=360), device="cpu")
    assert (run.server.width, run.server.height) == (W, 241)
    assert all(len(r) for r in _rows(run.server))


@pytest.mark.parametrize("geometry", [(430, 242, 320, 180),
                                      (1280, 720, 860, 483)])
def test_serve_staging_vs_cv2(serve_small, geometry):
    """The port's staging against cv2's of the same frames, at a small
    resize and at serve's default geometry."""
    tm = serve_small
    sw, sh, w, h = geometry
    args = _serve_args(tm, streams=2, frames=3, width=sw, height=sh)
    scenes = tm.scenes_of(args, "cpu")
    ours = tm.stage(scenes, 3, h, w).numpy()
    ref = _cv2_staging([_Bgr(s) for s in scenes], 3, h, w)
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_serve_main_prints(serve_small, capsys):
    tm = serve_small
    assert tm.main(["--streams", "2", "--frames", "7", "--chunk", "6",
                    "--width", str(W), "--height", str(H), "--quiet"],
                   device="cpu") > 0
    out = capsys.readouterr().out
    assert "" == out                     # --quiet
    assert tm.main(["--streams", "2", "--frames", "7", "--chunk", "6",
                    "--width", str(W), "--height", str(H)],
                   device="cpu") > 0
    out = capsys.readouterr().out
    assert "aggregate:" in out and "streams with VP output: 2/2" in out


class _Bgr:
    """A gray port scene as the BGR frames cv2 staging reads."""

    def __init__(self, scene):
        self.scene = scene

    def frame(self, t):
        g = self.scene.frame(t)
        return np.repeat(g[..., None], 3, axis=-1)
