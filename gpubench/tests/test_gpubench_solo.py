"""The single-stream cell ``vp860solo.trip1080`` on the CPU: its spec and
configuration, its BGR clip, a tiny run's result line, and its five
readers on a made-up timeline worked out by hand, on a real CPU profile of
the tiny cell and on a trace without its spans.  The check itself
(reference, replay, planted faults, control) is held in
tests/test_torch_vp_solo_check.py."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.drivers import vp_fleet, vp_solo
from gpubench.road_scenes import RoadScenes, drive_zoom
from gpubench.tests._tiny_solo import CELL, tiny_solo_spec
from gpubench.tests.test_gpubench_trace import Event, timeline
from gpubench.tracing import WINDOW, Trace

READERS = ("device_idle_pct.trip", "host_us_per_frame.trip",
           "ingest_wait_pct.trip", "upload_gbps.trip",
           "kernels_per_frame.trip")
MS = 1_000_000


def test_spec_loads():
    spec = harness.load_spec(CELL)
    assert {m["name"] for m in spec.end_to_end} == {"flow_pairs_per_s",
                                                     "setup_s"}
    assert {m["name"] for m in spec.per_layer} == set(READERS)
    assert spec.traffic["driver"] == "vp_solo" and spec.chips == 1


def test_the_configuration_is_the_final_app():
    """Preset final as it stands (out_cap 0), the app's defaults, the
    fleet's step and tracker settings, a 1080p source giving 860x483."""
    from lk_tpu_torch.apps._common import build_parser
    from lk_tpu_torch.models import PRESETS

    config = harness.load_spec(CELL).config
    cfg = vp_fleet.program_config(config)
    assert cfg == PRESETS["final"]
    fleet = harness.load_spec("vp860.fleet64").config
    assert config["pipeline"] == dict(fleet["pipeline"], out_cap=0)
    for key in ("lk", "features", "roi", "height", "width", "src_height",
                "src_width", "precision"):
        assert config[key] == fleet[key]
    args = build_parser("final").parse_args([])
    assert (config["chunk"], config["prefetch"]) == (args.chunk,
                                                     args.prefetch)
    assert (config["streams"], config["drain_every"],
            config["host_preprocess"]) == (1, 16, False)
    assert cfg.derived_height(config["src_height"], config["src_width"]) \
        == config["height"]


def test_the_clip_is_bgr_with_distinct_planes():
    """The clip's planes are the scene's frames under the traffic's gains
    and offsets, so they differ; the zoom is the fleet's drive at 1080p."""
    spec = tiny_solo_spec()
    t, c = spec.traffic, spec.config
    clip = vp_solo.bgr_clip(t, c["src_height"], c["src_width"], 5, "cpu")
    assert clip.shape == (24, 360, 640, 3) and clip.dtype == np.uint8
    gray = RoadScenes(dict(t, streams=1), 360, 640, 5, "cpu").frames(0, 24)
    v = gray[:, 0].numpy().astype(np.float64)
    for ch, (g, o) in enumerate(zip(t["channels"]["gain"],
                                    t["channels"]["offset"])):
        want = np.clip(np.round((v - 127.5) * g + 127.5 + o), 0, 255)
        assert np.array_equal(clip[..., ch], want)
    b, r = clip[..., 0].astype(int), clip[..., 2].astype(int)
    assert (b != r).mean() > 0.9
    full = harness.load_spec(CELL)
    zoom = drive_zoom(full.traffic["scenes"]["drive"],
                      full.config["src_height"], full.config["src_width"])
    assert 1.0574 < zoom < 1.0575


def test_a_tiny_run_is_correct():
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_solo_spec(), seed=2 ** 31 + 3, seconds=0.2,
                           trace=False, device="cpu")
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"flow_pairs_per_s", "setup_s"}
    assert out["metrics"]["flow_pairs_per_s"]["value"] > 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["compared"]["gray_gap"]["value"] < 1e-3
    json.dumps(out, allow_nan=False)


def solo_timeline():
    """A 100 ms window.  Device busy [5, 15] (the upload, HtoD), [20, 40],
    [50, 60]: idle 60 %.  ``video.chunk`` spans [10, 30] and [45, 65],
    ``video.wait`` spans [0, 5] and [40, 44] (and one before the window)."""
    return [
        Event(WINDOW, 0, 100 * MS, False, True),
        Event("video.wait", -10 * MS, 5 * MS, False, True),
        Event("video.wait", 0, 5 * MS, False, True),
        Event("video.chunk", 10 * MS, 20 * MS, False, True),
        Event("video.wait", 40 * MS, 4 * MS, False, True),
        Event("video.chunk", 45 * MS, 20 * MS, False, True),
        Event("Memcpy HtoD (Pageable -> Device)", 5 * MS, 10 * MS, True),
        Event("void at::native::elementwise_kernel<128, 2>", 20 * MS,
              20 * MS, True),
        Event("pyramid_kernel(Params)", 50 * MS, 10 * MS, True),
    ]


def ctx_of(events, units):
    spec = harness.load_spec(CELL)
    return harness.ReaderContext(Trace(events), units, spec.config,
                                 spec.traffic)


UNITS = dict(clips=1, frames=32, uploaded=33, bgr_bytes=2 * 10 ** 8)


def test_readers_by_hand():
    ctx = ctx_of(solo_timeline(), UNITS)
    read = {n: harness.load_reader(n)(ctx) for n in READERS}
    assert read["device_idle_pct.trip"] == pytest.approx(60.0)
    assert read["host_us_per_frame.trip"] == pytest.approx(40e3 / 32)
    assert read["ingest_wait_pct.trip"] == pytest.approx(9.0)
    # 2e8 bytes in the 10 ms copy
    assert read["upload_gbps.trip"] == pytest.approx(20.0)
    assert read["kernels_per_frame.trip"] == pytest.approx(2 / 32)


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_the_spans_reads_nothing(name):
    """A window with kernels and a copy but no ``video.*`` span (a program
    without them) leaves every trip metric out of the line."""
    ctx = ctx_of(timeline(), UNITS)
    assert harness.load_reader(name)(ctx) is None


@pytest.fixture(scope="module")
def profiled():
    """A CPU profile of the tiny cell's traced window (one clip), and its
    context."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.set_num_threads(2)
    spec = tiny_solo_spec()
    cell = harness.make_cell(spec, seed=2 ** 31 + 5, device="cpu")
    cell.setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            cell.traced_window()
    tr = Trace(prof.profiler.kineto_results.events())
    return harness.ReaderContext(tr, cell.units(), spec.config, spec.traffic)


def test_the_spans_reach_the_readers(profiled):
    """The program's ``video.chunk`` and ``video.wait`` spans, recorded on
    the CPU, give the span readers their numbers; the CPU runs no kernel
    and no copy, so the device readers find nothing to read."""
    ctx = profiled
    assert not ctx.trace.device
    read = {n: harness.load_reader(n)(ctx) for n in READERS[1:]}
    window_us = 1e6 * ctx.trace.window_s
    assert 0 < read["host_us_per_frame.trip"] \
        < window_us / ctx.units["frames"]
    assert 0 < read["ingest_wait_pct.trip"] < 100
    assert read["upload_gbps.trip"] is None
    assert read["kernels_per_frame.trip"] is None


def test_the_window_counts_its_work(profiled):
    """The traced window is one whole clip: its 24 frames uploaded, the
    first seeding, 23 tracked and booked."""
    c = tiny_solo_spec().config
    assert profiled.units == dict(
        clips=1, frames=23, uploaded=24,
        bgr_bytes=24 * c["src_height"] * c["src_width"] * 3)


def test_the_parent_program_fails_at_once(monkeypatch):
    """A program whose chunk runner takes no ``frame_hook`` (the parent of
    this cell) fails the set-up before anything is rendered."""
    from lk_tpu_torch.pipeline import runner

    real = runner.make_chunk_runner

    def no_hook(*args):
        run, init_fn, masks = real(*args)
        return (lambda state, frames: run(state, frames)), init_fn, masks

    monkeypatch.setattr(runner, "make_chunk_runner", no_hook)
    monkeypatch.setattr(vp_solo, "bgr_clip", None)
    cell = harness.make_cell(tiny_solo_spec(), 1, "cpu")
    with pytest.raises(RuntimeError, match="frame_hook"):
        cell.setup()
