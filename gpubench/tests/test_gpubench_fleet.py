"""The VP serving cell ``vp860.fleet64`` on the CPU: its spec and
configuration, a tiny run's result line, and its seven readers on a real CPU
profile of the tiny cell and on a trace without its spans.  The check
itself (reference, replay, planted faults, control) is held in
tests/test_torch_vp_check.py."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from gpubench import harness
from gpubench.drivers import vp_fleet
from gpubench.metrics import _work
from gpubench.tests._tiny_fleet import CELL, tiny_fleet_spec
from gpubench.tests.test_gpubench_trace import timeline
from gpubench.tracing import WINDOW, Trace

READERS = ("device_idle_pct.fleet", "host_us_per_frame.fleet",
           "idle_in_chunk_pct.fleet", "finish_roofline.fleet",
           "window_gather_roofline.fleet", "pyr_down_roofline.fleet",
           "kernels_per_frame.fleet")
KERNELS = ("finish_kernel", "window_gather_kernel", "pyramid_kernel")


def test_spec_loads():
    spec = harness.load_spec(CELL)
    assert {m["name"] for m in spec.end_to_end} == {"flow_pairs_per_s",
                                                     "setup_s"}
    assert {m["name"] for m in spec.per_layer} == set(READERS)
    assert spec.traffic["driver"] == "vp_fleet" and spec.chips == 1


def test_the_configuration_is_preset_final():
    from lk_tpu_torch.models import PRESETS

    config = harness.load_spec(CELL).config
    cfg = vp_fleet.program_config(config)
    assert cfg == dataclasses.replace(PRESETS["final"], out_cap=48)
    assert cfg.derived_height(config["src_height"], config["src_width"]) \
        == config["height"]
    assert (config["streams"], config["chunk"], config["drain_every"]) \
        == (64, 16, 16)


def test_a_tiny_run_is_correct():
    torch.set_num_threads(2)
    out = harness.run_cell(tiny_fleet_spec(), seed=2 ** 31 + 3,
                           seconds=0.2, trace=False, device="cpu")
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"flow_pairs_per_s", "setup_s"}
    assert out["metrics"]["flow_pairs_per_s"]["value"] > 0
    assert out["attempted"] > 0 and out["failed"] == 0
    json.dumps(out, allow_nan=False)


@pytest.fixture(scope="module")
def profiled():
    """A CPU profile of the tiny cell's traced window, and its context."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.set_num_threads(2)
    spec = tiny_fleet_spec()
    cell = harness.make_cell(spec, seed=2 ** 31 + 5, device="cpu")
    cell.setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            cell.traced_window()
    tr = Trace(prof.profiler.kineto_results.events())
    return harness.ReaderContext(tr, cell.units(), spec.config, spec.traffic)


def test_the_spans_reach_the_readers(profiled):
    """The program's ``serve.chunk`` spans, recorded on the CPU, give the
    span readers their numbers; the CPU runs no kernel, so the device is
    idle inside every span and the rooflines and the launch count find
    nothing to read."""
    ctx = profiled
    assert not ctx.trace.device
    read = {n: harness.load_reader(n)(ctx) for n in READERS[1:]}
    assert 0 < read["idle_in_chunk_pct.fleet"] < 100
    assert 0 < read["host_us_per_frame.fleet"] \
        < 1e6 * ctx.trace.window_s / ctx.units["stream_frames"]
    for n in READERS[3:]:
        assert read[n] is None


def test_every_reader_prints_with_the_kernels(profiled):
    """The same profile with one device operation of each kernel (1 ms
    each): every reader prints, each share its least time over 1 ms."""
    ctx = profiled
    tr = ctx.trace
    saved = list(tr.device)
    ms = 1_000_000
    tr.device = [(tr.t0 + (2 * i + 1) * ms, tr.t0 + (2 * i + 2) * ms,
                  f"void {k}(Params)", "kernel")
                 for i, k in enumerate(KERNELS)]
    try:
        read = {n: harness.load_reader(n)(ctx) for n in READERS}
    finally:
        tr.device = saved
    assert all(v is not None for v in read.values()), read
    assert read["device_idle_pct.fleet"] == pytest.approx(
        100 * (1 - 3e-3 / tr.window_s))
    u, c = ctx.units, ctx.config
    h, w = c["height"], c["width"]
    finish = _work.finish_bound(u["finish_frames"], h, w)[0]
    gather = u["frame_steps"] * 3 * _work.gather_bound(u["points"], 15, 15,
                                                       32, 48)[0]
    pyramid = u["pyramid_builds"] * _work.pyramid_bound(
        u["streams"], (h, w), (h, w), 2)[0]
    assert read["finish_roofline.fleet"] == pytest.approx(1e5 * finish)
    assert read["window_gather_roofline.fleet"] == pytest.approx(1e5 * gather)
    assert read["pyr_down_roofline.fleet"] == pytest.approx(1e5 * pyramid)
    assert read["kernels_per_frame.fleet"] == pytest.approx(
        3 / u["stream_frames"])


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_the_spans_reads_nothing(name):
    """A window with kernels but no ``serve.chunk`` span (a program without
    it) leaves every fleet metric out of the line."""
    spec = harness.load_spec(CELL)
    ctx = harness.ReaderContext(
        Trace(timeline()), dict(chunks=1, stream_frames=64, frame_steps=1,
                                finish_frames=64, pyramid_builds=2,
                                streams=64, points=1280),
        spec.config, spec.traffic)
    assert harness.load_reader(name)(ctx) is None


def test_the_window_counts_its_work():
    """The units of a tiny window: chunks of 4 streams, one finish per
    chunk and per trip start, one pyramid per chunk and frame."""
    torch.set_num_threads(2)
    spec = tiny_fleet_spec()
    cell = harness.make_cell(spec, seed=7, device="cpu")
    cell.setup()
    cell.traced_window()
    u = cell.units()
    # a 20-frame trip: its first frame, then chunks of 12 and 7 frames
    assert u == dict(chunks=2, stream_frames=76, frame_steps=19,
                     finish_frames=80, pyramid_builds=21, streams=4,
                     points=80)
