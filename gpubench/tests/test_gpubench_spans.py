"""The readers of the program's spans (``metrics/_spans.py``): on made-up
timelines whose values are worked out by hand, on a trace without the
spans (a program that opens none), and on a real CPU profile of a tiny
cell."""

from __future__ import annotations

import pytest
import torch

from gpubench import harness
from gpubench.tests.test_gpubench_trace import Event, timeline
from gpubench.tracing import WINDOW, Trace

MS = 1_000_000
NEW = ("host_us_per_pair.video", "idle_in_chunk_pct.video",
       "host_us_p95.pair", "idle_in_program_pct.pair")


def video_timeline():
    """Two calls.  Device busy [5, 12], [15, 30], [38, 60], [70, 80]: idle
    [0, 5], [12, 15], [30, 38], [60, 70], [80, 100].  The ``dense.chunk``
    spans are [3, 20] and [56, 86]: [0, 5] and [80, 100] are idle gaps only
    partly inside one; the tail and the copy lie outside them."""
    return [
        Event(WINDOW, 0, 100 * MS, False, True),
        Event("bench.video_call", 0, 50 * MS, False, True),
        Event("bench.video_call", 50 * MS, 50 * MS, False, True),
        Event("dense.video", 2 * MS, 38 * MS, False, True),
        Event("dense.chunk", 3 * MS, 17 * MS, False, True),
        Event("dense.tail", 20 * MS, 16 * MS, False, True),
        Event("dense.cat", 36 * MS, 4 * MS, False, True),
        Event("dense.video", 55 * MS, 40 * MS, False, True),
        Event("dense.chunk", 56 * MS, 30 * MS, False, True),
        Event("void fused_lk_level_kernel<3>", 5 * MS, 7 * MS, True),
        Event("pyramid_kernel(Params)", 15 * MS, 15 * MS, True),
        Event("Memcpy DtoD (Device -> Device)", 38 * MS, 22 * MS, True),
        Event("CatArrayBatchedCopy", 70 * MS, 10 * MS, True),
    ]


def pair_timeline():
    """Twenty requests of 1..20 ms in a 500 ms window, one more before it;
    the device busy [0, 10], inside the first request's span [0, 1]."""
    events = [Event(WINDOW, 0, 500 * MS, False, True),
              Event("dense.pair", -10 * MS, 5 * MS, False, True),
              Event("void fused_lk_level_kernel<3>", 0, 10 * MS, True)]
    for i in range(20):
        events.append(Event("dense.pair", 25 * i * MS, (i + 1) * MS, False,
                            True))
    return events


def ctx_of(cell, events, units):
    spec = harness.load_spec(cell)
    return harness.ReaderContext(Trace(events), units, spec.config,
                                 spec.traffic)


def test_video_readers_by_hand():
    ctx = ctx_of("dense1080.video", video_timeline(),
                 {"calls": 2, "pairs": 66, "frames": 68})
    # idle inside dense.chunk: [3, 5] + [12, 15] + [60, 70] + [80, 86]
    # = 21 of 100 ms; idle over all 46
    assert harness.load_reader("idle_in_chunk_pct.video")(ctx) == \
        pytest.approx(21.0)
    assert harness.load_reader("device_idle_pct.video")(ctx) == \
        pytest.approx(46.0)
    # (38 + 40) ms over 66 pairs
    assert harness.load_reader("host_us_per_pair.video")(ctx) == \
        pytest.approx(78_000 / 66)


def test_pair_readers_by_hand():
    ctx = ctx_of("dense1080.pair", pair_timeline(),
                 {"pairs": 20, "requests": 20})
    # the span before the window is left out: p95 of 1..20 ms (linear)
    assert harness.load_reader("host_us_p95.pair")(ctx) == \
        pytest.approx(19_050.0)
    # spans cover 210 ms, 1 ms of it busy
    assert harness.load_reader("idle_in_program_pct.pair")(ctx) == \
        pytest.approx(100 * 209 / 500)


@pytest.mark.parametrize("name", NEW)
def test_a_trace_without_the_spans_reads_nothing(name):
    """The program before its spans: the metric is left out of the line
    (the harness drops None), never read as 0."""
    ctx = ctx_of("dense1080.video", timeline(),
                 {"calls": 1, "pairs": 2, "frames": 3, "requests": 2})
    assert harness.load_reader(name)(ctx) is None


@pytest.mark.parametrize("cell, names, hw", [
    ("dense1080.video", NEW[:2], (128, 1024)),
    ("dense1080.pair", NEW[2:], (64, 128))])
def test_readers_on_a_cpu_profile_of_a_tiny_cell(cell, names, hw):
    """The program's own spans, recorded by the profiler on the CPU,
    reach the readers: every ``program_span`` metric the cell lists is in
    its line, as the harness builds it (a reader's None leaves it out).
    With no device operation every span is idle.  The video's frames are
    the smallest the chunked driver takes (a level plan exists)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench.tests._tiny import tiny_spec

    torch.set_num_threads(2)
    spec = tiny_spec(cell, dense_hw=hw)
    c = harness.make_cell(spec, seed=2 ** 31 + 5, device="cpu")
    c.setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            c.traced_window()
    tr = Trace(prof.profiler.kineto_results.events())
    assert not tr.device
    ctx = harness.ReaderContext(tr, c.units(), spec.config, spec.traffic)
    line = {}
    for m in spec.per_layer:
        if m["source"] == "program_span" and cell in m["workloads"]:
            value = harness.load_reader(m["name"])(ctx)
            if value is not None:
                line[m["name"]] = value
    assert sorted(line) == sorted(names)
    host, idle = (line[n] for n in names)
    assert 0 < idle < 100
    assert 0 < host < 1e6 * tr.window_s
