"""The trace's reduction and the per-layer readers, on a made-up trace
of a known timeline (a real one needs the card)."""

from __future__ import annotations

import pytest

from gpubench import harness
from gpubench.tracing import WINDOW, Trace


class Event:
    """The part of a Kineto event the reduction reads (PyTorch versions
    whose events do not say their activity type)."""

    def __init__(self, name, start, dur, device, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._ann = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann


def timeline():
    ms = 1_000_000
    return [
        Event(WINDOW, 0, 100 * ms, False, True),
        Event("tracker.refine", 10 * ms, 40 * ms, False, True),
        Event("step.vp_scan", 60 * ms, 30 * ms, False, True),
        Event("cudaLaunchKernel", 11 * ms, ms // 100, False),
        Event("spin before the window", -5 * ms, 2 * ms, True),
        Event("void fused_lk_level_kernel<3>", 0, 20 * ms, True),
        Event("pyramid_kernel(Params)", 15 * ms, 10 * ms, True),
        Event("Memcpy HtoD (Pageable -> Device)", 50 * ms, 10 * ms, True),
        Event("void fused_lk_level_kernel<5>", 95 * ms, 10 * ms, True),
    ]


def test_reduction():
    tr = Trace(timeline())
    assert tr.window_s == pytest.approx(0.1)
    # device busy [0, 25] + [50, 60] + [95, 100 (clipped)] = 40 ms
    assert tr.busy_s == pytest.approx(0.040)
    assert tr.kernel_launches == 3
    assert tr.kernel_seconds(("fused_lk_level_kernel",)) == (
        pytest.approx(0.030), 2)
    assert tr.range_seconds(("tracker.refine", "step.vp_scan")) == (
        pytest.approx(0.070), 2)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["void fused_lk_level_kernel<3>",
                                   pytest.approx(0.020)]
    # gaps: [25, 50] in tracker.refine, [60, 95] in step.vp_scan
    assert dict(map(tuple, bd["idle_gaps"])) == {
        "tracker.refine": pytest.approx(0.025),
        "step.vp_scan": pytest.approx(0.035)}


def test_readers():
    spec = harness.load_spec("dense1080.video")
    ctx = harness.ReaderContext(Trace(timeline()),
                                {"calls": 1, "pairs": 2, "frames": 3},
                                spec.config, spec.traffic)
    assert harness.load_reader("device_idle_pct.video")(ctx) == \
        pytest.approx(60.0)
    assert harness.load_reader("kernels_per_pair.video")(ctx) == 1.5
    share = harness.load_reader("fused_lk_level_roofline.video")(ctx)
    assert 0 < share < 100
    ctx.trace.device = [d for d in ctx.trace.device if "fused" not in d[2]]
    with pytest.raises(LookupError):
        harness.load_reader("fused_lk_level_roofline.video")(ctx)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        Trace([e for e in timeline() if e.name() != WINDOW])
