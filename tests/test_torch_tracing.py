"""The port's spans (``utils.profiling.span``): a shared no-op with no
profiler, named ranges under one, nested where the dense path's drivers
meet (a video call, its chunks, its output copy), and the VP
path's names kept.  CPU only; the dense shapes and configs of
tests/test_torch_dense.py."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import lk_tpu_torch
from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.utils import profiling

CFG = LKConfig(max_level=1)
DCFG = DenseLKConfig(use_pallas_fused=True, iter_schedule=(1, 4),
                     pyramid_levels=2, video_chunk=3, scharr_mxu=False)
DENSE = ("dense.",)


@pytest.fixture(scope="module")
def clip():
    """8 frames of 128x1024: 7 pairs, two chunks of 3 and a 1-pair
    chunk."""
    g = torch.Generator().manual_seed(1234)
    x = torch.rand((8, 1, 32, 256), generator=g)
    return torch.nn.functional.interpolate(
        x, size=(128, 1024), mode="bilinear")[:, 0] * 255


def ranges(prof, prefixes=DENSE):
    """(name, start, end) of the profile's CPU ranges named with one of
    ``prefixes``, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(prefixes)), key=lambda r: r[1])


def inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def test_span_without_profiler_is_one_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a, b:           # reusable and reentrant
        pass


def test_span_under_profiler_is_a_named_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("x.outer"):
            with profiling.span("x.inner"):
                torch.ones(4).sum()
    (outer, inner) = ranges(prof, ("x.",))
    assert (outer[0], inner[0]) == ("x.outer", "x.inner")
    assert inside(inner, outer)


def _vp_step(steps=2):
    """A few steps of make_step's single-stream step at 128x64."""
    from lk_tpu_torch import config as tc
    from lk_tpu_torch.ops.rasterize import build_roi_masks
    from lk_tpu_torch.pipeline.runner import make_chunk_runner
    from lk_tpu_torch.pipeline.step import make_step

    pcfg = tc.PipelineConfig(width=128)
    full, subs = build_roi_masks(128, 64, pcfg.roi)
    step, _, _ = make_step(pcfg, (128, 64), full, subs, device="cpu")
    _, init_fn, _ = make_chunk_runner(pcfg, (128, 64), device="cpu")
    rng = np.random.default_rng(7)
    frames = torch.as_tensor(rng.random((steps + 1, 64, 128)) * 255,
                             dtype=torch.float32)
    state = init_fn(frames[0])
    for f in frames[1:]:
        state, _ = step(state, f)


def test_no_span_site_opens_a_range_without_profiler(clip, monkeypatch):
    """With no profiler, the dense path and the VP step open no
    ``record_function``; under one, every span site does."""
    opened = []
    real = profiling.record_function

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counted)

    def work():
        td.dense_pyramidal_lk(clip[0], clip[1], CFG, dense_cfg=DCFG)
        td.dense_pyramidal_lk_video(clip[:5], CFG, DCFG)
        _vp_step(1)

    work()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    assert {"dense.pair", "dense.video", "dense.chunk", "dense.cat",
            "step.vp_scan"} <= set(opened)


def test_record_function_only_in_the_helper():
    """Every span of the package goes through ``span``."""
    root = Path(lk_tpu_torch.__file__).parent
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["utils/profiling.py"]


def _work_ops(prof):
    """(name, start, end) of the profile's CPU operators of the dense
    path's work: the pyramid's and the levels' gathers, the levels'
    square roots (min_eig)."""
    return ranges(prof, ("aten::gather", "aten::sqrt"))


def test_pair_spans(clip):
    """One ``dense.pair`` and no other dense span (the pyramid and the
    levels open none), holding the call's pyramid and level work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.dense_pyramidal_lk(clip[0], clip[1], CFG, dense_cfg=DCFG)
    (pair,) = ranges(prof)
    assert pair[0] == "dense.pair"
    ops = _work_ops(prof)
    assert ops and all(inside(r, pair) for r in ops)


def test_chunked_video_spans(clip, monkeypatch):
    """7 pairs at video_chunk 3: one outermost ``dense.video`` holding
    three ``dense.chunk`` (3, 3 and the leftover pair, each building its
    own frames' pyramids) and then one ``dense.cat``; the pyramid and level
    work each inside exactly one chunk."""
    n_pairs = clip.shape[0] - 1
    assert n_pairs % DCFG.video_chunk == 1
    builds = []
    real = td.build_pyramid

    def counted(x, *a, **k):
        builds.append(x.shape[0])
        return real(x, *a, **k)

    monkeypatch.setattr(td, "build_pyramid", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.dense_pyramidal_lk_video(clip, CFG, DCFG)
    assert builds == [4, 4, 2]
    rs = ranges(prof)
    by = {}
    for r in rs:
        by.setdefault(r[0], []).append(r)
    assert set(by) == {"dense.video", "dense.chunk", "dense.cat"}
    (video,) = by["dense.video"]
    assert all(inside(r, video) for r in rs)
    chunks = by["dense.chunk"]
    assert len(chunks) == 3 and len(by["dense.cat"]) == 1
    ops = _work_ops(prof)
    assert ops
    for r in ops:
        assert sum(inside(r, c) for c in chunks) == 1
    assert all(any(inside(r, c) for r in ops) for c in chunks)
    assert by["dense.cat"][0][1] >= chunks[-1][2]


def test_vp_step_keeps_its_span_names():
    """make_step's step still emits ``step.vp_scan`` and the tracker's
    ranges, under the names chip_smoke.py's stage tables read."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _vp_step()
    names = {r[0] for r in ranges(prof, ("step.", "tracker."))}
    assert {"step.vp_scan", "tracker.pyramid", "tracker.scharr",
            "tracker.refine"} <= names


def test_spans_totals_and_profile_ranges():
    """``Spans`` sums what it timed, and its names are ranges on the
    profiler's timeline that hold the timed intervals."""
    s = profiling.Spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with s("sp.a"):
                time.sleep(0.02)
        with s("sp.b"):
            time.sleep(0.01)
    rs = ranges(prof, ("sp.",))
    assert [r[0] for r in rs] == ["sp.a", "sp.a", "sp.b"]
    assert s.count == {"sp.a": 2, "sp.b": 1}
    for name, least in (("sp.a", 0.04), ("sp.b", 0.01)):
        traced = sum(r[2] - r[1] for r in rs if r[0] == name) * 1e-6
        assert least <= s.total[name] <= traced + 1e-4


def test_serving_chunk_spans(monkeypatch):
    """``MultiStreamPipeline`` opens one ``serve.chunk`` per chunk around
    the chunk's step (the tracker's fold, every frame's step, the output
    compaction), with the finish outside it; with no profiler, none."""
    from lk_tpu_torch import config as tc
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    # flat frames: no corners, so the steps stay short (the spans, not the
    # tracking, are under test)
    pcfg = tc.PipelineConfig(width=256, out_cap=8)
    staging = torch.full((5, 1, 128, 256), 128, dtype=torch.uint8)

    def serve():
        ms = MultiStreamPipeline(pcfg, src_size=(256, 128), n_streams=1,
                                 chunk=2, device="cpu")
        ms.feed_staged(staging, 0, 3)
        ms.feed_staged(staging, 3, 2)
        return ms

    opened = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name) or real(name))
    serve()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ms = serve()
    assert ms.last_outputs is not None
    rs = ranges(prof, ("serve.", "tracker.fold", "step.vp_scan"))
    chunks = [r for r in rs if r[0] == "serve.chunk"]
    assert len(chunks) == 2
    for name in ("tracker.fold", "serve.compact", "step.vp_scan"):
        inner = [r for r in rs if r[0] == name]
        assert inner and all(sum(inside(r, c) for c in chunks) == 1
                             for r in inner)
    finishes = [r for r in rs if r[0] == "serve.finish"]
    assert len(finishes) == 3
    assert not any(inside(r, c) for r in finishes for c in chunks)
