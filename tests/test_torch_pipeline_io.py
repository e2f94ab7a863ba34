"""The single-stream pipeline's host side in lk_tpu_torch (device="cpu"):
checkpoints and resume, the prefetching producer, MultiStreamPipeline's raw
BGR feed and async drains, and the output sinks — each held, as lk_tpu's
tests hold lk_tpu (tests/test_aux.py, tests/test_io_prefetch.py), against
the port's own synchronous, uninterrupted run.

Tolerance: none.  A split, prefetched or asynchronously drained run does
the same arithmetic on the same frames as the run it is compared with, so
rows are equal exactly."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.io import sink
from lk_tpu_torch.io.prefetch import ChunkPrefetcher, MultiStreamPrefetcher
from lk_tpu_torch.models import FINAL, VP_DETECT
from lk_tpu_torch.pipeline import runner
from lk_tpu_torch.pipeline.runner import MultiStreamPipeline, VideoPipeline
from lk_tpu_torch.utils.checkpoint import load_state, save_state
import torch_parity  # noqa: F401  (one PyTorch thread per test worker)

W, H, F = 430, 242, 24
CFG = PipelineConfig(width=W)


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticRoadStream(width=W, height=H, zoom=1.03, seed=11,
                                n_frames=F)
    return [scene.frame(t) for t in range(F)]


def _pipe(cfg=CFG, chunk=4):
    return VideoPipeline(cfg, src_size=(W, H), chunk=chunk, device="cpu")


@pytest.fixture(scope="module")
def full(frames):
    p = _pipe()
    p.run(iter(frames))
    return p


def _same_rows(a, b):
    assert a.frames_done == b.frames_done
    assert a.csv_rows == b.csv_rows and len(a.csv_rows) > 5
    assert a.vp_per_frame == b.vp_per_frame
    assert a.cross_points == b.cross_points
    assert len(a.segments) == len(b.segments)


def test_overflowing_budget_spills_exactly(frames, full):
    """With a budget of one row per frame every chunk overflows: the drain
    reads the spill and the sinks equal the uncapped run's."""
    p = _pipe(dataclasses.replace(CFG, out_cap=1))
    p.run(iter(frames))
    assert p.spilled_chunks > 0
    _same_rows(p, full)


# --- checkpoints -------------------------------------------------------------

def test_split_run_matches_continuous(frames, full, tmp_path):
    """A checkpoint at frame 12 and a resume in a fresh pipeline == one
    uninterrupted run (tests/test_aux.py:109)."""
    first = _pipe()
    first.run(iter(frames[:12]))
    ck = first.save_checkpoint(str(tmp_path / "ck.npz"))
    second = _pipe()
    second.resume_from(ck)
    second.run(iter(frames[12:]))
    assert not second.consumed_init_frame
    assert second.state.pts.shape == first.state.pts.shape
    assert first.csv_rows + second.csv_rows == full.csv_rows
    assert first.vp_per_frame + second.vp_per_frame == full.vp_per_frame
    for a, b in zip(second.state, full.state):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_resume_across_presets_fails_loudly(frames, tmp_path):
    """A FINAL checkpoint does not resume a VP_DETECT pipeline (same
    shapes, other semantics)."""
    pipe = _pipe(dataclasses.replace(FINAL, width=W))
    pipe.run(iter(frames[:8]))
    ck = pipe.save_checkpoint(str(tmp_path / "ck.npz"))
    other = _pipe(dataclasses.replace(VP_DETECT, width=W))
    other.resume_from(ck)
    with pytest.raises(ValueError, match="identity mismatch"):
        other.run(iter(frames[:8]))


def test_checkpoint_before_any_feed_raises():
    with pytest.raises(RuntimeError, match="no state"):
        _pipe().save_checkpoint("never.npz")


@pytest.mark.parametrize("case", ["dtype", "structure", "leaf_count",
                                  "shape", "meta"])
def test_load_state_rejects(case, tmp_path):
    """Each rejection of load_state (tests/test_aux.py:138-187)."""
    state = {"a": np.zeros((3,), np.float32), "b": np.ones((2,), np.int32)}
    p = save_state(state, str(tmp_path / "s.npz"), meta="one")
    bad, meta, match = dict(state), "", case
    if case == "dtype":
        bad["b"] = np.ones((2,), np.float32)
    elif case == "structure":
        bad = {"z": state["a"], "b": state["b"]}
    elif case == "leaf_count":
        with np.load(p) as z:
            items = dict(z)
        items["n"] = np.array(1)
        np.savez(p, **items)
        match = "leaves"
    elif case == "shape":
        bad["a"] = np.zeros((4,), np.float32)
    else:
        meta, match = "two", "identity mismatch"
    with pytest.raises(ValueError, match=match):
        load_state(bad, p, meta=meta)


def test_state_round_trip_keeps_tensors(tmp_path):
    """NamedTuple states of tensors come back leaf for leaf, as tensors of
    the template's dtypes; numpy leaves as numpy."""
    from lk_tpu_torch.pipeline.tracker import TrackerState

    st = TrackerState(prev_gray=torch.rand(4, 5),
                      pts=torch.rand(3, 2),
                      valid=torch.tensor([True, False, True]))
    p = save_state({"t": st, "n": np.arange(3)}, str(tmp_path / "s.npz"))
    back = load_state({"t": st._replace(pts=torch.zeros(3, 2)),
                       "n": np.zeros(3, np.int64)}, p)
    assert isinstance(back["t"], TrackerState)
    for a, b in zip(back["t"], st):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(back["n"], np.arange(3))


# --- prefetch ----------------------------------------------------------------

def _small(n, h=6, w=8, sleep=0.0):
    for t in range(n):
        if sleep:
            time.sleep(sleep)
        yield np.full((h, w, 3), t, np.uint8)


def test_pipeline_prefetch_matches_sync(frames, full):
    """run(prefetch=2) == run(prefetch=0), row for row
    (tests/test_io_prefetch.py:133); the transform ran on the producer."""
    pre = _pipe()
    names = []
    ingest = pre._ingest

    def spy(x):
        names.append(threading.current_thread().name)
        return ingest(x)

    pre._ingest = spy
    pre.run(iter(frames), prefetch=2)
    _same_rows(pre, full)
    assert pre.last_prefetcher is not None
    assert names and all(n == "lk-tpu-ingest" for n in names)


def test_prefetch_chunks_and_order():
    got = list(ChunkPrefetcher(_small(10), chunk=4))
    assert [g.shape[0] for g in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(got)[:, 0, 0, 0],
                                  np.arange(10))
    got = list(ChunkPrefetcher(_small(10), chunk=3, first_extra=1))
    assert [g.shape[0] for g in got] == [4, 3, 3]


def test_prefetch_producer_runs_ahead():
    pf = ChunkPrefetcher(_small(12), chunk=3, depth=8)
    it = iter(pf)
    next(it)
    time.sleep(0.3)
    assert pf.producer_done_at is not None
    assert len(list(it)) == 3


def test_prefetch_worker_exception_propagates():
    def bad():
        yield np.zeros((4, 4, 3), np.uint8)
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(ChunkPrefetcher(bad(), chunk=1))


def test_prefetch_close_stops_producer():
    pf = ChunkPrefetcher(_small(10_000, sleep=0.001), chunk=2, depth=2)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()


def test_multistream_prefetcher_batches_and_truncates():
    streams = [list(_small(9, h=4, w=5)) for _ in range(3)]
    for b, s in enumerate(streams):
        for f in s:
            f[..., 1] = b
    got = list(MultiStreamPrefetcher([iter(s) for s in streams], chunk=4,
                                     first_extra=1))
    assert [g.shape[:2] for g in got] == [(3, 5), (3, 4)]
    for i, g in enumerate(got):
        for b in range(3):
            start = [0, 5][i]
            np.testing.assert_array_equal(
                g[b], np.stack(streams[b][start:start + g.shape[1]]))
    got = list(MultiStreamPrefetcher([_small(7), _small(5)], chunk=3))
    assert [g.shape[:2] for g in got] == [(2, 3), (2, 2)]


def test_multistream_prefetcher_transform_and_close():
    mp = MultiStreamPrefetcher([_small(6, sleep=0.002) for _ in range(2)],
                               chunk=3,
                               batch_transform=lambda b: b.astype(
                                   np.float32) + 1.0)
    got = list(mp)
    assert got[0].dtype == np.float32 and got[0][0, 0, 0, 0, 0] == 1.0
    assert mp.decode_busy_s > 0.0
    mp = MultiStreamPrefetcher([_small(10_000, sleep=0.001)
                                for _ in range(2)], chunk=2)
    next(iter(mp))
    mp.close()
    assert not mp._thread.is_alive()
    assert all(not p._thread.is_alive() for p in mp._pfs)


# --- MultiStreamPipeline: raw feed, async drains -----------------------------

B, CHUNK = 2, 8


@pytest.fixture(scope="module")
def bgr(frames):
    """(B, F, H, W, 3) u8: the scene and its mirror image."""
    a = np.stack(frames)
    return np.stack([a, a[:, :, ::-1]])


def _feed_all(ms, batch, feed):
    t = 0
    while t < F:
        n = min(CHUNK + (1 if ms.states is None else 0), F - t)
        feed(batch[:, t:t + n])
        t += n
    ms.drain()
    return ms


def _multi(**kw):
    return MultiStreamPipeline(CFG, src_size=(W, H), n_streams=B,
                               chunk=CHUNK, device="cpu", **kw)


@pytest.fixture(scope="module")
def processed_run(bgr):
    ms = _multi()
    grays = torch.stack([ms.pipes[b]._ingest(bgr[b]) for b in range(B)])
    return _feed_all(ms, grays, ms.feed_processed)


def test_multistream_feed_bgr_equals_feed_processed(bgr, processed_run):
    """feed of raw BGR (cv2 gray + INTER_AREA on the host, the finish on
    the device) == feed_processed of the same ingested frames; the sinks
    are VideoPipelines sharing one cached runner."""
    ms = _multi()
    _feed_all(ms, bgr, ms.feed)
    assert all(isinstance(p, VideoPipeline) for p in ms.pipes)
    assert ms.pipes[0]._run is ms.pipes[1]._run
    assert all(p.consumed_init_frame for p in ms.pipes)
    for p, q in zip(ms.pipes, processed_run.pipes):
        _same_rows(p, q)


def test_async_drains_equal_sync(bgr, processed_run):
    """start_async_drains: the periodic drains on a worker thread give the
    synchronous drains' rows."""
    ms = _multi()
    ms.drain_every = 1
    ms.start_async_drains()
    grays = torch.stack([ms.pipes[b]._ingest(bgr[b]) for b in range(B)])
    _feed_all(ms, grays, ms.feed_processed)
    assert ms._drain_worker.is_alive()
    for p, q in zip(ms.pipes, processed_run.pipes):
        _same_rows(p, q)


def test_async_drain_error_surfaces(bgr):
    ms = _multi()
    ms.start_async_drains()
    grays = torch.stack([ms.pipes[b]._ingest(bgr[b, :9]) for b in range(B)])
    ms.feed_processed(grays)

    def broken(*a, **k):
        raise RuntimeError("sink failed")

    ms.pipes[0]._drain = broken
    with pytest.raises(RuntimeError, match="sink failed"):
        ms.drain()


# Chunks of (first frame, frames, n_valid) over the F processed frames: the
# first feed's init frame and 4 more, slot 1's stream ending 2 frames into
# the third chunk and its slot recycled before the fourth, a short last one.
SCHEDULE = ((0, 5, None), (5, 4, None), (9, 4, [4, 2]), (13, 4, None),
            (17, 4, None), (21, 3, None))


def _feed_schedule(ms, grays):
    """Feed SCHEDULE chunk by chunk, with no drain."""
    for k, (t, n, nv) in enumerate(SCHEDULE):
        ms.feed_processed(grays[:, t:t + n], n_valid=nv)
        if nv is not None:
            ms.finish_stream(1)
            ms.assign_stream(1, grays[1, t + n])
    return ms


@pytest.fixture(scope="module")
def ingested(bgr):
    ms = _multi()
    return torch.stack([ms.pipes[b]._ingest(bgr[b]) for b in range(B)])


@pytest.fixture(scope="module")
def booked_at_drain(ingested):
    """SCHEDULE with out_cap 48, every chunk booked by the final drain()."""
    ms = MultiStreamPipeline(dataclasses.replace(CFG, out_cap=48),
                             src_size=(W, H), n_streams=B, chunk=4,
                             device="cpu")
    ms.drain_every = 1000
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MultiStreamPipeline, "_book_slice", lambda self: None)
        _feed_schedule(ms, ingested)
        assert all(p.frames_done == 0 for p in ms.pipes + ms.retired)
        ms.drain()
    return ms


def _same_sinks(a, b):
    """Every sink of two pipelines equal, element for element, in order."""
    sa, sb = a.retired + a.pipes, b.retired + b.pipes
    assert len(sa) == len(sb)
    for p, q in zip(sa, sb):
        assert p.frames_done == q.frames_done
        assert p.csv_rows == q.csv_rows
        assert p.cross_points == q.cross_points
        assert p.vp_per_frame == q.vp_per_frame
        assert p.motion_rows == q.motion_rows
        assert len(p.segments) == len(q.segments)
        for x, y in zip(p.segments, q.segments):
            assert np.array_equal(x["start"], y["start"])
            assert np.array_equal(x["stop"], y["stop"])


@pytest.mark.parametrize("drain_every,out_cap,late",
                         [(1, 48, False), (3, 48, False), (1000, 48, False),
                          (1, 1, False), (1000, 48, True)])
def test_booking_between_frames_equals_booking_at_drain(
        ingested, booked_at_drain, drain_every, out_cap, late, monkeypatch):
    """Each chunk's rows are booked in slices between the next chunk's
    frames: after k chunks the first k - 1 are in the sinks and the last
    is not, and after drain() the sinks equal those of the run booked only
    at drain(), a finished stream and a recycled slot included.  With a
    budget of one row a frame every slot overflows and is read from its
    spill, exactly.  ``late``: no host copy has landed while the second
    and third chunks step, so the fourth books three chunks, oldest
    first."""
    ms = MultiStreamPipeline(dataclasses.replace(CFG, out_cap=out_cap),
                             src_size=(W, H), n_streams=B, chunk=4,
                             device="cpu")
    ms.drain_every = drain_every
    runner.reset_counters()
    if late:
        landed = runner._Pending.landed
        monkeypatch.setattr(
            runner._Pending, "landed", lambda self, wait: landed(self, wait)
            and (wait or runner.chunk_graph_counts["eager"] > 3))
    _feed_schedule(ms, ingested)
    k, last = len(SCHEDULE), SCHEDULE[-1][1]
    assert runner.drain_counts["booked_between"] == (k - 1) * B
    assert runner.drain_counts["booked_at_drain"] == 0
    assert ms.frames_done == booked_at_drain.frames_done - last * B
    for p, q in zip(ms.pipes, booked_at_drain.pipes):
        assert len(p.vp_per_frame) == len(q.vp_per_frame) - last
    ms.drain()
    assert runner.drain_counts["booked_at_drain"] == B
    assert not ms._pending
    _same_sinks(ms, booked_at_drain)
    spilled = runner.drain_counts["spill_reads"]
    assert spilled == ms.spilled_chunks
    if out_cap == 1:
        assert spilled > booked_at_drain.spilled_chunks
    else:
        assert spilled == booked_at_drain.spilled_chunks


def test_assign_stream_returns_video_pipeline(bgr):
    ms = _multi(host_preprocess=False)
    grays = torch.stack([ms.pipes[b]._ingest(bgr[b, :9]) for b in range(B)])
    ms.feed_processed(grays)
    old = ms.pipes[1]
    fresh = ms.assign_stream(1, grays[1, 0])
    assert isinstance(fresh, VideoPipeline) and fresh.consumed_init_frame
    assert ms.pipes[1] is fresh and ms.retired == [old]
    assert ms.states.pts.shape[0] == B


# --- sinks -------------------------------------------------------------------

def test_vp_csv_round_trip(full, tmp_path):
    path = sink.save_vp_csv(full.csv_rows, "clip", out_dir=str(tmp_path))
    assert path.endswith("vps_clip.csv")
    xs, ys = sink.read_vp_csv("clip", out_dir=str(tmp_path))
    np.testing.assert_allclose(np.stack([xs, ys], 1),
                               np.array(full.csv_rows), rtol=1e-15)
    assert sink.read_vp_csv(path)[0] == xs


def test_segments_and_objects_round_trip(full, tmp_path):
    p = sink.save_segments_pickle(full.segments[:5],
                                  str(tmp_path / "segs.pkl"))
    recs = sink.read_object(p)
    assert len(recs) == 5
    for r, s in zip(recs, full.segments):
        np.testing.assert_array_equal(r["start"], s["start"])
        vec = (s["stop"] - s["start"]) * np.array([1, -1], np.float32)
        assert r["length"] == float(np.round(np.linalg.norm(vec), 2))
        assert 0.0 <= r["angle"] < 360.0
    obj = {"rows": full.csv_rows[:3]}
    assert sink.read_object(sink.save_object(
        obj, str(tmp_path / "o.pkl"))) == obj
