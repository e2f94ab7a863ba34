"""Batched VP serving end to end: lk_tpu_torch's MultiStreamPipeline
(device="cpu", the plain versions of the finish and the gather) against
lk_tpu's on the same staged frames, and the pieces of the step and runner.

Tolerances, and why: both sides run the same decisions, but the tracker's
window sums and the VP ring sums are reductions taken in another order
(and XLA on the CPU contracts products into FMAs), so positions differ in
their last bits: csv rows <= 1e-3 px, with the same row counts; cross
points, which near-parallel flow lines amplify by 1/sin of their angle,
<= 1e-3 px + 1e-4 relative.  The capped transport (out_cap) is a pure
re-layout: it equals the uncapped one exactly.  Host-side pieces (masks,
bands, compaction) are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu.models import PRESETS
from lk_tpu.pipeline import runner as jrunner
from lk_tpu.pipeline import step as jstep
from lk_tpu_torch.pipeline import runner as trunner
from lk_tpu_torch.pipeline import state as tstate
from lk_tpu_torch.pipeline import step as tstep
from torch_parity import port_cfg

B, F, CHUNK, W, H = 3, 24, 8, 430, 242
CFG = dataclasses.replace(PRESETS["final"], width=W, out_cap=48)


@pytest.fixture(scope="module")
def staging():
    """(F, B, h, w) u8 staging, built as apps/serve.py builds it: per-stream
    VP like serve.py's, gray conversion and INTER_AREA to the processing
    size on the host."""
    import cv2 as cv

    scenes = [SyntheticRoadStream(width=W, height=H, n_frames=F, seed=s,
                                  zoom=1.03,
                                  vp=(W * (0.45 + 0.01 * (s % 5)), H * 0.45))
              for s in range(B)]
    h = CFG.derived_height(H, W)
    u8 = np.empty((F, B, h, W), np.uint8)
    for b, sc in enumerate(scenes):
        for t in range(F):
            g = cv.cvtColor(sc.frame(t), cv.COLOR_BGR2GRAY)
            u8[t, b] = cv.resize(g, (W, h), interpolation=cv.INTER_AREA)
    return u8


def _feed(ms, st):
    t = 0
    while t < F:
        n = min(CHUNK + (1 if ms.states is None else 0), F - t)
        ms.feed_staged(st, t, n)
        t += n
    ms.drain()
    return ms


@pytest.fixture(scope="module")
def jax_run(staging):
    """lk_tpu's batched serving run (the one JAX pipeline build here)."""
    ms = jrunner.MultiStreamPipeline(CFG, src_size=(W, H), n_streams=B,
                                     chunk=CHUNK)
    return _feed(ms, jnp.asarray(staging))


@pytest.fixture(scope="module")
def port_runs(staging):
    return {cap: _feed(trunner.MultiStreamPipeline(
        port_cfg(dataclasses.replace(CFG, out_cap=cap)), src_size=(W, H),
        n_streams=B, chunk=CHUNK, device="cpu"), torch.from_numpy(staging))
        for cap in (0, 48)}


def test_serving_matches_lk_tpu(jax_run, port_runs):
    """Per stream the same number of csv rows, within 1e-3 px, the same
    shown/hidden frames, cross points and segments."""
    port = port_runs[48]
    assert port.frames_done == jax_run.frames_done == B * (F - 1)
    for p, q in zip(port.pipes, jax_run.pipes):
        assert len(p.csv_rows) == len(q.csv_rows) > 10
        np.testing.assert_allclose(np.array(p.csv_rows),
                                   np.array(q.csv_rows), rtol=0, atol=1e-3)
        assert [v is None for v in p.vp_per_frame] == [
            v is None for v in q.vp_per_frame]
        assert len(p.cross_points) == len(q.cross_points)
        np.testing.assert_allclose(np.array(p.cross_points),
                                   np.array(q.cross_points), rtol=1e-4,
                                   atol=1e-3)
        assert len(p.segments) == len(q.segments)
        np.testing.assert_allclose(np.array(p.motion_rows),
                                   np.array(q.motion_rows), rtol=0, atol=1e-4)


def test_serving_finds_planted_vp(port_runs):
    """The late trajectory sits near each stream's planted VP (the 25 px
    bound of tests/test_pipeline_e2e.py)."""
    for b, p in enumerate(port_runs[48].pipes):
        rows = np.array(p.csv_rows)
        gt = np.array([W * (0.45 + 0.01 * (b % 5)), H * 0.45])
        assert np.linalg.norm(rows[len(rows) // 2:].mean(0) - gt) < 25.0


def test_capped_equals_uncapped(port_runs):
    """out_cap compaction transports the identical row streams."""
    for p, q in zip(port_runs[48].pipes, port_runs[0].pipes):
        assert p.csv_rows == q.csv_rows
        assert p.cross_points == q.cross_points
        assert p.vp_per_frame == q.vp_per_frame
        assert p.motion_rows == q.motion_rows
        assert len(p.segments) == len(q.segments)
        for a, b in zip(p.segments, q.segments):
            np.testing.assert_array_equal(a["start"], b["start"])
            np.testing.assert_array_equal(a["stop"], b["stop"])


def test_compaction_overflow_raises(staging, port_runs):
    """A chunk that emits more rows than its budget is drained from the
    spill the compaction keeps: the rows equal the uncapped transport's.
    Only compacted outputs that lost their spill raise on overflow."""
    ms = trunner.MultiStreamPipeline(
        port_cfg(dataclasses.replace(CFG, out_cap=1)), src_size=(W, H),
        n_streams=B, chunk=CHUNK, device="cpu")
    ms.drain_every = 1000
    st = torch.from_numpy(staging)
    ms.feed_staged(st, 0, CHUNK + 1)
    pending = list(ms._pending)
    t = CHUNK + 1
    while t < F:
        n = min(CHUNK, F - t)
        ms.feed_staged(st, t, n)
        t += n
    ms.drain()
    assert ms.spilled_chunks > 0
    for p, q in zip(ms.pipes, port_runs[0].pipes):
        assert p.csv_rows == q.csv_rows and len(p.csv_rows) > 10
        assert p.cross_points == q.cross_points
        assert p.vp_per_frame == q.vp_per_frame
    outs = pending[0].outs
    sink = ms._sink()
    with pytest.raises(RuntimeError, match="compaction overflow"):
        for b in range(B):
            sink._drain(trunner._index(outs._replace(spill=None), b))


@pytest.fixture(scope="module")
def shared_start(staging, jax_run):
    """lk_tpu's state after the first-frame detection, and the next chunk
    of finished frames (B, T, h, w) f32, both numpy."""
    finish = jrunner._cached_finish(CFG)
    run_b, init_b = jrunner._cached_batched_runner(CFG, (W, staging.shape[2]))
    st = init_b(finish(jnp.asarray(staging[0])))
    frames = np.asarray(finish(jnp.asarray(staging[1:1 + CHUNK])))
    return jax.device_get(st), np.swapaxes(frames, 0, 1), run_b


def test_state_from_numpy_round_trip(shared_start):
    """lk_tpu's batched state -> the port's, leaf for leaf (on the CPU as
    asked); a single-stream state gains a stream axis."""
    jst, _, _ = shared_start
    tcfg = port_cfg(CFG)
    st = tstate.state_from_numpy(jst._asdict(), tcfg, device="cpu")
    assert st.prev_gray.device.type == "cpu"
    for k in ("prev_gray", "pts", "valid", "avg_len", "tp_ult"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jst, k)), err_msg=k)
    for k, v in jst.vp._asdict().items():
        np.testing.assert_array_equal(getattr(st.vp, k).numpy(),
                                      np.asarray(v), err_msg=k)
    one = jax.tree_util.tree_map(lambda x: np.asarray(x)[1], jst)
    st1 = tstate.state_from_numpy(one._asdict(), tcfg, device="cpu")
    assert st1.pts.shape == (1,) + st.pts.shape[1:]
    assert torch.equal(st1.pts[0], st.pts[1])
    assert st1.vp.ring_xy.shape == (1,) + st.vp.ring_xy.shape[1:]
    with pytest.raises(ValueError):
        tstate.state_from_numpy(one._asdict(),
                                dataclasses.replace(tcfg, tp_num=10),
                                device="cpu")


def test_one_chunk_from_shared_state(shared_start):
    """Both packages run one chunk from lk_tpu's state on the same finished
    frames: same per-frame row counts, rows <= 1e-3 px, same state
    decisions after it."""
    jst, frames, run_b = shared_start
    tcfg = port_cfg(CFG)
    j_state, j_out = run_b(jax.tree_util.tree_map(jnp.asarray, jst),
                           jnp.asarray(frames))
    j_state, j_out = jax.device_get((j_state, j_out))
    run_t, _, _ = trunner.make_batched_chunk_runner(
        tcfg, (W, frames.shape[2]), torch.device("cpu"))
    t_state, t_out = run_t(tstate.state_from_numpy(jst._asdict(), tcfg,
                                                   device="cpu"),
                           torch.from_numpy(frames))
    for k in ("upd_counts", "cp_counts"):
        np.testing.assert_array_equal(getattr(t_out, k).numpy(),
                                      np.asarray(getattr(j_out, k)))
    for k, counts, rtol in (("upd_rows", "upd_counts", 0.0),
                            ("cp_rows", "cp_counts", 1e-4)):
        for b in range(B):
            n = int(np.asarray(getattr(j_out, counts))[b].sum())
            np.testing.assert_allclose(
                getattr(t_out, k)[b, :n].numpy(),
                np.asarray(getattr(j_out, k))[b, :n], rtol=rtol, atol=1e-3)
    for k in ("show_mask", "vp_hidden", "line_mask", "vp_init",
              "live_count"):
        np.testing.assert_array_equal(getattr(t_out.rest, k).numpy(),
                                      np.asarray(getattr(j_out.rest, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(t_state.valid.numpy(),
                                  np.asarray(j_state.valid))
    np.testing.assert_allclose(t_state.pts.numpy(), np.asarray(j_state.pts),
                               rtol=0, atol=1e-3)
    assert t_state.tp_ult.tolist() == np.asarray(j_state.tp_ult).tolist()


def test_detect_matches_lk_tpu(staging, shared_start):
    """The first-frame detection: the same corners (the response agrees
    to its last bits; the greedy selection is exact)."""
    jst, _, _ = shared_start
    tcfg = port_cfg(CFG)
    _, init_t, _ = trunner.make_batched_chunk_runner(
        tcfg, (W, staging.shape[2]), torch.device("cpu"))
    first = trunner._cached_finish(tcfg)(torch.from_numpy(staging[0]))
    st = init_t(first)
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(jst.valid))
    np.testing.assert_array_equal(st.pts.numpy(), np.asarray(jst.pts))


def test_step_pieces_match_lk_tpu(rng):
    """check_inside, compact_slots and tracker_row_band, exact."""
    from lk_tpu.ops.rasterize import build_roi_masks

    h = CFG.derived_height(H, W)
    full, subs = build_roi_masks(W, h, CFG.roi)
    pts = np.stack([rng.uniform(-5, W + 5, (4, 20)),
                    rng.uniform(-5, h + 5, (4, 20))], -1).astype(np.float32)
    status = rng.random((4, 20)) < 0.8
    want = jax.vmap(lambda p, s: jstep.check_inside(p, full, s))(
        jnp.asarray(pts), jnp.asarray(status))
    got = tstep.check_inside(torch.from_numpy(pts),
                             torch.from_numpy(np.asarray(full)),
                             torch.from_numpy(status))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p, v = jax.vmap(jstep.compact_slots)(jnp.asarray(pts),
                                         jnp.asarray(status))
    tp, tv = tstep.compact_slots(torch.from_numpy(pts),
                                 torch.from_numpy(status))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(tp.numpy()[tv.numpy()],
                                  np.asarray(p)[np.asarray(v)])
    for cfg in (CFG, dataclasses.replace(CFG, track_row_band=False)):
        assert tstep.tracker_row_band(port_cfg(cfg), h, np.asarray(subs)) \
            == jstep.tracker_row_band(cfg, h, subs)


def test_compact_masked_rows_matches_lk_tpu(rng):
    rows = rng.normal(0, 50, (2, 5, 190, 2)).astype(np.float32)
    mask = rng.random((2, 5, 190)) < 0.05
    jr, jc = jrunner._compact_masked_rows(jnp.asarray(rows),
                                          jnp.asarray(mask), 48)
    tr, tc = trunner._compact_masked_rows(torch.from_numpy(rows),
                                          torch.from_numpy(mask), 48)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for b in range(2):
        n = min(int(mask[b].sum()), 48)
        np.testing.assert_array_equal(tr[b, :n].numpy(),
                                      np.asarray(jr)[b, :n])


def test_processed_feed_equals_staged_feed(staging, port_runs):
    """feed_processed with the finish applied separately == feed_staged."""
    tcfg = port_cfg(CFG)
    ms = trunner.MultiStreamPipeline(tcfg, src_size=(W, H), n_streams=B,
                                     chunk=CHUNK, device="cpu")
    fin = trunner._cached_finish(tcfg)
    g = fin(torch.from_numpy(staging)).transpose(0, 1)       # (B, F, h, w)
    t = 0
    while t < F:
        n = min(CHUNK + (1 if ms.states is None else 0), F - t)
        ms.feed_processed(g[:, t:t + n])
        t += n
    ms.drain()
    for p, q in zip(ms.pipes, port_runs[48].pipes):
        assert p.csv_rows == q.csv_rows


def test_ragged_lifecycle(staging, port_runs):
    """A stream ending mid-chunk keeps its first n_valid frames; its
    recycled slot starts a new stream whose sink matches a fresh run."""
    tcfg = port_cfg(CFG)
    st = torch.from_numpy(staging)
    ms = trunner.MultiStreamPipeline(tcfg, src_size=(W, H), n_streams=B,
                                     chunk=CHUNK, device="cpu")
    ms.feed_staged(st, 0, 9)
    ms.feed_staged(st, 9, 8, n_valid=[8, 3, 8])
    ms.finish_stream(1)
    old = ms.pipes[1]
    fresh = ms.assign_stream(1, trunner._cached_finish(tcfg)(st[0, 1]))
    ms.feed_staged(st, 17, 7)
    ms.drain()
    assert old in ms.retired and old.frames_done == 8 + 3
    ref = port_runs[48].pipes
    assert ms.pipes[0].csv_rows == ref[0].csv_rows
    assert fresh.frames_done == 7 and ms.frames_done == 23 + 11 + 7 + 23
    n_old = sum(1 for _ in old.vp_per_frame)
    assert n_old == 11


@pytest.mark.parametrize("contrast", [False, True])
def test_preprocess_frame_matches_lk_tpu(rng, contrast):
    """BGR -> gray -> INTER_AREA -> (tone) -> blur: <= 1e-3 (the resize is
    two matmuls, summed in another order)."""
    cfg = dataclasses.replace(CFG, contrast_enhance=contrast)
    bgr = rng.integers(0, 256, (2, 90, 160, 3)).astype(np.float32)
    want = np.asarray(jstep.preprocess_frame(jnp.asarray(bgr), cfg, 45, 80))
    got = tstep.preprocess_frame(torch.from_numpy(bgr), port_cfg(cfg), 45,
                                 80).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
