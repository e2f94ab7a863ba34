"""The batched VP step, which the serving runner's CUDA graph captures
(``pipeline/runner.py``): it reads nothing back to the host and detects
every frame, and the frame program around the graph steps a chunk as the
op-by-op loop does.  On the CPU, at the tiny fleet cell's size
(``gpubench/tests/_tiny_fleet.py``): 4 streams of 320x180 over a chunk
with a forced replenish and VP updates among its steps."""

import dataclasses

import pytest
import torch

from gpubench.drivers.vp_fleet import _differing, clone
from gpubench.tests._tiny_fleet import run_chunks, tiny_fleet_spec
from lk_tpu_torch.flow.sparse import fold_tracking_levels
from lk_tpu_torch.ops.rasterize import build_roi_masks
from lk_tpu_torch.pipeline import runner, step
from lk_tpu_torch.pipeline.step import make_step, tracker_row_band

SEED = 2 ** 31 + 21


@pytest.fixture(scope="module")
def chunk():
    """The tiny cell's first full chunk: its start state and its finished
    frames (B, T, H, W)."""
    torch.set_num_threads(1)
    cell = run_chunks(tiny_fleet_spec(), 1, seed=SEED)
    kept = cell.first
    frames = kept["frames"][1:]
    n, b = frames.shape[:2]
    g = cell.finish(frames.reshape((n * b,) + frames.shape[2:]))
    return cell, kept["start"], g.reshape((n, b) + g.shape[1:]).transpose(0, 1)


def _steps(cell, start, frames, cfg=None) -> list:
    """(state, outputs) after each frame of the chunk, op by op, under
    ``cfg`` (the cell's own by default)."""
    cfg = cfg or cell.cfg
    c = cell.config
    roi_mask, sub_masks = build_roi_masks(c["width"], c["height"], cfg.roi)
    _, _, step_batched = make_step(cfg, (c["width"], c["height"]),
                                   roi_mask, sub_masks, device="cpu")
    band = tracker_row_band(cfg, c["height"], sub_masks)
    carry = (clone(start), fold_tracking_levels(start.prev_gray, cfg.lk,
                                                row_band=band))
    out = []
    for t in range(frames.shape[1]):
        carry, o = step_batched(carry, frames[:, t])
        out.append((carry[0], o))
    return out


@pytest.mark.parametrize("method", ["REP", "EXT"])
def test_untriggered_streams_ignore_detection(chunk, method, monkeypatch):
    """The step detects every frame and a stream that does not trigger a
    replenish ignores its pools: each frame's state and outputs are, bit
    for bit, those of a step whose detection returns empty pools for every
    stream that does not trigger.  EXT is the classify preset's method."""
    cell, start, frames = chunk
    cfg = dataclasses.replace(cell.cfg, fl_upd_meth=method)
    every = _steps(cell, start, frames, cfg)
    # the trigger of each stream in each frame, as the step computes it
    tp_ult = [start.tp_ult] + [st.tp_ult for st, _ in every[:-1]]
    triggered = [(o.live_count < int(cfg.tp_num * cfg.tp_update_rate))
                 | (u == cfg.tp_update_time)
                 for (_, o), u in zip(every, tp_ult)]
    assert all(bool((st.tp_ult[tr] == 1).all())
               for (st, _), tr in zip(every, triggered))
    flat = torch.stack(triggered)
    assert flat.any() and not flat.all()
    assert any(bool(o.update_mask.any()) for _, o in every)
    real = step.good_features_from_response
    frame = iter(triggered)

    def empty_unless_triggered(resp, masks, fcfg):
        xy, val = real(resp, masks, fcfg)
        return xy, val & next(frame)[:, None, None]

    monkeypatch.setattr(step, "good_features_from_response",
                        empty_unless_triggered)
    masked = _steps(cell, start, frames, cfg)
    assert next(frame, None) is None
    for (sa, oa), (sb, ob) in zip(every, masked):
        for a, b in zip(runner._leaves((sa, oa)), runner._leaves((sb, ob))):
            assert a.shape == b.shape and torch.equal(a, b)


def test_leaves_rebuild_a_nested_tree(chunk):
    """A chunk's (states, outputs) pair: a tuple of NamedTuples."""
    _, start, _ = chunk
    tree = (start, (start.vp, None))
    leaves = runner._leaves(tree)
    assert len(leaves) == 2 * len(start.vp) + len(start) - 1
    again = runner._rebuild(tree, iter([t + 0 for t in leaves]))
    assert type(again) is tuple and type(again[0]) is type(start)
    assert type(again[1][0]) is type(start.vp) and again[1][1] is None
    for a, b in zip(runner._leaves(again), leaves):
        assert a is not b and torch.equal(a, b)


def test_a_frame_program_steps_a_chunk_in_place(chunk):
    """``_FrameProgram.run`` around a graph that stands in for the capture
    (its replay runs the captured work, ``step_in_place``): the chunk's
    states and outputs are the op-by-op chunk's, each in fresh tensors."""
    cell, start, frames = chunk
    c = cell.config
    roi_mask, sub_masks = build_roi_masks(c["width"], c["height"],
                                          cell.cfg.roi)
    _, _, step_batched = make_step(cell.cfg, (c["width"], c["height"]),
                                   roi_mask, sub_masks, device="cpu")
    band = tracker_row_band(cell.cfg, c["height"], sub_masks)
    carry = (start, fold_tracking_levels(start.prev_gray, cell.cfg.lk,
                                         row_band=band))
    prog = runner._FrameProgram(runner.chunk_graph_counts, 1)
    prog.carry = runner._rebuild(carry, iter(
        [torch.zeros_like(t) for t in runner._leaves(carry)]))
    prog.gray = torch.zeros_like(frames[:, 0])

    class Graph:
        def replay(self):
            prog.outs = prog.step_in_place(step_batched)

    prog.graph = Graph()
    runner.reset_counters()
    states, outs = prog.run(carry, frames)
    assert runner.chunk_graph_counts["replays"] == 1
    plain = _steps(cell, start, frames)
    assert len(outs) == len(plain)
    for o, (_, want) in zip(outs, plain):
        for a, b in zip(runner._leaves(o), runner._leaves(want)):
            assert torch.equal(a, b)
    held = {t.untyped_storage().data_ptr()
            for t in runner._leaves((prog.carry, prog.gray, prog.outs))}
    for a, b in zip(runner._leaves(states), runner._leaves(plain[-1][0])):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() not in held
    for o in outs:
        assert all(t.untyped_storage().data_ptr() not in held
                   for t in runner._leaves(o))


def test_off_the_card_a_chunk_runs_op_by_op(chunk):
    cell, start, frames = chunk
    runner.reset_counters()
    run = runner.make_batched_chunk_runner(
        cell.cfg, (cell.config["width"], cell.config["height"]), "cpu")[0]
    run(clone(start), frames)
    assert runner.chunk_graph_counts == {"captures": 0, "replays": 0,
                                         "eager": 1}


def test_a_frame_program_steps_a_single_stream_chunk_in_place():
    """The single-stream runner's frame program (``make_chunk_runner``: a
    carry of the state alone, frames on axis 0) around the same stand-in
    graph, on a chunk of the tiny single-stream cell: the chunk's state
    and outputs are the op-by-op chunk's, in fresh tensors, though the
    step's new ``prev_gray`` is the static frame itself.  Off the card the
    runner steps the chunk op by op."""
    from gpubench.tests._tiny_solo import run_clips, tiny_solo_spec

    torch.set_num_threads(1)
    cell = run_clips(tiny_solo_spec(), seed=SEED)
    kept = cell.kept.chunks[1]
    start, frames = kept["start"], kept["grays"]
    c = cell.config
    roi_mask, sub_masks = build_roi_masks(c["width"], c["height"],
                                          cell.cfg.roi)
    single, _, _ = make_step(cell.cfg, (c["width"], c["height"]), roi_mask,
                             sub_masks, device="cpu")

    def step_carry(carry, gray):
        state, o = single(carry[0], gray)
        return (state,), o

    prog = runner._FrameProgram(runner.video_graph_counts, 0)
    prog.carry = (runner._rebuild(start, iter(
        [torch.zeros_like(t) for t in runner._leaves(start)])),)
    prog.gray = torch.zeros_like(frames[0])

    class Graph:
        def replay(self):
            prog.outs = prog.step_in_place(step_carry)

    prog.graph = Graph()
    runner.reset_counters()
    state, outs = prog.run((start,), frames)
    assert runner.video_graph_counts["replays"] == 1
    want_state, want_outs = start, []
    for t in range(frames.shape[0]):
        want_state, o = single(want_state, frames[t])
        want_outs.append(o)
    held = {t.untyped_storage().data_ptr()
            for t in runner._leaves((prog.carry, prog.gray, prog.outs))}
    for o, want in zip(outs, want_outs):
        for a, b in zip(runner._leaves(o), runner._leaves(want)):
            assert torch.equal(a, b)
            assert a.untyped_storage().data_ptr() not in held
    for a, b in zip(runner._leaves(state), runner._leaves(want_state)):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() not in held
    run = runner.make_chunk_runner(cell.cfg, (c["width"], c["height"]),
                                   "cpu")[0]
    end, chunk_outs = run(start, frames)
    assert runner.video_graph_counts == {"captures": 0, "replays": 1,
                                         "eager": 1}
    assert _differing(chunk_outs, kept["outs"]) == 0
    assert _differing(end, state) == 0
