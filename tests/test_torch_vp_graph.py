"""The static form of the batched VP step, which the serving runner's CUDA
graph captures (``pipeline/runner.py``): with no host read it scans every
cross-point pair and always detects, and must give the op-by-op step's
bits.  On the CPU, at the tiny fleet cell's size
(``gpubench/tests/_tiny_fleet.py``): 4 streams of 320x180 over a chunk
with a forced replenish and VP updates among its steps."""

import pytest
import torch

from gpubench.drivers.vp_fleet import clone
from gpubench.tests._tiny_fleet import run_chunks, tiny_fleet_spec
from lk_tpu_torch.flow.sparse import fold_tracking_levels
from lk_tpu_torch.geometry import vanishing
from lk_tpu_torch.ops.rasterize import build_roi_masks
from lk_tpu_torch.pipeline import runner
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


def _steps(cell, start, frames, static: bool) -> list:
    """(state, outputs) after each frame of the chunk, op by op."""
    c = cell.config
    roi_mask, sub_masks = build_roi_masks(c["width"], c["height"],
                                          cell.cfg.roi)
    _, _, step_batched = make_step(cell.cfg, (c["width"], c["height"]),
                                   roi_mask, sub_masks, device="cpu")
    band = tracker_row_band(cell.cfg, c["height"], sub_masks)
    carry = (clone(start), fold_tracking_levels(start.prev_gray, cell.cfg.lk,
                                                row_band=band))
    out = []
    for t in range(frames.shape[1]):
        carry, o = step_batched(carry, frames[:, t], static)
        out.append((carry[0], o))
    return out


def test_the_static_step_gives_the_op_by_op_bits(chunk, monkeypatch):
    cell, start, frames = chunk
    scans = []
    real = vanishing.process_frame_pairs

    def counted(state, cps, cand, n_steps, *a, **k):
        scans.append((n_steps, cand.shape[1]))
        return real(state, cps, cand, n_steps, *a, **k)

    monkeypatch.setattr("lk_tpu_torch.pipeline.step.process_frame_pairs",
                        counted)
    plain = _steps(cell, start, frames, static=False)
    eager_scans, scans[:] = list(scans), []
    static = _steps(cell, start, frames, static=True)
    # the op-by-op scans stop at the last candidate; the static ones run on
    # over every pair
    assert any(n < p for n, p in eager_scans)
    assert all(n == p for n, p in scans)
    # frames with and without a replenish trigger: the static step's
    # detection runs where the op-by-op step skips it
    triggered = [bool((st.tp_ult == 1).any()) for st, _ in plain]
    assert any(triggered) and not all(triggered)
    assert any(bool(o.update_mask.any()) for _, o in plain)
    for (sa, oa), (sb, ob) in zip(plain, static):
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
    prog = runner._FrameProgram()
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
    plain = _steps(cell, start, frames, static=False)
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
