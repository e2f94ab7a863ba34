"""The check of gpubench's VP serving cell (``vp860.fleet64``) on the CPU,
at 4 streams of 320x180 (``gpubench/tests/_tiny_fleet.py``): the program's
teacher-forced steps against the float64 plain reference
(``gpubench/reference/vp.py``) over two chunks of the serving path, with
replenishment and VP updates among the steps; the frame-by-frame replay
against the chunked run; faults planted in the program, which the check
must catch, in the step and in the serving around it (the compaction,
the drain, the seeding and recycling of slots); and the bfloat16 control,
which must fail it.

The limits are the cell's own (``gpubench/traffic/fleet64.json``).  The
reference is written from lk_tpu's stated semantics, not from the port, so
the clean run is two independent readings of one step: float64 against
float32 leaves gaps of ~1e-5 px.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.drivers import vp_fleet
from gpubench.reference import vp as ref
from gpubench.tests._tiny_fleet import run_chunks, tiny_fleet_spec

SEED = 2 ** 31 + 9


def _failed(out: dict, spec) -> set:
    """The compared numbers above their limits."""
    limits = spec.traffic["check"]["limits"]
    return {k for k, v in out.items() if v > limits[k]}


def _correct(out: dict, spec) -> bool:
    return not _failed(out, spec)


@pytest.fixture(scope="module")
def clean():
    """Two chunks (19 steps of 4 streams) of the tiny cell, checked, with
    the reference's VP updates and replenishments counted."""
    torch.set_num_threads(1)
    seen = dict(updates=0, replenished=0)
    real = ref.Tally.add

    def add(self, got, want):
        seen["updates"] += int(want["n_upd"].sum())
        seen["replenished"] += int(want["replenish"].sum())
        real(self, got, want)

    spec = tiny_fleet_spec()
    cell = run_chunks(spec, 2, seed=SEED)
    ref.Tally.add = add
    try:
        out = cell.compare()
    finally:
        ref.Tally.add = real
    return spec, cell, out, seen


def test_the_program_holds_to_the_reference(clean):
    spec, _, out, seen = clean
    assert _correct(out, spec), out
    # the steps worked the whole machine: tracking, VP updates, replenish
    assert seen["updates"] > 0 and seen["replenished"] > 0
    assert out["no_replenish"] == 0 and out["no_vp_share"] < 0.25
    assert 0 < out["pts_mean_gap_px"] < 1e-4, out
    assert out["slot_mismatch_share"] == 0, out


def test_the_replay_equals_the_chunked_run(clean):
    """The kept chunks replayed frame by frame through the runner give the
    timed chunks' outputs and end states bit for bit."""
    _, cell, out, _ = clean
    assert out["replay_mismatch"] == 0
    kept = cell.first
    per_frame = cell._replay(kept, None)
    assert len(per_frame) == kept["frames"].shape[0] - 1
    # the per-frame outputs are those the chunk compacts
    from lk_tpu_torch.pipeline.runner import (_compact_chunk_outputs,
                                              _stack_frames)

    stacked = _compact_chunk_outputs(
        _stack_frames([o for o, _ in per_frame], dim=1), cell.cfg.out_cap)
    assert vp_fleet._differing(stacked, kept["outs"]) == 0
    assert vp_fleet._differing(per_frame[-1][1]._replace(prev_gray=None),
                               kept["after"]._replace(prev_gray=None)) == 0


def test_the_replay_sees_a_changed_chunk(clean):
    """A timed chunk whose outputs or end state differ from its replay is
    counted."""
    _, cell, _, _ = clean
    kept = dict(cell.first)
    outs = kept["outs"]
    kept["outs"] = outs._replace(cp_counts=outs.cp_counts + 1)
    after = kept["after"]
    kept["after"] = after._replace(tp_ult=after.tp_ult + 1)
    tally = ref.Tally()
    cell._replay(kept, tally)
    assert tally.replay_mismatch == 2


def _fault(name, monkeypatch):
    real = vp_fleet.program_config

    def planted(change):
        monkeypatch.setattr(vp_fleet, "program_config",
                            lambda c: change(real(c)))

    if name == "window_13x13":
        planted(lambda p: dataclasses.replace(
            p, lk=dataclasses.replace(p.lk, win_size=(13, 13))))
    elif name == "sobel_for_scharr":
        from lk_tpu_torch.flow import sparse
        from lk_tpu_torch.ops.gradients import sobel_derivatives

        monkeypatch.setattr(sparse, "scharr_derivatives", sobel_derivatives)
    elif name == "min_eig_threshold_x10":
        planted(lambda p: dataclasses.replace(p, lk=dataclasses.replace(
            p.lk, min_eig_threshold=p.lk.min_eig_threshold * 10)))
    elif name == "vp_update_rate":
        planted(lambda p: dataclasses.replace(p, vp_update_rate=0.6))


@pytest.mark.parametrize("name", ["window_13x13", "sobel_for_scharr",
                                  "min_eig_threshold_x10", "vp_update_rate"])
def test_a_planted_fault_is_caught(name, monkeypatch):
    torch.set_num_threads(1)
    _fault(name, monkeypatch)
    spec = tiny_fleet_spec()
    out = run_chunks(spec, 1, seed=SEED).compare()
    # caught by a comparison, not by the coverage guards alone
    assert _failed(out, spec) - {"no_vp_share", "no_replenish"}, out


def _serving_fault(name, monkeypatch) -> int:
    """Plant a fault in the serving layer around the step; returns the
    chunks the tiny cell must run for the fault to act."""
    from lk_tpu_torch.pipeline import runner

    if name == "drain_reads_the_next_stream":
        real_index = runner._index

        def shifted(tree, b):
            if isinstance(tree, (np.ndarray, torch.Tensor)):
                return tree[(b + 1) % tree.shape[0]]
            return real_index(tree, b)

        monkeypatch.setattr(runner, "_index", shifted)
        return 1
    if name == "compaction_reverses_rows":
        real_compact = runner._compact_masked_rows

        def reversed_rows(rows, mask, cap):
            comp, counts = real_compact(rows, mask, cap)
            return comp.flip(-2), counts

        monkeypatch.setattr(runner, "_compact_masked_rows", reversed_rows)
        return 1
    if name == "seed_with_zero_avg_len":
        real_init = runner.init_pipeline_state

        def zero_avg(first_gray, cfg):
            st = real_init(first_gray, cfg)
            return st._replace(avg_len=torch.zeros_like(st.avg_len))

        monkeypatch.setattr(runner, "init_pipeline_state", zero_avg)
        return 1
    # a trip of 20 frames in chunks of 12: the third chunk recycles
    real_swap = runner._swap_slot

    def next_slot(states, fresh, b):
        if isinstance(states, torch.Tensor):
            return real_swap(states, fresh, (b + 1) % states.shape[0])
        return type(states)(*(next_slot(s, f, b)
                              for s, f in zip(states, fresh)))

    monkeypatch.setattr(runner, "_swap_slot", next_slot)
    return 3


@pytest.mark.parametrize("name, caught_by", [
    ("drain_reads_the_next_stream",
     {"drained_row_off_share", "drain_mismatch"}),
    ("compaction_reverses_rows",
     {"drained_row_off_share", "drain_mismatch"}),
    ("seed_with_zero_avg_len", {"seed_state_mismatch"}),
    ("recycle_into_the_next_slot", {"seed_state_mismatch"})])
def test_a_planted_serving_fault_is_caught(name, caught_by, monkeypatch):
    """Faults after the step (the compaction, the drain's slicing) and in
    the seeding of slots (the first feed, assign_stream) are held to the
    reference too, not only the step."""
    torch.set_num_threads(1)
    chunks = _serving_fault(name, monkeypatch)
    spec = tiny_fleet_spec()
    cell = run_chunks(spec, chunks, seed=SEED)
    if chunks == 3:
        assert cell.recycled is not None
    out = cell.compare()
    assert caught_by <= _failed(out, spec), out


def test_vp_off_share_sees_a_minority_of_streams():
    """A VP moved on one stream of four leaves the median gap at the
    rounding; the share of VPs off reads it."""
    spec = tiny_fleet_spec()
    limits = spec.traffic["check"]["limits"]
    b, n = 4, 3
    want = dict(surv=torch.ones(b, n, dtype=torch.bool),
                pts=torch.zeros(b, n, 2, dtype=torch.float64),
                replenish=torch.zeros(b, dtype=torch.bool),
                next_valid=torch.ones(b, 2, 1, dtype=torch.bool),
                n_cp=torch.zeros(b), n_upd=torch.zeros(b),
                vp_xy=torch.full((b, 2), 100.0, dtype=torch.float64),
                vp_init=torch.ones(b, dtype=torch.bool),
                cp_rows=torch.zeros(b, 0, 2, dtype=torch.float64),
                cp_ok=torch.zeros(b, 0, dtype=torch.bool),
                upd_rows=torch.zeros(b, 0, 2, dtype=torch.float64),
                upd_ok=torch.zeros(b, 0, dtype=torch.bool),
                show_row=torch.full((b, 2), 100.0, dtype=torch.float64),
                shown=torch.zeros(b, dtype=torch.bool))
    got = dict(want, vp_xy=want["vp_xy"] + torch.tensor(
        [[0.0, 1e-5]] * 3 + [[0.0, 0.2]], dtype=torch.float64))
    tally = ref.Tally()
    for _ in range(10):
        tally.add(got, want)
    out = tally.numbers()
    assert out["vp_gap_px"] <= limits["vp_gap_px"]
    assert out["vp_off_share"] == 0.25 > limits["vp_off_share"]


def test_the_bf16_control_fails():
    torch.set_num_threads(1)
    spec = tiny_fleet_spec()
    out = harness.run_control(spec, seed=SEED, device="cpu")
    assert out["correct"] is False, out
    assert "replay_mismatch" not in out["compared"]
