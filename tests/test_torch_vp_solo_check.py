"""The check of gpubench's single-stream cell (``vp860solo.trip1080``) on
the CPU, at clips of 24 frames of 640x360 BGR processed at 320x180
(``gpubench/tests/_tiny_solo.py``): the device preprocess against the
float64 reference's (a); a whole clip through ``VideoPipeline.run`` (op by
op off the card), each step teacher-forced from the program's own state
and held to the float64 reference's step (c), its sinks to the step's
outputs and the reference's rows, its seeded state to (d); the
frame-by-frame replay against the chunked run; faults planted in the
program, which the check must catch, in the preprocess, the tracker, the
VP and the drain; and the bfloat16 control, which must fail it.

The limits are the cell's own (``gpubench/traffic/trip1080.json``).  The
reference is written from lk_tpu's stated semantics, not from the port,
so the clean run is two independent readings of one step: float64
against float32 leaves gaps of ~1e-5 px.
"""

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.reference import vp as vp_ref
from gpubench.reference import vp_solo as ref
from gpubench.tests._tiny_solo import run_clips, tiny_solo_spec
from lk_tpu_torch.models import PRESETS
from lk_tpu_torch.pipeline import runner, step

SEED = 2 ** 31 + 9
# float32 against float64 in gray levels (0..255): the gray's products
# round at ~1.5e-5, and each resized pixel sums ~6 source pixels' products
# with weights that sum to 1, and the blur 9 more: a few ulps of 255
PRE_TOL = 1e-3


def _failed(out: dict, spec) -> set:
    """The compared numbers above their limits."""
    limits = spec.traffic["check"]["limits"]
    return {k for k, v in out.items() if v > limits[k]}


@pytest.fixture(scope="module")
def clean():
    """One whole clip (23 steps) of the tiny cell, checked, with the
    reference's VP updates and replenishments counted."""
    torch.set_num_threads(1)
    seen = dict(updates=0, replenished=0)
    real = vp_ref.Tally.add

    def add(self, got, want):
        seen["updates"] += int(want["n_upd"].sum())
        seen["replenished"] += int(want["replenish"].sum())
        real(self, got, want)

    spec = tiny_solo_spec()
    cell = run_clips(spec, seed=SEED)
    vp_ref.Tally.add = add
    try:
        out = cell.compare()
    finally:
        vp_ref.Tally.add = real
    return spec, cell, out, seen


@pytest.mark.parametrize("src_hw, out_hw", [((97, 173), (41, 71)),
                                            ((360, 640), (180, 320))])
def test_the_preprocess_holds_to_the_reference(src_hw, out_hw):
    """``preprocess_frame`` (gray, INTER_AREA at a non-integer and at an
    integer ratio, the 3x3 Gaussian) on seeded BGR frames against the
    float64 reference (a)."""
    rng = np.random.default_rng(src_hw[0])
    bgr = torch.from_numpy(rng.integers(0, 256, (3,) + src_hw + (3,),
                                        dtype=np.uint8))
    got = step.preprocess_frame(bgr, PRESETS["final"], *out_hw)
    want = ref.preprocess(bgr, *out_hw)
    assert got.shape == want.shape == (3,) + out_hw
    assert float((got.to(torch.float64) - want).abs().max()) < PRE_TOL


def test_the_program_holds_to_the_reference(clean):
    spec, cell, out, seen = clean
    assert not _failed(out, spec), out
    # the steps worked the whole machine: tracking, VP updates, replenish
    assert seen["updates"] > 0 and seen["replenished"] > 0
    assert out["no_replenish"] == 0 and out["no_vp_share"] < 0.25
    assert 0 < out["pts_mean_gap_px"] < 1e-4, out
    assert 0 < out["gray_gap"] < PRE_TOL, out
    assert out["slot_mismatch_share"] == 0, out
    assert cell.units_done == dict(clips=1, frames=23, uploaded=24)


def test_the_replay_equals_the_chunked_run(clean):
    """Every chunk of the clip replayed frame by frame through the runner
    gives the timed chunk's outputs and end state bit for bit, frame for
    frame; a changed output or end state is counted."""
    _, cell, out, _ = clean
    assert out["replay_mismatch"] == 0
    pipe = cell.kept
    assert [k["grays"].shape[0] for k in pipe.chunks] == [8, 8, 8]
    for k, kept in enumerate(pipe.chunks):
        _, frames, per_frame = cell._replay(pipe, k, None)
        assert len(per_frame) == frames.shape[0] == 7 + (k > 0)
    kept = pipe.chunks[1]
    saved = kept["outs"]
    kept["outs"] = saved._replace(live_count=saved.live_count + 1)
    try:
        tally = vp_ref.Tally()
        cell._replay(pipe, 1, tally)
    finally:
        kept["outs"] = saved
    assert tally.replay_mismatch == 1


def _plant(name, monkeypatch) -> set:
    """Plant a fault in the program; returns the numbers that must catch
    it."""
    if name == "red_and_blue_swapped":
        real = step.bgr_to_gray
        monkeypatch.setattr(step, "bgr_to_gray",
                            lambda bgr: real(bgr.flip(-1)))
        return {"gray_gap"}
    if name == "nearest_for_area_resize":
        def nearest(img, h, w):
            ys = (torch.arange(h) * img.shape[-2]) // h
            xs = (torch.arange(w) * img.shape[-1]) // w
            return img[..., ys[:, None], xs[None, :]]

        monkeypatch.setattr(step, "resize_area", nearest)
        return {"gray_gap"}
    if name == "superwindow_clamp":
        # the batched tracker in place of the whole-level one, its
        # superwindow narrowed to 18 x 18: at 32 x 48 no window of these
        # scenes reaches its edge (a point moves < 8 px at every level), so
        # the two trackers agree within rounding and there is no fault
        from lk_tpu_torch.flow import sparse

        def batched(prev, nxt, pts, valid, cfg):
            p1, st, err = sparse.track_points_batched(
                prev[None], nxt[None], pts[None], valid[None], cfg)
            return p1[0], st[0], err[0]

        monkeypatch.setattr(step, "track_points", batched)
        monkeypatch.setattr(sparse, "_SW_ROWS", 18)
        monkeypatch.setattr(sparse, "_SW_COLS", 18)
        return {"pts_gap_px", "pts_mean_gap_px"}
    if name == "vp_moved_0.2_px":
        real = step.vp_show_step

        def moved(vp, geom, cfg):
            vp, geom = real(vp, geom, cfg)
            shift = torch.tensor([0.2, 0.0])
            return vp._replace(vp_xy=torch.where(
                vp.vp_init[:, None], vp.vp_xy + shift, vp.vp_xy)), geom

        monkeypatch.setattr(step, "vp_show_step", moved)
        return {"vp_gap_px", "vp_off_share"}
    # the drain books frame t + 1's rows at frame t
    real = runner.VideoPipeline._drain

    def next_frame(self, outs, n_valid=None):
        return real(self, type(outs)(*(torch.roll(x, -1, 0) for x in outs)),
                    n_valid)

    monkeypatch.setattr(runner.VideoPipeline, "_drain", next_frame)
    return {"drain_mismatch", "drained_row_off_share"}


@pytest.mark.parametrize("name", ["red_and_blue_swapped",
                                  "nearest_for_area_resize",
                                  "superwindow_clamp", "vp_moved_0.2_px",
                                  "drain_books_the_next_frame"])
def test_a_planted_fault_is_caught(name, monkeypatch):
    torch.set_num_threads(1)
    caught_by = _plant(name, monkeypatch)
    spec = tiny_solo_spec()
    out = run_clips(spec, seed=SEED).compare()
    assert caught_by <= _failed(out, spec), out


def test_the_bf16_control_fails():
    torch.set_num_threads(1)
    spec = tiny_solo_spec()
    out = harness.run_control(spec, seed=SEED, device="cpu")
    assert out["correct"] is False, out
    failed = {k for k, v in out["compared"].items()
              if v["value"] > v["limit"]}
    assert {"gray_gap", "pts_mean_gap_px", "seed_state_mismatch"} <= failed
    assert "replay_mismatch" not in out["compared"]
