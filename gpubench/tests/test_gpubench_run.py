"""Runs of the harness: the result line's keys, no fallback to the CPU,
and the check's two sides — the control (the reference in bfloat16) and
the faults a cell can have, each planted in the program under a run at a
size the CPU holds, must come out not correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from gpubench import harness
from gpubench.tests._tiny import run, tiny_spec

CELLS = ["dense1080.video", "dense1080.pair"]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    out = run(cell)
    assert list(out) == KEYS        # the compared numbers come last
    assert out["correct"] is True
    spec = harness.load_spec(cell)
    assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


def test_no_card_no_result(no_card):
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "dense1080.pair",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "is_available() is False" in p.stderr


# the control at 270x480
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    torch.set_num_threads(2)
    spec = tiny_spec(cell, dense_hw=(270, 480))
    out = harness.run_control(spec, seed=5, device="cpu")
    assert out["correct"] is False, out


def _frozen_flow(module, name):
    real = getattr(module, name)

    def frozen(*a, **kw):
        r = real(*a, **kw)
        return r._replace(flow=torch.zeros_like(r.flow))

    return frozen


def _half_pairs(module, name):
    real = getattr(module, name)

    def half(*a, **kw):
        r = real(*a, **kw)
        n = r.flow.shape[0]
        flow = r.flow.clone()
        flow[n // 2:] = r.flow[:n - n // 2]
        return r._replace(flow=flow)

    return half


def _altered_flow(module, name):
    real = getattr(module, name)

    def altered(*a, **kw):
        r = real(*a, **kw)
        flow = r.flow.clone()
        flow[..., 5, 7, 0] += 1.0
        return r._replace(flow=flow)

    return altered


def _fault(name):
    """(cell, module, attribute, wrapper maker) of each planted fault."""
    from lk_tpu_torch.flow import dense

    return {
        "video_state_unchanged": ("dense1080.video", dense,
                                  "dense_pyramidal_lk_video", _frozen_flow),
        "video_half_the_pairs": ("dense1080.video", dense,
                                 "dense_pyramidal_lk_video", _half_pairs),
        "video_answer_altered": ("dense1080.video", dense,
                                 "dense_pyramidal_lk_video", _altered_flow),
        "pair_state_unchanged": ("dense1080.pair", dense,
                                 "dense_pyramidal_lk", _frozen_flow),
        "pair_answer_altered": ("dense1080.pair", dense,
                                "dense_pyramidal_lk", _altered_flow),
    }[name]


@pytest.mark.parametrize("name", [
    "video_state_unchanged", "video_half_the_pairs", "video_answer_altered",
    "pair_state_unchanged", "pair_answer_altered"])
def test_a_planted_fault_is_not_correct(name, monkeypatch):
    cell, module, attr, maker = _fault(name)
    monkeypatch.setattr(module, attr, maker(module, attr))
    out = run(cell)
    assert out["correct"] is False, out["compared"]


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "dense1080.pair",
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
