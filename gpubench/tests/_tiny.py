"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the same
drivers, readers and references, the program's plain versions."""

from __future__ import annotations

import copy

import torch

from gpubench import harness


def tiny_spec(workload: str, dense_hw=(96, 160)) -> harness.Spec:
    spec = harness.load_spec(workload)
    c, t = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    c["height"], c["width"] = dense_hw
    t["frames_per_clip"] = 6
    t["texture"]["margin"] = 16
    t.update(warmup_calls=1, warmup_requests=1, trace_calls=2,
             trace_requests=3)
    t["check"].update(pairs_per_scene=2, requests=2)
    spec.config, spec.traffic = c, t
    return spec


def run(workload: str, seed: int = 3, **kw) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(tiny_spec(workload, **kw), seed=seed,
                            seconds=0.2, trace=False, device="cpu")
