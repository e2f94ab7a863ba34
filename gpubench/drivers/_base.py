"""What every driver shares: the configs built from a configuration file,
the measured window and the traced one.

A driver module defines ``Cell(config, traffic, seed, device)`` with
``make_inputs()`` (the seeded inputs only), ``setup()`` (inputs, the
program's import and the warm-up of this cell's shapes), ``step()`` (one
unit of work through the program), ``metrics()`` (its end-to-end
metrics over the window), ``units()`` (the work of the window, for the
per-layer readers), ``release()`` and ``compare(control=False)`` (the
numbers held to the traffic file's limits).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def lk_configs(mod, config: dict):
    """(LKConfig, DenseLKConfig) of a dense configuration file, built from
    the config module ``mod`` (the program's or the reference's)."""
    return (mod.LKConfig(**_tuples(config["lk"])),
            mod.DenseLKConfig(**_tuples(config["dense"])))


def sample(rng: np.random.Generator, n: int, k: int, always=()) -> list:
    """k distinct indices below n drawn from ``rng``, ``always`` among them."""
    picked = [i for i in always if 0 <= i < n]
    rest = [i for i in rng.permutation(n).tolist() if i not in picked]
    return sorted(picked + rest[:max(0, k - len(picked))])


class CellBase:
    """The window loops and the bookkeeping every driver shares."""

    unit = "units"             # what step() completes, for units()
    trace_key = "trace_units"  # traffic key: units in the traced window

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # host-side choices (which outputs to keep) drawn from the seed
        self.rng = np.random.default_rng(self.seed % (2 ** 63))
        self.attempted = 0
        self.failed = 0
        self.window_s = 0.0
        self.done = 0            # units completed in the current window

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        """Units back to back until ``seconds`` have passed, then until the
        last one has finished on the device; ``window_s`` covers all."""
        self.done = 0
        self.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self.step()
            self.done += 1
            if time.perf_counter() >= deadline:
                break
        self.sync()
        self.window_s = time.perf_counter() - t0

    def traced_window(self) -> None:
        """The traffic file's fixed number of units, for the trace."""
        self.done = 0
        for _ in range(self.traffic[self.trace_key]):
            with record_function(f"bench.{self.unit}"):
                self.step()
            self.done += 1

    def release(self) -> None:
        """Free what the program holds before the reference runs; what it
        answered stays."""
        self.program = None
        if self.cuda:
            torch.cuda.empty_cache()
