"""On-demand dense flow: one client asks for one pair's flow at a time
(a closed loop), each pair already on the device, drawn from the staged
clips in an order set by the seed; every request runs
``dense_pyramidal_lk`` (the per-pair path, ``entry()``'s program) and
ends in a ``torch.cuda.synchronize()``.

A request's latency is read from CUDA events recorded on the stream
before the call and after it: the stream is idle when a request starts,
so the first event marks its submission and the second the end of its
last kernel, and every host gap between its launches lies between them.
End-to-end: the 95th percentile of all requests in the window.  The
check compares a sample of the window's requests, drawn from the seed by
a reservoir over the whole window."""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import scenes
from gpubench.drivers._base import CellBase, lk_configs
from gpubench.reference import dense as ref


class Cell(CellBase):
    unit = "request"
    trace_key = "trace_requests"

    def make_inputs(self) -> None:
        c = self.config
        self.clips = scenes.dense_scenes(self.traffic, c["height"], c["width"],
                                         self.seed, self.device)
        pairs = [(s, t) for s in range(len(self.clips))
                 for t in range(self.clips[s].shape[0] - 1)]
        self.order = [pairs[i] for i in self.rng.permutation(len(pairs))]
        self.k = self.traffic["check"]["requests"]
        self.kept = []          # (request index, (scene, t), result)
        self.latencies_ms = []
        self.requests = 0

    def setup(self) -> None:
        from lk_tpu_torch import config as port_config
        from lk_tpu_torch.flow import dense

        self.make_inputs()
        self.program = dense
        self.lk, self.dense_cfg = lk_configs(port_config, self.config)
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        for i in range(self.traffic["warmup_requests"]):
            s, t = self.order[i % len(self.order)]
            dense.dense_pyramidal_lk(self.clips[s][t], self.clips[s][t + 1],
                                     self.lk, dense_cfg=self.dense_cfg)
        self.sync()

    def step(self) -> None:
        i = self.requests
        s, t = self.order[i % len(self.order)]
        prev, nxt = self.clips[s][t], self.clips[s][t + 1]
        if self.cuda:
            self.ev[0].record()
            r = self.program.dense_pyramidal_lk(prev, nxt, self.lk,
                                                dense_cfg=self.dense_cfg)
            self.ev[1].record()
            torch.cuda.synchronize(self.device)
            ms = self.ev[0].elapsed_time(self.ev[1])
        else:
            t0 = time.perf_counter()
            r = self.program.dense_pyramidal_lk(prev, nxt, self.lk,
                                                dense_cfg=self.dense_cfg)
            ms = (time.perf_counter() - t0) * 1e3
        self.latencies_ms.append(ms)
        self.requests += 1
        self.attempted += 1
        # reservoir sampling of k requests over the whole window
        if len(self.kept) < self.k:
            self.kept.append((i, (s, t), r))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = (i, (s, t), r)

    def window(self, seconds: float) -> None:
        self.latencies_ms = []
        super().window(seconds)

    def metrics(self) -> dict:
        return {"pair_ms_p95":
                float(np.percentile(np.asarray(self.latencies_ms), 95))}

    def units(self) -> dict:
        return {"pairs": self.done, "requests": self.done}

    def compare(self, control: bool = False) -> dict:
        worst = {}
        if control:
            picks = [(i, self.order[i % len(self.order)], None)
                     for i in range(self.k)]
        else:
            picks = self.kept
        if not picks:
            raise RuntimeError("the window kept no flow to compare")
        for _, (s, t), r in picks:
            prev, nxt = self.clips[s][t], self.clips[s][t + 1]
            want = ref.pair_flow(prev, nxt, self.config)
            got = (ref.pair_flow(prev, nxt, self.config, low_precision=True)
                   if control else (r.flow, r.min_eig, r.valid))
            for k, v in ref.gaps(got, want, self.config).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
