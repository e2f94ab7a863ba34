"""What the per-pair CUDA graph costs when a caller uses several keys.

Run on a CUDA card from the repo root:

    python scripts/exp_pair_graph_keys.py

Path A (the entry point's config) at eight frame sizes, one key each.
Prints, with the card's name and power limit:

1. one key's calls at 1080x1920: the first (op by op), the capturing call,
   a replay, and an op-by-op call (``_pair_eager``), host wall of each
   call with the device synchronized on both sides (median of 30 where
   repeated); the memory the capture adds (allocated and reserved), and
   whether the capture leaves the allocator's other cached blocks alone;
2. the ms per call when K keys cycle (K = 1, 4, 5, 8), round robin and in
   runs of two calls per key, with ``PAIR_GRAPHS`` 4 and 8, against the
   same sequence op by op.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lk_tpu_torch.entry import CFG, DENSE_CFG
from lk_tpu_torch.flow import dense

SIZES = [(1080, 1920), (720, 1280), (483, 861), (540, 960), (1088, 1920),
         (600, 800), (360, 640), (900, 1600)]


CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()


def pair(h, w, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((h, w), device="cuda", generator=g) * 255
    return a, torch.roll(a, (1, 2), (0, 1))


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def one_key():
    prev, nxt = pair(1080, 1920, 0)

    def graph():
        return dense.dense_pyramidal_lk(prev, nxt, CFG, dense_cfg=DENSE_CFG)

    def eager():
        return dense._pair_eager(prev, nxt, CFG, DENSE_CFG, None)

    dense._pair_graphs.clear()
    first = wall_ms(graph)
    # blocks the allocator caches but no tensor holds: an empty_cache
    # would give them back
    spare = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    del spare
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    capture = wall_ms(graph)
    alloc1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    replay = statistics.median(wall_ms(graph) for _ in range(30))
    op_by_op = statistics.median(wall_ms(eager) for _ in range(30))
    print(f"[one key] 1080x1920 path A: first call {first:.3f} ms, capturing "
          f"call {capture:.3f} ms, replay {replay:.3f} ms, op by op "
          f"{op_by_op:.3f} ms (medians of 30); the capture costs "
          f"{capture - replay:.3f} ms, the saving of "
          f"{(capture - replay) / (op_by_op - replay):.1f} replays; it adds "
          f"{(alloc1 - alloc0) / 2**20:.1f} MiB allocated, {(res1 - res0) / 2**20:.1f} MiB reserved "
          f"(negative: the allocator's cache was emptied)  [{CARD}]",
          flush=True)


def cycle(keys, pattern, rounds, fn):
    """ms per call of fn over ``rounds`` passes of the key sequence."""
    seq = [k for k in keys for _ in range(2)] if pattern == "runs of 2" \
        else list(keys)
    for k in seq:               # warm: every key's first calls
        fn(*k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for k in seq:
            fn(*k)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (rounds * len(seq))


def cycles():
    pairs = [pair(h, w, i) for i, (h, w) in enumerate(SIZES)]

    def graph(prev, nxt):
        dense.dense_pyramidal_lk(prev, nxt, CFG, dense_cfg=DENSE_CFG)
        torch.cuda.synchronize()     # a request waits for its field

    def eager(prev, nxt):
        dense._pair_eager(prev, nxt, CFG, DENSE_CFG, None)
        torch.cuda.synchronize()

    keep = dense.PAIR_GRAPHS
    for n in (1, 4, 5, 8):
        keys = pairs[:n]
        for pattern in ("round robin", "runs of 2"):
            base = cycle(keys, pattern, 20, eager)
            for size in (4, 8):
                dense.PAIR_GRAPHS = size
                dense._pair_graphs.clear()
                dense.reset_counters()
                ms = cycle(keys, pattern, 20, graph)
                c = dense.pair_graph_counts
                print(f"[cycle] {n} keys, {pattern}, PAIR_GRAPHS {size}: "
                      f"{ms:.3f} ms a call against {base:.3f} op by op "
                      f"({ms / base - 1:+.1%}); captures {c['captures']}, "
                      f"replays {c['replays']}, eager {c['eager']}  "
                      f"[{CARD}]", flush=True)
    dense.PAIR_GRAPHS = keep


if __name__ == "__main__":
    pair(64, 64, 0)
    dense.dense_pyramidal_lk(*pair(270, 480, 9), CFG, dense_cfg=DENSE_CFG)
    one_key()
    cycles()
