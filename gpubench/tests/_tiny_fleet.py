"""The fleet cell cut to a size the CPU runs in seconds: 4 streams of
320x180 trips of 20 frames in chunks of 12, the same driver, reference and
readers, the program's plain versions."""

from __future__ import annotations

import copy

from gpubench import harness

CELL = "vp860.fleet64"


def tiny_fleet_spec() -> harness.Spec:
    spec = harness.load_spec(CELL)
    c, t = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    # a first chunk of 12 frames holds the forced replenish of step 11
    c.update(height=180, width=320, chunk=12, drain_every=2)
    c["pipeline"]["width"] = 320
    t.update(streams=4, trip_frames=20, trace_chunks=2)
    t["scenes"].update(texels_around=512, texels_along=256)
    t["check"]["block_streams"] = 4
    spec.config, spec.traffic = c, t
    return spec


def run_chunks(spec, chunks: int, seed: int = 2 ** 31 + 9):
    """A CPU cell after ``chunks`` chunks of a window, released for its
    check."""
    cell = harness.make_cell(spec, seed, "cpu")
    cell.setup()
    cell._reset()
    for _ in range(chunks):
        cell.step()
    cell.server.drain()
    cell.release()
    return cell
