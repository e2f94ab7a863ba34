"""The single-stream cell cut to a size the CPU runs in seconds: clips of
24 frames of 640x360 BGR processed at 320x180, in chunks of 8 with a drain
every 2 chunks; the same driver, reference and readers, the program's
plain versions."""

from __future__ import annotations

import copy

from gpubench import harness

CELL = "vp860solo.trip1080"


def tiny_solo_spec() -> harness.Spec:
    spec = harness.load_spec(CELL)
    c, t = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    c.update(src_height=360, src_width=640, height=180, width=320, chunk=8,
             drain_every=2)
    c["pipeline"]["width"] = 320
    t.update(clip_frames=24)
    t["scenes"].update(texels_around=512, texels_along=256)
    spec.config, spec.traffic = c, t
    return spec


def run_clips(spec, clips: int = 1, seed: int = 2 ** 31 + 9,
              device: str = "cpu"):
    """A cell after ``clips`` whole clips, released for its check."""
    cell = harness.make_cell(spec, seed, device)
    cell.setup()
    cell._reset()
    for _ in range(clips):
        cell.step()
    cell.release()
    return cell
