"""VP serving of a fleet of dashcams: ``MultiStreamPipeline`` fed from a
time-major u8 staging of every stream's trip on the device, as
``apps/serve.py`` runs it (``feed_staged`` and ``drain``), in a closed loop
with every slot busy.

Each of the ``streams`` slots carries a trip of ``trip_frames`` frames of
its forward-driving scene (``road_scenes.py``), all staged before the
window.  A trip's first frame seeds the slot (the first feed, or
``assign_stream`` when a slot takes a new trip); its other frames run in
chunks of the configuration's ``chunk`` frames, the last chunk shorter.
When the trips end, the staged set is rotated by one stream in place and
every slot takes its new trip through ``assign_stream``, as a fleet node
does when an upload ends.  End-to-end: stream-frame steps (each one frame
pair of one stream through the whole VP step) over the window, which ends
when the last chunk's outputs are drained into the host sinks and the
device is synchronised.

The check: at the window's first full chunk, the first chunk after the
slots were recycled (when the window recycles them) and the window's last
chunk, the driver keeps the chunk-start state the run carried, the chunk's
staged frames, its outputs and the sinks they drain into.  After the
window the program replays each kept chunk from that state frame by frame
through the same runner; the replay must give the chunk's outputs and end
state bit for bit (``replay_mismatch``).  From each replayed frame's state
the float64 reference (``reference/vp.py``) takes one step, and
``reference.vp.Tally`` holds the program's step to it, and the rows the
sinks received for the frame (compacted on the device, drained and sliced
on the host) to the reference's rows.  A chunk that opens trips also holds
the state each slot was seeded with (the first feed, or ``assign_stream``)
to the reference's seeded state on the trip's first frame.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpubench.drivers._base import CellBase, _tuples
from gpubench.reference import vp as ref
from gpubench.road_scenes import RoadScenes


def program_config(config: dict):
    """The program's ``PipelineConfig`` of a VP configuration file."""
    from lk_tpu_torch import config as pc

    return pc.PipelineConfig(
        **_tuples(config["pipeline"]), lk=pc.LKConfig(**_tuples(config["lk"])),
        features=pc.FeatureConfig(**config["features"]),
        roi=pc.ROIConfig(**config["roi"]))


def clone(tree):
    """A deep copy of a NamedTuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone(x) for x in tree))


def _state_dict(states, lo: int, hi: int) -> dict:
    """Streams lo..hi of the program's state, as the reference reads it."""
    d = {k: getattr(states, k)[lo:hi]
         for k in ("pts", "valid", "avg_len", "tp_ult")}
    d["vp"] = {k: v[lo:hi] for k, v in states.vp._asdict().items()}
    return d


def _program_step(outs, after, rows: list, lo: int, hi: int) -> dict:
    """Streams lo..hi of one program step, in the reference's terms: the
    frame's uncompacted outputs, the state after it and the rows its sinks
    received (``rows``, per stream).  Replenishment is read from the state:
    a stream replenished exactly when its next slots are not its surviving
    tracked points."""
    b = hi - lo
    surv = outs.pts_valid[lo:hi]
    kept = torch.where(surv[..., None], outs.pts[lo:hi], 0.0)
    nv, npts = after.valid[lo:hi], after.pts[lo:hi]
    same = ((nv == surv).reshape(b, -1).all(1)
            & (npts == kept).reshape(b, -1).all(1))
    trigger = after.tp_ult[lo:hi] == 1
    return dict(pts=outs.pts[lo:hi].reshape(b, -1, 2),
                surv=surv.reshape(b, -1),
                n_cp=outs.cp_mask[lo:hi].sum(-1),
                n_upd=outs.update_mask[lo:hi].sum(-1),
                vp_xy=after.vp.vp_xy[lo:hi], vp_init=after.vp.vp_init[lo:hi],
                trigger=trigger, replenish=trigger & ~same, next_pts=npts,
                next_valid=nv, rows=rows[lo:hi])


def _sink_rows(values, counts, head: bool):
    """The ``counts.sum()`` rows at the head or the tail of a sink's list,
    split by ``counts``; None where the list holds fewer."""
    total = int(counts.sum())
    if len(values) < total:
        return None
    got = values[:total] if head else values[len(values) - total:]
    got = np.asarray(got, np.float64).reshape(-1, 2)
    return np.split(got, np.cumsum(counts)[:-1])


def _differing(a, b) -> int:
    """Leaves of two NamedTuples of tensors that are not equal."""
    if a is None or b is None:
        return int(a is not b)
    if isinstance(a, torch.Tensor):
        return int(not (a.shape == b.shape and torch.equal(a, b)))
    return sum(_differing(x, y) for x, y in zip(a, b))


class Cell(CellBase):
    unit = "chunk"
    trace_key = "trace_chunks"

    def make_inputs(self) -> None:
        c, t = self.config, self.traffic
        self.streams = t["streams"]
        self.trip = t["trip_frames"]
        self.chunk = c["chunk"]
        self.scenes = RoadScenes(t, c["height"], c["width"], self.seed,
                                 self.device)
        self.staging = self.scenes.frames(0, self.trip)
        self.pos = 0                # the next frame of the current trips
        self.first = self.recycled = self.last = None
        self._needs_after = None    # a kept chunk whose end state comes next
        self.units_done = dict(chunks=0, stream_frames=0, frame_steps=0,
                               finish_frames=0, pyramid_builds=0)

    def _load_program(self) -> None:
        """The program's runner; a program whose serving runner cannot
        replay a chunk frame by frame cannot run this cell's check, and
        fails here, before anything is staged or built."""
        import inspect

        from lk_tpu_torch.pipeline import runner

        self.program = runner
        self.cfg = program_config(self.config)
        run = runner.make_batched_chunk_runner(
            self.cfg, (self.config["width"], self.config["height"]),
            self.device)[0]
        if "frame_hook" not in inspect.signature(run).parameters:
            raise RuntimeError("this program's batched chunk runner takes no "
                               "frame_hook: the cell's replay needs it")
        self.finish = runner._cached_finish(self.cfg)

    def setup(self) -> None:
        self._load_program()
        self.make_inputs()
        # the warm-up, on a throwaway server: a trip's first feed and full
        # chunk, its last (shorter) chunk, the drain and a slot's recycling
        warm = self._server()
        warm.feed_staged(self.staging, 0, self.chunk + 1)
        tail = (self.trip - 1) % self.chunk
        if tail:
            warm.feed_staged(self.staging, self.trip - tail, tail)
        warm.drain()
        warm.assign_stream(0, self.finish(self.staging[0, :1])[0])
        self.sync()
        self.server = self._server()

    def _server(self):
        c = self.config
        s = self.program.MultiStreamPipeline(
            self.cfg, src_size=(c["src_width"], c["src_height"]),
            n_streams=self.streams, chunk=self.chunk, device=self.device)
        s.drain_every = c["drain_every"]
        if (s.height, s.width) != (c["height"], c["width"]):
            raise RuntimeError(f"the pipeline processes {s.width}x{s.height}, "
                               f"the configuration {c['width']}x{c['height']}")
        return s

    # -- the traffic -------------------------------------------------------

    def _start_trips(self) -> None:
        """Seed every slot with the first frame of its trip: the first feed,
        or, once the trips have run, the staged set rotated by one stream
        and every slot recycled with ``assign_stream``."""
        s = self.server
        if s.states is None:
            s.feed_staged(self.staging, 0, 1)
        else:
            for t0 in range(0, self.trip, self.chunk):
                blk = self.staging[t0:t0 + self.chunk]
                blk.copy_(torch.roll(blk, -1, dims=1))
            first = self.finish(self.staging[0])
            for b in range(self.streams):
                s.assign_stream(b, first[b])
        self.units_done["finish_frames"] += self.streams
        self.pos = 1

    def step(self) -> None:
        if self._needs_after is not None:
            self._needs_after["after"] = clone(self.server.states)
            self._needs_after = None
        seeded = self.pos == 0
        recycled = seeded and self.server.states is not None
        if seeded:
            self._start_trips()
        n = min(self.chunk, self.trip - self.pos)
        # a seeded chunk's sinks are fresh: its rows open them
        kept = dict(start=clone(self.server.states),
                    frames=self.staging[self.pos - 1:self.pos + n].clone(),
                    seeded=seeded, sinks=list(self.server.pipes))
        self.server.feed_staged(self.staging, self.pos, n)
        kept["outs"] = self.server.last_outputs
        if self.first is None and n == self.chunk:
            self.first = self._needs_after = kept
        else:
            if recycled and self.recycled is None:
                self.recycled = self._needs_after = kept
            self.last = kept
        self.pos = (self.pos + n) % self.trip
        u = self.units_done
        u["chunks"] += 1
        u["stream_frames"] += n * self.streams
        u["frame_steps"] += n
        u["finish_frames"] += n * self.streams
        u["pyramid_builds"] += n + 1
        self.attempted += n * self.streams

    def _reset(self) -> None:
        self.first = self.recycled = self.last = self._needs_after = None
        for k in self.units_done:
            self.units_done[k] = 0

    def window(self, seconds: float) -> None:
        """Chunks back to back until ``seconds`` have passed; then the
        outputs still on the device are drained into the sinks and the
        device is synchronised, inside the window."""
        self._reset()
        self.done = 0
        self.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self.step()
            self.done += 1
            if time.perf_counter() >= deadline:
                break
        self.server.drain()
        self.sync()
        self.window_s = time.perf_counter() - t0

    def traced_window(self) -> None:
        self._reset()
        super().traced_window()
        self.server.drain()

    def metrics(self) -> dict:
        return {"flow_pairs_per_s":
                self.units_done["stream_frames"] / self.window_s}

    def units(self) -> dict:
        return dict(self.units_done, streams=self.streams,
                    points=self.streams * self.cfg.tp_num)

    def release(self) -> None:
        """The staging and the sinks go; the kept chunks and the runner
        stay for the replay."""
        for kept in self._samples():
            if "after" not in kept:
                kept["after"] = self.server.states
        print(f"gpubench: {self.server.spilled_chunks} stream-chunks over "
              f"out_cap, drained from their spill", file=sys.stderr)
        self.staging = self.scenes = None
        self.server.pipes = self.server.retired = []
        if self.cuda:
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def _samples(self) -> list:
        out = []
        for kept in (self.first, self.recycled, self.last):
            if kept is not None and all(kept is not k for k in out):
                out.append(kept)
        return out

    def _control_samples(self) -> list:
        """The control's chunks: the program steps the first two chunks of
        the seed's trips untimed (no window has run)."""
        self._load_program()
        self.server = self._server()
        for _ in range(2):
            self.step()
        return self._samples()

    def _replay(self, kept: dict, tally: ref.Tally | None):
        """Step a kept chunk again from its start state, frame by frame;
        returns the per-frame (outputs, state after) and adds the
        replay's differences from the timed chunk to ``tally``."""
        frames = kept["frames"][1:]
        n, b = frames.shape[:2]
        g = self.finish(frames.reshape((n * b,) + frames.shape[2:]))
        g = g.reshape((n, b) + g.shape[1:]).transpose(0, 1)
        per_frame = []

        def hook(t, after, outs):
            per_frame.append((outs, after._replace(prev_gray=None)))

        end, outs = self.server._run(clone(kept["start"]), g, frame_hook=hook)
        if tally is not None:
            bad = _differing(outs, kept["outs"])
            if "after" in kept:
                bad += _differing(end, kept["after"])
            tally.replay_mismatch += bad
        return per_frame

    def _drained(self, kept: dict, per_frame: list,
                 tally: ref.Tally) -> list:
        """Per frame of a kept chunk, per stream, the rows its sink
        received for the frame (``reference.vp.frame_rows``'s form), split
        by the program's per-frame counts; None for every frame of a
        stream whose sink holds fewer.  A seeded chunk's rows open its
        fresh sinks; any other kept chunk is the window's last, whose rows
        close them.  Adds to ``tally.drain_mismatch`` the stream-frames
        whose drained rows are not the frame's uncompacted outputs."""
        def counts(field):
            return torch.stack([getattr(o, field).reshape(
                self.streams, -1).sum(-1) for o, _ in per_frame],
                1).cpu().numpy()

        n_cp, n_upd, shown = (counts("cp_mask"), counts("update_mask"),
                              counts("show_mask"))
        n_csv = n_upd + shown if self.cfg.csv_rows_on_update else shown
        n, head = len(per_frame), kept["seeded"]
        out = [[None] * self.streams for _ in range(n)]
        for b, sink in enumerate(kept["sinks"]):
            vps = sink.vp_per_frame
            vps = vps[:n] if head else vps[max(len(vps) - n, 0):]
            cp = _sink_rows(sink.cross_points, n_cp[b], head)
            csv = _sink_rows(sink.csv_rows, n_csv[b], head)
            if cp is None or csv is None or len(vps) < n:
                continue
            for t in range(n):
                out[t][b] = dict(cp=cp[t], csv=csv[t], shown=np.asarray(
                    [] if vps[t] is None else [vps[t]],
                    np.float64).reshape(-1, 2))
        for t, (outs, _) in enumerate(per_frame):
            want = ref.frame_rows(dict(
                cp_rows=outs.cp_xy, cp_ok=outs.cp_mask,
                upd_rows=outs.update_rows, upd_ok=outs.update_mask,
                show_row=outs.show_row, shown=outs.show_mask),
                self.cfg.csv_rows_on_update)
            tally.drain_mismatch += sum(
                got is None or any(not np.array_equal(got[k], w[k])
                                   for k in w)
                for got, w in zip(out[t], want))
        return out

    def _check_seed(self, kept: dict, rcfg, geom, tally: ref.Tally,
                    control: bool, block: int) -> None:
        """The state a trip-opening chunk started from against the
        reference's seeded state on the trip's first frame."""
        first = kept["frames"][0]
        for lo in range(0, self.streams, block):
            hi = min(lo + block, self.streams)
            want = ref.initial_state(first[lo:hi], rcfg, geom)
            got = (ref.initial_state(first[lo:hi], rcfg, geom,
                                     low_precision=True) if control else
                   dict(_state_dict(kept["start"], lo, hi),
                        prev_gray=kept["start"].prev_gray[lo:hi]))
            tally.add_seed(got, want)

    def compare(self, control: bool = False) -> dict:
        rcfg = ref.Config(self.config)
        geom = ref.Geometry(rcfg, self.device)
        tally = ref.Tally(rcfg.csv_rows_on_update)
        samples = self._control_samples() if control else self._samples()
        if not samples or not samples[0]["seeded"]:
            raise RuntimeError("the window kept no chunk that opens trips")
        block = self.traffic["check"]["block_streams"]
        for kept in samples:
            per_frame = self._replay(kept, None if control else tally)
            drained = (None if control
                       else self._drained(kept, per_frame, tally))
            if kept["seeded"]:
                self._check_seed(kept, rcfg, geom, tally, control, block)
            before = kept["start"]
            for t, (outs, after) in enumerate(per_frame):
                for lo in range(0, self.streams, block):
                    hi = min(lo + block, self.streams)
                    frames = kept["frames"][t:t + 2, lo:hi]
                    args = (frames[0], frames[1], _state_dict(before, lo, hi),
                            rcfg, geom)
                    want = ref.step(*args)
                    got = (ref.step(*args, low_precision=True) if control
                           else _program_step(outs, after, drained[t], lo,
                                              hi))
                    tally.add(got, want)
                before = after
        out = tally.numbers()
        if control:
            del out["replay_mismatch"], out["drain_mismatch"]
        return out
