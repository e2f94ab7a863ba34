"""One dashcam's clips to vps_<video>.csv: ``VideoPipeline.run(frames,
prefetch=...)`` as ``apps/final.py`` runs it, a fresh pipeline a clip,
clip after clip in a closed loop, as a job over a folder of clips runs
them.

The traffic's clip of ``clip_frames`` BGR u8 frames at the configuration's
source size is rendered once at set-up (``road_scenes.py`` at the source
size, the B, G and R planes the texture under per-channel gains and
offsets, so that a wrong channel order or wrong weights show in the gray)
and held as pageable numpy in host memory, as decoded frames are.  Each
clip's iterator stops yielding once the window's seconds have passed,
which cuts the window's last clip short as ``--frames`` does; the window
ends when that clip's ``run()`` has returned, its outputs drained into the
sinks, and the device is synchronised.  End to end: the tracked frames the
sinks received over the window (each clip's first frame seeds it and is
not counted).

The check: this module keeps, for one whole clip of the window (its
second, or its first when the window holds no second whole clip) and for
the window's last chunk, the state each chunk started from, the processed
frames it stepped, its outputs and the clip's sinks, and every clip's
seeded state.  After the window the program replays each kept chunk frame
by frame through the same runner (``frame_hook``, op by op), which must
give the chunk's outputs and end state bit for bit (``replay_mismatch``).
The processed frames are held to the float64 preprocess of their BGR
frames (``reference/vp_solo.py`` (a); ``gray_gap``, the largest |diff| in
gray levels); from each replayed frame's state the reference takes one
step (c), and ``reference.vp.Tally`` holds the program's step to it, and
the rows the sinks received for the frame to the reference's rows; each
clip's seeded state is held to the reference's (d).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpubench.drivers._base import CellBase
from gpubench.drivers.vp_fleet import (_differing, _program_step,
                                       _state_dict, program_config)
from gpubench.reference import vp as vp_ref
from gpubench.reference import vp_solo as ref
from gpubench.road_scenes import BLOCK, RoadScenes

PRE_BLOCK = 8          # BGR frames per call of the float64 preprocess


def bgr_clip(traffic: dict, height: int, width: int, seed: int,
             device) -> np.ndarray:
    """The traffic's clip, (clip_frames, height, width, 3) u8 BGR in host
    memory: the scene's u8 frames v, plane c = round(gain_c (v - 127.5) +
    127.5 + offset_c) clamped to 0..255 (planes in B, G, R order)."""
    scenes = RoadScenes(dict(traffic, streams=1), height, width, seed,
                        device)
    ch = traffic["channels"]
    gain = torch.tensor(ch["gain"], dtype=torch.float32, device=device)
    offset = torch.tensor(ch["offset"], dtype=torch.float32, device=device)
    n = traffic["clip_frames"]
    out = np.empty((n, height, width, 3), np.uint8)
    for t0 in range(0, n, BLOCK):
        k = min(BLOCK, n - t0)
        v = scenes.frames(t0, k)[:, 0].to(torch.float32)[..., None]
        bgr = torch.round((v - 127.5) * gain + 127.5 + offset)
        out[t0:t0 + k] = bgr.clamp(0, 255).to(torch.uint8).cpu().numpy()
    return out


def _stack_states(states: list):
    """Single-stream states (NamedTuples of tensors, nested) stacked along
    a new leading axis, as a batch of states."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    return type(first)(*(_stack_states(list(x)) for x in zip(*states)))


def _kept_pipeline(runner, clip_frames: int):
    """A ``VideoPipeline`` class that keeps what the check reads: per chunk
    the state it started from (None for a clip's first), the index of its
    first frame in the clip, the processed frames and the outputs (every
    chunk with ``keep_all``, else the last), and the state it seeded."""

    class KeptPipeline(runner.VideoPipeline):
        def __init__(self, *args, keep_all: bool, **kw):
            super().__init__(*args, **kw)
            self.keep_all = keep_all
            self.chunks: list = []
            self.seeded = None
            self.fed = 0
            seed = self.init_fn

            def init_fn(first_gray):
                self.seeded = seed(first_gray)
                return self.seeded

            self.init_fn = init_fn

        @property
        def whole(self) -> bool:
            return self.fed == clip_frames

        def feed_gray(self, grays):
            kept = dict(start=self.state, first=self.fed, grays=grays)
            self.fed += grays.shape[0]
            kept["outs"] = super().feed_gray(grays)
            if kept["outs"] is not None:
                self.chunks = (self.chunks if self.keep_all else []) + [kept]
            return kept["outs"]

    return KeptPipeline


class Cell(CellBase):
    unit = "clip"
    trace_key = "trace_clips"

    def make_inputs(self) -> None:
        c = self.config
        self.clip = bgr_clip(self.traffic, c["src_height"], c["src_width"],
                             self.seed, self.device)
        self.clip_frames = self.traffic["clip_frames"]
        self._reset()

    def _load_program(self) -> None:
        """The program's single-stream runner; a program whose runner cannot
        replay a chunk frame by frame, or that does not count how its
        single-stream chunks ran, cannot run this cell's check, and fails
        here, before anything is rendered."""
        import inspect

        from lk_tpu_torch.pipeline import runner

        self.program = runner
        self.cfg = program_config(self.config)
        self.replay = runner.make_chunk_runner(
            self.cfg, (self.config["width"], self.config["height"]),
            self.device)[0]
        if "frame_hook" not in inspect.signature(self.replay).parameters:
            raise RuntimeError("this program's chunk runner takes no "
                               "frame_hook: the cell's replay needs it")
        if not hasattr(runner, "video_graph_counts"):
            raise RuntimeError("this program does not count its "
                               "single-stream chunks (video_graph_counts)")
        self.pipeline = _kept_pipeline(runner, self.traffic["clip_frames"])

    def setup(self) -> None:
        self._load_program()
        self.make_inputs()
        # the warm-up, a clip's first chunks: the key's first chunk op by
        # op, its frame graph's capture, replayed chunks, a drain
        warm = self._pipe(keep_all=False)
        warm.run(iter(self.clip[:1 + 3 * self.config["chunk"]]),
                 prefetch=self.config["prefetch"])
        self.sync()
        self.program.reset_counters()

    def _pipe(self, keep_all: bool):
        c = self.config
        p = self.pipeline(self.cfg, (c["src_width"], c["src_height"]),
                          chunk=c["chunk"],
                          host_preprocess=c["host_preprocess"],
                          device=self.device, keep_all=keep_all)
        p.drain_every = c["drain_every"]
        if (p.height, p.width) != (c["height"], c["width"]):
            raise RuntimeError(f"the pipeline processes {p.width}x{p.height}, "
                               f"the configuration {c['width']}x{c['height']}")
        return p

    # -- the traffic -------------------------------------------------------

    def _frames(self, deadline):
        """The clip's frames, one at a time, until ``deadline`` (none: the
        whole clip)."""
        for f in self.clip:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            yield f

    def _run_clip(self, deadline) -> None:
        """One clip through a fresh pipeline; the first two clips of a
        window keep every chunk, later ones their last."""
        n = self.units_done["clips"]
        pipe = self._pipe(keep_all=n < 2)
        pipe.run(self._frames(deadline), prefetch=self.config["prefetch"])
        u = self.units_done
        u["clips"] += 1
        u["frames"] += pipe.frames_done
        u["uploaded"] += pipe.fed
        if pipe.seeded is not None:
            self.seeds.append(pipe.seeded)
        if n == 0 or (n == 1 and pipe.whole):
            self.kept = pipe
        self.last = pipe
        self.attempted += pipe.frames_done

    def _reset(self) -> None:
        self.kept = self.last = None
        self.seeds = []
        self.units_done = dict(clips=0, frames=0, uploaded=0)

    def window(self, seconds: float) -> None:
        """Clips back to back until ``seconds`` have passed; the window ends
        when the last clip's ``run()`` has returned and the device is
        synchronised."""
        self._reset()
        self.done = 0
        self.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self._run_clip(deadline)
            self.done += 1
            if time.perf_counter() >= deadline:
                break
        self.sync()
        self.window_s = time.perf_counter() - t0

    def step(self) -> None:
        self._run_clip(None)

    def traced_window(self) -> None:
        self._reset()
        super().traced_window()

    def metrics(self) -> dict:
        return {"flow_pairs_per_s": self.units_done["frames"] / self.window_s}

    def units(self) -> dict:
        c = self.config
        u = self.units_done
        return dict(u, bgr_bytes=u["uploaded"] * c["src_height"]
                    * c["src_width"] * 3)

    def release(self) -> None:
        """The runner, the clip and the kept chunks stay for the check."""
        print(f"gpubench: single-stream chunks "
              f"{self.program.video_graph_counts}, {self.units_done}",
              file=sys.stderr)
        if self.cuda:
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def _samples(self) -> list:
        """(pipe, indices of its kept chunks, whether they open the pipe's
        sinks): every chunk of the kept clip, and the window's last chunk
        where it lies in another clip (its rows close that clip's
        sinks)."""
        if self.kept is None or not self.kept.chunks:
            raise RuntimeError("the window kept no chunk")
        out = [(self.kept, range(len(self.kept.chunks)), True)]
        if self.last is not self.kept and self.last.chunks:
            out.append((self.last, [len(self.last.chunks) - 1], False))
        return out

    def _control_samples(self) -> list:
        """The control's chunks: the program runs the clip's first two
        chunks untimed (no window has run)."""
        self._load_program()
        self._reset()
        pipe = self._pipe(keep_all=True)
        pipe.run(iter(self.clip[:1 + 2 * self.config["chunk"]]),
                 prefetch=self.config["prefetch"])
        self.seeds.append(pipe.seeded)
        self.kept = self.last = pipe
        return self._samples()

    def _replay(self, pipe, k: int, tally):
        """Chunk ``k`` of ``pipe.chunks`` stepped again from its start state,
        frame by frame; returns (state before each frame, the frames
        stepped, per frame (outputs, state after)), and adds the replay's
        differences from the timed chunk to ``tally``."""
        kept = pipe.chunks[k]
        start = kept["start"]
        frames = kept["grays"]
        if start is None:
            start, frames = pipe.seeded, frames[1:]
        per_frame = []

        def hook(t, after, outs):
            per_frame.append((outs, after))

        end, outs = self.replay(start, frames, frame_hook=hook)
        if tally is not None:
            nxt = (pipe.chunks[k + 1]["start"] if k + 1 < len(pipe.chunks)
                   else pipe.state)
            tally.replay_mismatch += (_differing(outs, kept["outs"])
                                      + _differing(end, nxt))
        before = [start] + [after for _, after in per_frame[:-1]]
        return before, frames, per_frame

    def _gray_gap(self, kept: dict, control: bool) -> float:
        """The largest |processed frame - reference (a)| of a chunk's
        frames, in gray levels; the control's: the reference rounded to
        bfloat16 against itself."""
        c = self.config
        gap = 0.0
        grays = kept["grays"]
        for b in range(0, grays.shape[0], PRE_BLOCK):
            i0 = kept["first"] + b
            i1 = kept["first"] + min(b + PRE_BLOCK, grays.shape[0])
            bgr = torch.from_numpy(self.clip[i0:i1]).to(self.device)
            want = ref.preprocess(bgr, c["height"], c["width"])
            got = (ref.preprocess(bgr, c["height"], c["width"],
                                  low_precision=True) if control
                   else grays[b:b + PRE_BLOCK].to(torch.float64))
            gap = max(gap, float((got - want).abs().max()))
        return gap

    def _sink_rows(self, pipe, per_frame: list, at: dict, head: bool,
                   tally) -> list:
        """Per frame of a kept chunk, the rows its sink received
        (``reference.vp.frame_rows``'s form): split by the program's
        per-frame counts from the sinks' heads at ``at`` (the chunk opens
        or follows the sinks' earlier rows), or from their tails.  Adds to
        ``tally.drain_mismatch`` the frames whose drained rows are not the
        frame's outputs bit for bit."""
        outs = _stack_frames_of(per_frame)
        want_rows = vp_ref.frame_rows(dict(
            cp_rows=outs.cp_xy, cp_ok=outs.cp_mask,
            upd_rows=outs.update_rows, upd_ok=outs.update_mask,
            show_row=outs.show_row, shown=outs.show_mask),
            self.cfg.csv_rows_on_update)
        n = len(per_frame)
        n_cp = [len(r["cp"]) for r in want_rows]
        n_csv = [len(r["csv"]) for r in want_rows]
        lists = dict(cp=pipe.cross_points, csv=pipe.csv_rows,
                     frame=pipe.vp_per_frame)
        counts = dict(cp=sum(n_cp), csv=sum(n_csv), frame=n)
        got_rows = []
        taken = {}
        for key, rows in lists.items():
            lo = at[key] if head else len(rows) - counts[key]
            taken[key] = rows[lo:lo + counts[key]] if lo >= 0 else []
            at[key] += counts[key]
        ok = all(len(taken[k]) == counts[k] for k in counts)
        cp_at = csv_at = 0
        for t in range(n):
            if not ok:
                got_rows.append(None)
                continue
            vpf = taken["frame"][t]
            got = dict(
                cp=np.asarray(taken["cp"][cp_at:cp_at + n_cp[t]],
                              np.float64).reshape(-1, 2),
                csv=np.asarray(taken["csv"][csv_at:csv_at + n_csv[t]],
                               np.float64).reshape(-1, 2),
                shown=np.asarray([] if vpf is None else [vpf],
                                 np.float64).reshape(-1, 2))
            cp_at += n_cp[t]
            csv_at += n_csv[t]
            got_rows.append(got)
        tally.drain_mismatch += sum(
            got is None or any(not np.array_equal(got[k], w[k]) for k in w)
            for got, w in zip(got_rows, want_rows))
        return got_rows

    def _check_seeds(self, rcfg, geom, tally: vp_ref.Tally,
                     control: bool) -> None:
        """Every clip's seeded state against the reference's (d) on the
        clip's first processed frame."""
        seeded = _stack_states(self.seeds)
        first = seeded.prev_gray
        want = ref.initial_state(first, rcfg, geom)
        got = (ref.initial_state(first, rcfg, geom, low_precision=True)
               if control else dict(_state_dict(seeded, 0, len(self.seeds)),
                                    prev_gray=first))
        tally.add_seed(got, want)

    def compare(self, control: bool = False) -> dict:
        rcfg = ref.Config(self.config)
        geom = ref.Geometry(rcfg, self.device)
        tally = vp_ref.Tally(rcfg.csv_rows_on_update)
        samples = self._control_samples() if control else self._samples()
        gray_gap = 0.0
        for pipe, chunks, head in samples:
            at = dict(cp=0, csv=0, frame=0)
            for k in chunks:
                kept = pipe.chunks[k]
                gray_gap = max(gray_gap, self._gray_gap(kept, control))
                before, frames, per_frame = self._replay(
                    pipe, k, None if control else tally)
                rows = (None if control else
                        self._sink_rows(pipe, per_frame, at, head, tally))
                start = _stack_states(before)
                after = _stack_states([a for _, a in per_frame])
                outs = _stack_frames_of(per_frame)
                n = len(per_frame)
                args = (start.prev_gray, frames,
                        _state_dict(start, 0, n), rcfg, geom)
                want = ref.step(*args)
                got = (ref.step(*args, low_precision=True) if control
                       else _program_step(outs, after, rows, 0, n))
                tally.add(got, want)
        self._check_seeds(rcfg, geom, tally, control)
        out = tally.numbers()
        out["gray_gap"] = gray_gap
        if control:
            del out["replay_mismatch"], out["drain_mismatch"]
        return out


def _stack_frames_of(per_frame: list):
    """The per-frame outputs of a replayed chunk stacked on a leading
    axis, as a batch of one-frame steps."""
    return _stack_states([o for o, _ in per_frame])
