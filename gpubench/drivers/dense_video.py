"""Offline dense flow over whole clips: ``dense_pyramidal_lk_video`` called
back to back on the staged clips, one scene after the other, the flows
left on the device.  End-to-end: flow fields per second over the window.
The check compares a sample of pairs of one call per scene that the
window made, drawn from the seed, always with the first pair and the
clip's last (its per-frame tail)."""

from __future__ import annotations

from gpubench import scenes
from gpubench.drivers._base import CellBase, lk_configs, sample
from gpubench.reference import dense as ref


class Cell(CellBase):
    unit = "video_call"
    trace_key = "trace_calls"

    def make_inputs(self) -> None:
        c = self.config
        self.clips = scenes.dense_scenes(self.traffic, c["height"], c["width"],
                                         self.seed, self.device)
        self.pairs_per_call = self.clips[0].shape[0] - 1
        self.kept = [None] * len(self.clips)   # one sampled call per scene
        self.seen = [0] * len(self.clips)
        self.calls = 0

    def setup(self) -> None:
        from lk_tpu_torch import config as port_config
        from lk_tpu_torch.flow import dense

        self.make_inputs()
        self.program = dense
        self.lk, self.dense_cfg = lk_configs(port_config, self.config)
        for _ in range(self.traffic["warmup_calls"]):
            for clip in self.clips:
                dense.dense_pyramidal_lk_video(clip, self.lk, self.dense_cfg)
        self.sync()

    def step(self) -> None:
        s = self.calls % len(self.clips)
        out = self.program.dense_pyramidal_lk_video(self.clips[s], self.lk,
                                                    self.dense_cfg)
        self.calls += 1
        self.attempted += self.pairs_per_call
        # a reservoir of one call per scene over the whole window
        self.seen[s] += 1
        if self.rng.random() * self.seen[s] < 1.0:
            self.kept[s] = out

    def metrics(self) -> dict:
        return {"flow_pairs_per_s":
                self.done * self.pairs_per_call / self.window_s}

    def units(self) -> dict:
        return {"calls": self.done,
                "pairs": self.done * self.pairs_per_call,
                "frames": self.done * (self.pairs_per_call + 1)}

    def compare(self, control: bool = False) -> dict:
        worst = {}
        n = self.pairs_per_call
        picks = sample(self.rng, n, self.traffic["check"]["pairs_per_scene"],
                       always=(0, n - 1))
        for s, clip in enumerate(self.clips):
            if not control and self.kept[s] is None:
                continue           # the window made no call of this scene
            for t in picks:
                want = ref.pair_flow(clip[t], clip[t + 1], self.config)
                if control:
                    got = ref.pair_flow(clip[t], clip[t + 1], self.config,
                                        low_precision=True)
                else:
                    out = self.kept[s]
                    got = (out.flow[t], out.min_eig[t], out.valid[t])
                for k, v in ref.gaps(got, want, self.config).items():
                    worst[k] = max(worst.get(k, 0.0), v)
        if not worst:
            raise RuntimeError("the window kept no flow to compare")
        return worst
