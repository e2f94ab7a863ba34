"""The interactive viewer's key protocol (ESC/SPACE/BACKSPACE), the ROI
schematic and the live plot: lk_tpu_torch.apps.display driven by a
scripted UI, the 8 cases of tests/test_display.py, on the port's
VideoPipeline and synthetic stream (device="cpu").  The counts checked
are exact (frames shown, waits, plot updates)."""

import numpy as np

from lk_tpu_torch.apps.display import (BACKSPACE, ESC, SPACE, LivePlot,
                                       interactive_loop)
from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.io.video import SyntheticRoadStream
from lk_tpu_torch.pipeline.runner import VideoPipeline

W, H, F = 430, 242, 9
CFG = PipelineConfig(width=W)


class ScriptedUI:
    def __init__(self, keys=(), pause_keys=()):
        self.keys = list(keys)              # returned by show(), in order
        self.pause_keys = list(pause_keys)  # returned by wait_key()
        self.shown = []
        self.waits = 0
        self.closed = False

    def show(self, frame):
        self.shown.append(frame.copy())
        return self.keys.pop(0) if self.keys else 255

    def wait_key(self):
        self.waits += 1
        return self.pause_keys.pop(0) if self.pause_keys else SPACE

    def close(self):
        self.closed = True


def _pipe():
    return VideoPipeline(CFG, src_size=(W, H), chunk=4, device="cpu")


def _scene(zoom=1.03):
    return SyntheticRoadStream(width=W, height=H, n_frames=F, zoom=zoom,
                               device="cpu")


def _run(ui):
    pipe = _pipe()
    done = interactive_loop(pipe, CFG, iter(_scene()), ui)
    return done, pipe, ui


def test_full_run_shows_every_processed_frame():
    done, pipe, ui = _run(ScriptedUI())
    assert done and ui.closed
    # the first frame initializes; the other F-1 are processed and shown
    assert len(ui.shown) == F - 1 == pipe.frames_done
    assert ui.shown[0].shape == (pipe.height, pipe.width, 3)


def test_esc_quits_early():
    done, pipe, ui = _run(ScriptedUI(keys=[255, ESC]))
    assert not done
    assert len(ui.shown) == 2
    assert pipe.frames_done <= 4


def test_space_pauses_until_space():
    done, _, ui = _run(ScriptedUI(keys=[SPACE], pause_keys=[255, 255, SPACE]))
    assert done
    assert ui.waits == 3
    assert len(ui.shown) == F - 1


def test_space_then_esc_quits():
    done, _, ui = _run(ScriptedUI(keys=[SPACE], pause_keys=[ESC]))
    assert not done
    assert len(ui.shown) == 1


def test_backspace_clears_track_overlay():
    """BACKSPACE zeroes the accumulated overlay (VP_det.py:694-695); a
    static scene adds no segment, so the prefilled overlay otherwise
    stays."""
    frames = [_scene(zoom=1.0).frame(0)] * F

    def run(keys):
        pipe = _pipe()
        mask = np.full((pipe.height, pipe.width, 3), 40, np.uint8)
        ui = ScriptedUI(keys=keys)
        done = interactive_loop(pipe, CFG, iter(frames), ui, draw_mask=mask)
        assert done and len(pipe.segments) == 0
        return mask, ui

    mask_ctl, ui_ctl = run([255, 255])
    assert (mask_ctl == 40).all()
    mask_clr, ui_clr = run([255, BACKSPACE])
    assert (mask_clr == 0).all()
    # rows 60+ exclude the wall-clock-dependent FPS text
    np.testing.assert_array_equal(ui_ctl.shown[1][60:], ui_clr.shown[1][60:])
    assert (ui_clr.shown[2][60:].astype(int).sum()
            < ui_ctl.shown[2][60:].astype(int).sum())


def test_roi_schematic_plays_then_frames():
    """schematic=True shows the full ROI mask + 4 quadrant sub-masks first
    (LK_Final.py:461-477), then the processed frames."""
    pipe = _pipe()
    ui = ScriptedUI()
    assert interactive_loop(pipe, CFG, iter(_scene()), ui, schematic=True)
    assert len(ui.shown) == 5 + F - 1
    for img in ui.shown[:5]:
        assert img.shape == (pipe.height, pipe.width)
        assert set(np.unique(img)) <= {0, 255}
    full = ui.shown[0].astype(bool)
    quads = np.stack([s.astype(bool) for s in ui.shown[1:5]])
    assert (quads.any(0) <= full).all()
    assert ui.shown[5].ndim == 3


def test_esc_during_schematic_quits():
    pipe = _pipe()
    ui = ScriptedUI(keys=[255, ESC])
    assert not interactive_loop(pipe, CFG, iter(_scene()), ui,
                                schematic=True)
    assert len(ui.shown) == 2 and ui.closed
    assert pipe.frames_done == 0


def test_live_plot_updates_per_chunk():
    """LivePlot refreshes once per drained chunk on the Agg backend."""
    pipe = _pipe()
    lp = LivePlot(W, H, window=CFG.vp_ref)
    try:
        assert interactive_loop(pipe, CFG, iter(_scene()), ScriptedUI(),
                                live_plot=lp)
        # 9 frames / chunk 4: one init+4 chunk, then one 4-frame chunk
        assert lp.updates == 2
        rgba = np.asarray(lp.fig.canvas.buffer_rgba())
        assert rgba.shape[0] > 0 and (rgba[..., :3] < 250).any()
    finally:
        lp.close()
