"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device.  The machine with the card has no JAX and no
OpenCV, so this file imports neither and needs none of tests/conftest.py;
run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from lk_tpu_torch.flow import lk_kernels as lk
from lk_tpu_torch.flow import sparse
from lk_tpu_torch.flow import warp_kernels as wk
from lk_tpu_torch.geometry import vanishing
from lk_tpu_torch.ops import blur, finish

THR = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _frames(n, h, w, device, seed=0):
    """Blurred-noise frames, each shifted (1.3, -0.7) px from the last."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.random((h, w)).astype(np.float32) * 255, 2.0)
    out = [shift(img, (-0.7 * t, 1.3 * t), order=1, mode="mirror")
           for t in range(n)]
    return torch.from_numpy(np.stack(out).astype(np.float32)).to(device)


def _noise(rng, shape, scale, device):
    return torch.from_numpy(((rng.random(shape) - 0.5) * 2.0 * scale)
                            .astype(np.float32)).to(device)


# (level h, w, tile h, w, local, n_iters, coarse_in, write_stats, flow,
#  win_k)
LEVEL_CASES = {
    "resident": (128, 512, 128, 512, 5, 4, False, True, "zero"),
    "tiled_iters": (128, 512, 64, 256, 5, 3, False, True, "noise"),
    "coarse": (128, 512, 64, 256, 5, 1, True, True, "noise"),
    "coarse_nostats": (128, 512, 64, 256, 5, 1, True, False, "noise"),
    # the 1080p finer levels' reference tile (8.5 of the first design's
    # 32-row blocks)
    "tile272_coarse": (544, 512, 272, 512, 3, 1, True, True, "noise"),
    "tile272_local4": (272, 512, 272, 512, 4, 2, False, True, "noise"),
    "local3": (128, 256, 128, 128, 3, 2, False, True, "noise"),
    "local4_coarse": (128, 256, 64, 128, 4, 1, True, True, "noise"),
    # flow of +-(max_disp + 4) px: warp windows beyond the level's border
    "border": (96, 160, 96, 160, 5, 2, False, True, "far"),
    "border_coarse": (96, 160, 48, 160, 3, 1, True, True, "far"),
    # a level smaller than one block of every shape
    "small": (12, 20, 12, 20, 5, 3, False, True, "noise"),
    "small_coarse": (14, 22, 14, 22, 4, 1, True, True, "noise"),
    # a window narrower than 15 taps (the kernel's run-time win_k path)
    "win9": (128, 256, 64, 128, 5, 2, False, True, "noise", 9),
    "win9_coarse": (128, 256, 64, 128, 3, 1, True, True, "noise", 9),
    # tile_w % 128 != 0 at 2 iterations: the second reads the right halo's
    # first warp_kernels.right_spill(tile_w) columns from the current flow
    # (8 at 136x480 tiles, 6 at 250 columns)
    "spill": (272, 480, 136, 480, 5, 2, False, True, "noise"),
    "spill_ragged": (96, 250, 48, 250, 4, 2, False, True, "far"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [-1] + list(range(len(lk.BLOCK_SHAPES))))
@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_kernel_matches_plain(cuda_device, case, shape):
    """Both sides are f32 with the same operation order (the kernel is built
    without FMA contraction; the plain version divides like it), so flow,
    min_eig and valid are equal bit for bit, with the kernel's own block
    shape (-1) and with each shape forced; K=4 pairs equal single-pair
    calls bit for bit."""
    h, w, th, tw, local, n_iters, coarse, stats, kind, *win = \
        LEVEL_CASES[case]
    win_k = win[0] if win else 15
    frames = _frames(5, h, w, cuda_device)
    rng = np.random.default_rng(1)
    disp = 8
    fh, fw = (h // 2, w // 2) if coarse else (h, w)
    if kind == "zero":
        flow = torch.zeros((4, 2, fh, fw), device=cuda_device)
    elif kind == "noise":
        flow = _noise(rng, (4, 2, fh, fw), 1.0, cuda_device)
    else:
        sign = torch.tensor([1.0, -1.0, -1.0, 1.0], device=cuda_device)
        flow = (_noise(rng, (4, 2, fh, fw), 2.0, cuda_device)
                + sign[:, None, None, None] * (disp + 4.0)
                / (2.0 if coarse else 1.0))
    kw = dict(tile_h=th, tile_w=tw, max_disp=disp, local=local,
              n_iters=n_iters, coarse_in=coarse, write_stats=stats,
              min_eig_threshold=THR, win_k=win_k)

    def kernel(a, b, f):
        if shape < 0:
            return lk.fused_lk_level(a, b, f, **kw)
        return lk._fused_lk_level_cuda(a, b, f, shape=shape, **kw)

    lk.reset_counters()
    fk, mk, vk = kernel(frames[:-1], frames[1:], flow)
    assert sum(lk.kernel_launches_by_variant.values()) == n_iters
    assert lk.plain_calls == 0
    fp, mp, vp = lk.fused_lk_level_reference(frames[:-1], frames[1:], flow,
                                             **kw)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp)
    if stats:
        assert torch.equal(mk, mp) and torch.equal(vk, vp)
    else:
        assert mk is None and mp is None and vk is None
    for f in range(4):
        one = kernel(frames[f:f + 1], frames[f + 1:f + 2], flow[f:f + 1])
        assert torch.equal(fk[f], one[0][0])
        if stats:
            assert torch.equal(mk[f], one[1][0])
            assert torch.equal(vk[f], one[2][0])


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    frames = torch.zeros((2, 64, 128), device=cuda_device)
    flow = torch.zeros((1, 2, 64, 128), device=cuda_device)
    with pytest.raises(ValueError):        # level not a multiple of the tile
        lk.fused_lk_level(frames[:1], frames[1:], flow, tile_h=48,
                          tile_w=128, max_disp=4, local=3)
    with pytest.raises(ValueError):        # beyond the kernel's local range
        lk.fused_lk_level(frames[:1], frames[1:], flow, tile_h=64,
                          tile_w=128, max_disp=4, local=lk.MAX_LOCAL + 1)
    with pytest.raises(ValueError):        # planes not row-major
        t = frames.transpose(1, 2)
        lk.fused_lk_level(t[:1], t[1:], torch.zeros((1, 2, 128, 64),
                                                    device=cuda_device),
                          tile_h=128, tile_w=64, max_disp=4, local=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 64, 128), (1, 483, 860),
                                   (2, 2, 2), (1, 483, 861), (4, 17, 132),
                                   (2, 33, 257), (3, 5, 6), (16, 483, 860),
                                   (70000, 2, 4)])
def test_finish_matches_plain(cuda_device, shape, dtype):
    """Kernel A: bit-equal to the plain chain (no FMA contraction in the
    kernel), with and without the tone curve; one launch per call.  Widths
    that are not a multiple of 4 (per-column loads), strips and warp
    segments cut short, 2x2 frames and more frames than a grid dimension
    holds (65,535) included."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, shape).astype(dtype)
    x = torch.from_numpy(x).to(cuda_device)
    for contrast in (False, True):
        finish.reset_counters()
        got = finish.fused_finish(x, contrast)
        assert (finish.kernel_launches, finish.plain_calls) == (1, 0)
        want = finish.fused_finish_reference(x, contrast)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_finish_unaligned_frames(cuda_device, dtype):
    """Frames whose base is not aligned for the vector loads (a view one
    element into its storage) take the per-column path: same bits."""
    rng = np.random.default_rng(3)
    n, h, w = 3, 37, 132
    flat = torch.from_numpy(rng.integers(0, 256, 1 + n * h * w)
                            .astype(dtype)).to(cuda_device)
    x = flat[1:].view(n, h, w)
    for contrast in (False, True):
        got = finish.fused_finish(x, contrast)
        want = finish.fused_finish_reference(x, contrast)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("win,sw", [((15, 15), (32, 48)), ((7, 9), (20, 30))])
def test_window_gather_matches_plain(cuda_device, win, sw):
    """Kernel B: bit-equal to the full-frame Scharr plus crops, corners in
    and out of range (clamped as dynamic_slice clamps them)."""
    rng = np.random.default_rng(3)
    fh, fw = 700, 300
    pv = torch.from_numpy(rng.random((fh, fw), dtype=np.float32) * 255)
    nx = torch.from_numpy(rng.random((fh, fw), dtype=np.float32) * 255)
    pv, nx = pv.to(cuda_device), nx.to(cuda_device)
    n = 333
    c = [torch.from_numpy(rng.integers(-20, lim + 20, n)).to(cuda_device)
         for lim in (fh, fw, fh, fw)]
    sparse.reset_counters()
    raw, swin = sparse.gather_windows(pv, nx, *c, win[1], win[0], *sw)
    assert (sparse.kernel_launches, sparse.plain_calls) == (1, 0)
    raw_p, sw_p = sparse.gather_windows_reference(pv, nx, *c, win[1], win[0],
                                                  *sw)
    torch.cuda.synchronize()
    assert torch.equal(raw, raw_p) and torch.equal(swin, sw_p)


@pytest.mark.cuda
def test_serving_kernels_match_plain_path(cuda_device):
    """A small batched serving run through the kernels equals the same run
    through their plain versions, op by op; the finish launches once per
    feed, and per frame stepped op by op or captured (a replay launches
    none from the host) the gather three times (once per level), the
    pyramid once (plus once for the chunk's seed) and the pair scan
    once."""
    import dataclasses

    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.pipeline import runner

    cfg = dataclasses.replace(PRESETS["final"], width=320, out_cap=48)
    rng = np.random.default_rng(4)
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.random((200, 340), dtype=np.float32) * 255, 2)
    frames = np.stack([np.stack([base[t:t + 180, b + t:b + t + 320]
                                 for b in range(2)]) for t in range(9)])
    st = torch.from_numpy(frames.astype(np.uint8)).to(cuda_device)

    def run():
        ms = runner.MultiStreamPipeline(cfg, src_size=(320, 180),
                                        n_streams=2, chunk=8)
        ms.feed_staged(st, 0, 9)
        ms.drain()
        return ms

    _reset_all()
    kern = run()
    counts = runner.chunk_graph_counts
    stepped = counts["eager"] * 8 + counts["captures"]
    assert (finish.kernel_launches, finish.plain_calls) == (2, 0)
    assert (sparse.kernel_launches, sparse.plain_calls) == (3 * stepped, 0)
    # the tracker's pyramid: once for the chunk's seed, once per frame
    assert (blur.kernel_launches, blur.plain_calls) == (1 + stepped, 0)
    assert (vanishing.kernel_launches, vanishing.plain_calls) == (stepped, 0)
    with _PlainTracker():
        plain = run()
    assert finish.plain_calls > 0 and vanishing.plain_calls > 0
    for p, q in zip(kern.pipes, plain.pipes):
        assert p.csv_rows == q.csv_rows
        assert p.cross_points == q.cross_points


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(483, 860), (241, 433), (40, 64)])
def test_track_points_kernel_pyramid_equals_plain(cuda_device, hw):
    """The per-point tracker with the pyramid kernel equals it with the
    plain pyramid (torch.equal), one pyramid launch per call for the
    stacked (prev, next) pair; 40x64 pads its coarsest level past its far
    edge."""
    from lk_tpu_torch.config import LKConfig

    h, w = hw
    frames = _frames(2, h, w, cuda_device, seed=h)
    rng = np.random.default_rng(w)
    pts = torch.from_numpy(np.concatenate([
        rng.uniform([0, 0], [w, h], (40, 2)),
        [[-3, 5], [w + 4, h / 2], [w - 0.5, h - 0.5], [-50, -50]]])
        .astype(np.float32)).to(cuda_device)
    valid = torch.from_numpy(rng.random(44) < 0.9).to(cuda_device)
    blur.reset_counters()
    got = sparse.track_points(frames[0], frames[1], pts, valid, LKConfig())
    assert (blur.kernel_launches, blur.plain_calls) == (1, 0)
    real = sparse.build_pyramid
    sparse.build_pyramid = blur.build_pyramid_reference
    try:
        want = sparse.track_points(frames[0], frames[1], pts, valid,
                                   LKConfig())
    finally:
        sparse.build_pyramid = real
    torch.cuda.synchronize()
    assert blur.plain_calls == 1
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert bool(got[1].any())


@pytest.mark.cuda
def test_video_pipeline_kernel_equals_plain(cuda_device, monkeypatch):
    """A short single-stream VideoPipeline run on the card (three chunks of
    4 tracked frames): one pyramid launch per frame stepped from the host,
    that is every frame of a chunk run op by op and the capture of its
    key's frame graph (a replayed chunk launches none), no plain call, and
    the same rows as the run with the plain pyramid, op by op
    (CHUNK_GRAPHS 0: a graph replays the kernel it captured)."""
    import dataclasses

    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.pipeline import runner
    from lk_tpu_torch.pipeline.runner import VideoPipeline
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(3)
    base = gaussian_filter(rng.random((220, 360), dtype=np.float32) * 255, 2)
    bgr = [np.repeat(base[t:t + 180, t:t + 320, None], 3, -1)
           .astype(np.uint8) for t in range(13)]

    def run():
        p = VideoPipeline(dataclasses.replace(PRESETS["final"], width=320),
                          src_size=(320, 180), chunk=4)
        p.run(iter(bgr))
        return p

    _reset_all()
    kern = run()
    counts = runner.video_graph_counts
    assert counts["eager"] + counts["replays"] == 3
    stepped = 4 * counts["eager"] + counts["captures"]
    assert (blur.kernel_launches, blur.plain_calls) == (stepped, 0)
    assert finish.kernel_launches == sparse.kernel_launches == 0
    monkeypatch.setattr(sparse, "build_pyramid", blur.build_pyramid_reference)
    monkeypatch.setattr(runner, "CHUNK_GRAPHS", 0)
    plain = run()
    assert blur.plain_calls == 12
    assert kern.frames_done == 12
    assert kern.csv_rows == plain.csv_rows
    assert kern.vp_per_frame == plain.vp_per_frame


def _same_videos(a, b) -> None:
    """Two single-stream runs' sinks and end states equal, bit for bit."""
    from lk_tpu_torch.pipeline import runner

    assert a.frames_done == b.frames_done > 0
    assert a.csv_rows == b.csv_rows and len(a.csv_rows) > 0
    assert a.cross_points == b.cross_points
    assert a.vp_per_frame == b.vp_per_frame
    assert a.motion_rows == b.motion_rows
    assert len(a.segments) == len(b.segments)
    for x, y in zip(a.segments, b.segments):
        assert np.array_equal(x["start"], y["start"])
        assert np.array_equal(x["stop"], y["stop"])
    for x, y in zip(runner._leaves(a.state), runner._leaves(b.state)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [0, 2])
def test_video_frame_graph_equals_op_by_op(cuda_device, prefetch,
                                           monkeypatch):
    """Two clips of the single-stream cell cut small (24 frames of 640x360
    BGR processed at 320x180, chunk 8) through fresh VideoPipelines on the
    card: the first clip's first chunk runs op by op and captures the key's
    frame graph, every later chunk replays it, the second clip's too (no
    recapture); a chunk with a frame_hook runs op by op.  Every chunk's
    outputs, the sinks and the end states equal bit for bit those of the
    same clips run op by op (CHUNK_GRAPHS 0, which captures nothing).  At
    prefetch 2 the producer thread uploads and preprocesses a chunk while
    the capture is open on the feeding thread."""
    import threading

    from gpubench.drivers.vp_fleet import program_config
    from gpubench.drivers.vp_solo import bgr_clip
    from gpubench.tests._tiny_solo import tiny_solo_spec
    from lk_tpu_torch.pipeline import runner

    spec = tiny_solo_spec()
    c, t = spec.config, spec.traffic
    cfg = program_config(c)
    clips = [bgr_clip(t, c["src_height"], c["src_width"], seed, cuda_device)
             for seed in (1, 2)]

    def run(clip):
        p = runner.VideoPipeline(cfg, (c["src_width"], c["src_height"]),
                                 chunk=c["chunk"], device=cuda_device)
        p.drain_every = c["drain_every"]
        p.outs = []
        feed = p.feed_gray

        def keep(grays):
            p.outs.append(feed(grays))
            return p.outs[-1]

        p.feed_gray = keep
        p.run(iter(clip), prefetch=prefetch)
        return p

    capturing, ingested = threading.Event(), threading.Event()
    if prefetch:
        # the capture waits, open, for the producer's ingest of the second
        # chunk, which waits for the capture to be open
        real_ingest = runner.VideoPipeline._ingest
        real_step = runner._FrameProgram.step_in_place
        calls = []

        def ingest(self, frames_u8):
            calls.append(frames_u8.shape[0])
            if len(calls) != 2:
                return real_ingest(self, frames_u8)
            assert capturing.wait(timeout=30)
            out = real_ingest(self, frames_u8)
            ingested.set()
            return out

        def step_in_place(self, step):
            capturing.set()
            assert ingested.wait(timeout=30)
            return real_step(self, step)

        monkeypatch.setattr(runner.VideoPipeline, "_ingest", ingest)
        monkeypatch.setattr(runner._FrameProgram, "step_in_place",
                            step_in_place)
    runner.make_chunk_runner.cache_clear()
    runner.reset_counters()
    graphed = [run(clip) for clip in clips]
    torch.cuda.synchronize()
    assert runner.video_graph_counts == {"captures": 1, "replays": 5,
                                         "eager": 1}
    assert ingested.is_set() == bool(prefetch)
    monkeypatch.undo()
    run_chunk = runner.make_chunk_runner(cfg, (c["width"], c["height"]),
                                         cuda_device)[0]
    run_chunk(graphed[0].state, torch.zeros((2, c["height"], c["width"]),
                                            device=cuda_device),
              frame_hook=lambda *a: None)
    assert runner.video_graph_counts["eager"] == 2
    monkeypatch.setattr(runner, "CHUNK_GRAPHS", 0)
    runner.reset_counters()
    plain = [run(clip) for clip in clips]
    assert runner.video_graph_counts == {"captures": 0, "replays": 0,
                                         "eager": 6}
    for a, b in zip(graphed, plain):
        _same_videos(a, b)
        assert len(a.outs) == len(b.outs) == 3
        for x, y in zip(runner._leaves(a.outs), runner._leaves(b.outs)):
            assert torch.equal(x, y)


# (frames shape, pad_hw or None, levels)
PYRAMID_CASES = {
    # the 1080p base's seam: L1 rows 540-543 read pad rows replicating
    # row 1079, reflected at 1088
    "seam_1080p": ((1, 1080, 1920), (1088, 2048), 3),
    "seam_small": ((2, 10, 24), (16, 32), 2),
    "pad_cols_only": ((2, 40, 130), (40, 192), 2),
    "odd": ((3, 483, 861), None, 3),           # 483 -> 242 -> 121 -> 61
    "odd_padded": ((2, 37, 53), (41, 70), 4),
    "one_row": ((2, 1, 300), None, 2),
    "one_col": ((2, 300, 1), None, 2),
    "down_to_1x1": ((3, 17, 30), None, 5),
    "planes_64": ((64, 96, 172), None, 2),     # the tracker's batch, small
    "plane_1": ((1, 96, 172), None, 1),
    "pad_is_input": ((2, 64, 128), (64, 128), 4),
    "levels_1_padded": ((2, 50, 100), (64, 128), 1),
    "frame_2d": ((50, 70), (64, 128), 2),
    "unaligned": ((3, 61, 127), (64, 130), 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("blocks_per_sm", [0, 1])
@pytest.mark.parametrize("case", list(PYRAMID_CASES))
def test_pyramid_matches_plain(cuda_device, case, blocks_per_sm):
    """The pyramid kernel: every level (the padded base included) bit-equal
    to the plain version in one launch, with the resident grid and with
    one block per SM (the grid-stride walk and the grid barrier with many
    tiles per block); an unpadded base is the input itself."""
    shape, pad, levels = PYRAMID_CASES[case]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32) * 255).to(
        cuda_device)
    blur.reset_counters()
    got = (blur.build_pyramid(x, levels, pad) if blocks_per_sm == 0 else
           blur._pyramid_cuda(x, levels, pad, blocks_per_sm=blocks_per_sm))
    assert (blur.kernel_launches, blur.plain_calls) == (1, 0)
    want = blur.build_pyramid_reference(x, levels, pad)
    torch.cuda.synchronize()
    assert len(got) == len(want) == levels + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)
    if pad is None or tuple(pad) == tuple(shape[-2:]):
        assert got[0] is x


@pytest.mark.cuda
def test_pyramid_frames_one_at_a_time(cuda_device):
    """A 5-frame stack equals its frames one at a time, bit for bit."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((5, 70, 300), dtype=np.float32) * 255
                         ).to(cuda_device)
    stacked = blur.build_pyramid(x, 3, (80, 384))
    for i in range(5):
        for a, b in zip(stacked, blur.build_pyramid(x[i], 3, (80, 384))):
            assert torch.equal(a[i], b)


@pytest.mark.cuda
def test_launch_on_the_tensor_device():
    """Every kernel runs on its tensor's card while another is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((2, 70, 300), dtype=np.float32) * 255)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 37, 53)).astype(np.uint8))
    x, u8 = x.to(dev), u8.to(dev)
    with torch.cuda.device(0):
        got = blur.build_pyramid(x, 3, (80, 384))
        fin = finish.fused_finish(u8, True)
        want = blur.build_pyramid_reference(x, 3, (80, 384))
        fin_want = finish.fused_finish_reference(u8, True)
        torch.cuda.synchronize(dev)
    assert all(t.device == dev for t in got) and fin.device == dev
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(fin, fin_want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 128), (5, 37, 53), (3, 1, 9),
                                   (1, 2, 2), (2, 3, 483, 861)])
def test_pyr_down_matches_plain(cuda_device, shape):
    """pyrDown, the pyramid kernel's one-level call: bit-equal to the plain
    version for any leading dims (one launch), odd sizes and the 1-row
    clamp."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32) * 255).to(
        cuda_device)
    blur.reset_counters()
    got = blur.pyr_down(x)
    assert (blur.kernel_launches, blur.plain_calls) == (1, 0)
    want = blur.pyr_down_reference(x)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want)


def _zoom_flow(h, w, device, outliers=True, seed=6):
    """A smooth zoom flow with a few outliers beyond any local range."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([(xs - w / 2) * 0.02 + 3.0, (ys - h / 2) * 0.02 - 2.0])
    if outliers:
        idx = rng.integers(0, h * w, 50)
        flow.reshape(2, -1)[:, idx] += rng.uniform(-30, 30, (2, 50))
    return torch.from_numpy(flow.astype(np.float32)).to(device)


# (level h, w), (tile h, w), local, max_disp, base offset in floats
LOCAL_WARP_CASES = {
    # path B's levels 0-2 at 1080p
    "l0_1080p": ((1088, 1920), (64, 384), 3, 32, 0),
    "l1_1080p": ((576, 1024), (64, 512), 4, 16, 0),
    "l2_1080p": ((320, 480), (64, 480), 5, 8, 0),
    # every local, so that every template instance runs
    **{f"local{n}": ((128, 256), (64, 128), n, 16, 0) for n in range(9)},
    # ragged blocks: tiles that no block height or width divides
    "ragged_rows": ((96, 480), (32, 480), 5, 16, 0),
    "ragged_both": ((40, 100), (40, 50), 8, 16, 0),
    "ragged_odd": ((120, 200), (60, 100), 4, 8, 0),
    # a level smaller than one block
    "small": ((6, 20), (6, 20), 2, 4, 0),
    # a base that is not 16-byte aligned: every row by clamped address
    "unaligned": ((128, 768), (64, 384), 3, 32, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOCAL_WARP_CASES))
def test_local_warp_matches_plain(cuda_device, case):
    """The local warp kernel: bit-equal to the plain version, ragged
    blocks, a level smaller than a block, an unaligned base and outliers
    beyond +-local included; one launch per call."""
    (h, w), tile, local, disp, offset = LOCAL_WARP_CASES[case]
    img = _frames(1, h, w, cuda_device)[0]
    nxt = torch.empty(h * w + offset, device=cuda_device)[offset:].view(h, w)
    nxt.copy_(img)
    assert nxt.data_ptr() % 16 == 4 * offset
    flow = _zoom_flow(h, w, cuda_device)
    kw = dict(max_disp=disp, tile_h=tile[0], tile_w=tile[1], local=local)
    wk.reset_counters()
    got = wk.local_warp(nxt, flow, **kw)
    assert wk.kernel_launches["local_warp"] == 1
    assert sum(wk.plain_calls.values()) == 0
    want = wk.local_warp_reference(nxt, flow, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The bf16-window local warp (bf16_warp_window): path B's levels 0-2 at
# 1080p (local 3, 4, 5), and the staging's element-by-element path: a
# width that is no multiple of 8 bf16, and a base 2 bytes off alignment.
LOCAL_WARP_BF16_CASES = {
    "l0_1080p": ((1088, 1920), (64, 384), 3, 32, 0),
    "l1_1080p": ((576, 1024), (64, 512), 4, 16, 0),
    "l2_1080p": ((320, 480), (64, 480), 5, 8, 0),
    "width_not_8": ((40, 100), (40, 50), 4, 16, 0),
    "unaligned": ((128, 768), (64, 384), 5, 32, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOCAL_WARP_BF16_CASES))
def test_local_warp_bf16_matches_plain(cuda_device, case):
    """The local warp's bf16-window instances: bit-equal to the plain
    version (next rounded to bf16, f32 arithmetic) and to the f32 kernel
    on the rounded plane; one launch per call, counted as bf16."""
    (h, w), tile, local, disp, offset = LOCAL_WARP_BF16_CASES[case]
    img = _frames(1, h, w, cuda_device)[0].to(torch.bfloat16)
    nxt = torch.empty(h * w + offset, dtype=torch.bfloat16,
                      device=cuda_device)[offset:].view(h, w)
    nxt.copy_(img)
    assert nxt.data_ptr() % 16 == 2 * offset
    flow = _zoom_flow(h, w, cuda_device)
    kw = dict(max_disp=disp, tile_h=tile[0], tile_w=tile[1], local=local,
              window_dtype=torch.bfloat16)
    wk.reset_counters()
    got = wk.local_warp(nxt, flow, **kw)
    assert wk.kernel_launches["local_warp"] == 1
    assert wk.local_warp_launches_by_window == {"float32": 0, "bfloat16": 1}
    assert sum(wk.plain_calls.values()) == 0
    want = wk.local_warp_reference(nxt, flow, **kw)
    f32 = wk.local_warp(nxt.to(torch.float32), flow, **dict(
        kw, window_dtype=torch.float32))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, f32)


# (level h, w), (tile h, w), n_iters, local
PRE_CASES = {
    "top_1080p": ((136, 240), (136, 240), 6, 5),   # path B's top, spill 8
    "top_1_iter": ((136, 240), (136, 240), 1, 5),
    "tiled": ((128, 512), (64, 256), 3, 5),
    "ragged": ((48, 250), (16, 250), 2, 5),        # spill 6
    "l1_1080p": ((576, 1024), (64, 512), 2, 4),    # chip_smoke.py's tiled
    "local8": ((96, 160), (96, 160), 3, 8),        # the largest window
}


@pytest.mark.cuda
@pytest.mark.parametrize("blocks_per_sm", [0, 1])
@pytest.mark.parametrize("shape",
                         [-1] + list(range(len(wk.PRE_BLOCK_SHAPES))))
@pytest.mark.parametrize("case", list(PRE_CASES))
def test_precomputed_level_matches_plain(cuda_device, case, shape,
                                         blocks_per_sm):
    """The precomputed-A level kernel: bit-equal to the plain version over
    Jacobi iterations (right-halo refresh live where tile_w % 128 != 0),
    with every block shape, at the resident grid and at one block per SM
    (blocks then walk several regions and restage them every iteration);
    one launch per call whatever n_iters; the initial flow untouched."""
    from lk_tpu_torch.config import LKConfig
    from lk_tpu_torch.flow.dense import level_prologue

    (h, w), tile, n_iters, local = PRE_CASES[case]
    frames = _frames(2, h, w, cuda_device)
    ix, iy, a11, a12, a22, _, _, inv_det = level_prologue(
        frames[0], LKConfig(), "edge")
    flow = _zoom_flow(h, w, cuda_device, outliers=False) * 0.5
    init = flow.clone()
    args = (frames[1], frames[0], ix, iy, a11, a12, a22, inv_det, flow)
    kw = dict(n_iters=n_iters, max_disp=8, tile_h=tile[0], tile_w=tile[1],
              local=local)
    wk.reset_counters()
    got = (wk.fused_lk_level_precomputed(*args, **kw)
           if shape == -1 and blocks_per_sm == 0 else
           wk._fused_level_pre_cuda(*args, **kw, shape=shape,
                                    blocks_per_sm=blocks_per_sm))
    assert wk.kernel_launches["fused_lk_level_precomputed"] == 1
    assert sum(wk.plain_calls.values()) == 0
    want = wk.fused_lk_level_precomputed_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(flow, init)


# --- the VP pair scan ---------------------------------------------------------

def _scan_leaves(result) -> list:
    state, out = result
    return [*state, *out]


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [10, 15])
def test_ring_sums_take_the_scan_kernels_order(cuda_device, ring):
    """PyTorch's CUDA sum over the ring axis of a (B, R, 2) tensor, as the
    plain scan takes it, adds slot k into accumulator k % 4 in slot order,
    then ((a0 + a1) + a2) + a3: the order csrc/vp_scan.cu reproduces."""
    rng = np.random.default_rng(ring)
    x = torch.from_numpy((rng.normal(0, 1, (64, ring, 2))
                          * 10.0 ** rng.integers(-3, 4, (64, ring, 2)))
                         .astype(np.float32))
    acc = [torch.zeros(64, 2) for _ in range(4)]
    for k in range(ring):
        acc[k % 4] = acc[k % 4] + x[:, k]
    want = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    got = x.to(cuda_device).sum(dim=1).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # and not the slot order alone
    seq = torch.zeros(64, 2)
    for k in range(ring):
        seq = seq + x[:, k]
    assert not torch.equal(seq, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,ring", [(1, 6, 15), (3, 6, 15), (64, 6, 15),
                                      (1, 190, 15), (3, 190, 15),
                                      (64, 190, 15), (3, 190, 10),
                                      (64, 190, 10), (3, 190, 20)])
def test_vp_scan_kernel_matches_plain(cuda_device, b, p, ring):
    """The scan kernel equals process_frame_pairs_reference on the card
    bit for bit in every leaf of the new state and of the outputs: every
    state kind x candidate fill of tests/vp_scan_cases.py; one launch a
    call, no plain call, the inputs unchanged.  A ring of 20
    slots takes the kernel's 64-slot instance."""
    from vp_scan_cases import CANDS, STATES, same_bits, scan_case

    updates = inits = 0
    for i, (sk, ck) in enumerate((s, c) for s in STATES for c in CANDS):
        cfg, state, cps, cand, size = scan_case(
            sk, ck, b, p, seed=1000 * b + 10 * p + i, ring=ring,
            device=cuda_device)
        before = [x.clone() for x in (*state, cps, cand)]
        vanishing.reset_counters()
        got = vanishing.process_frame_pairs(state, cps, cand, cfg, size)
        assert (vanishing.kernel_launches, vanishing.plain_calls) == (1, 0)
        want = vanishing.process_frame_pairs_reference(state, cps, cand,
                                                       cfg, size)
        torch.cuda.synchronize()
        names = vanishing.VPState._fields + vanishing.FrameGeomOut._fields
        for name, g, w in zip(names, _scan_leaves(got), _scan_leaves(want)):
            assert g.device.type == "cuda"
            assert same_bits(g, w), (sk, ck, name)
        assert all(same_bits(x, y)
                   for x, y in zip(before, (*state, cps, cand)))
        updates += int(want[1].update_mask.sum())
        inits += int((want[0].vp_init & ~state.vp_init).sum())
    assert updates > 0 and (inits > 0 or p < ring)


@pytest.mark.cuda
def test_vp_scan_kernel_in_a_cuda_graph(cuda_device):
    """The scan captured in a CUDA graph: a replay gives the eager call's
    bits, and a replay over new inputs copied into the captured ones gives
    theirs (each stream's trip count is read on the card)."""
    from vp_scan_cases import same_bits, scan_case

    cases = [scan_case(sk, "mixed", 64, 190, seed=s, device=cuda_device)
             for s, sk in enumerate(["aliased", "mid_fill"])]
    cfg, state, cps, cand, size = cases[0]
    static = [x.clone() for x in (*state, cps, cand)]

    def call():
        st = vanishing.VPState(*static[:len(state)])
        return vanishing.process_frame_pairs(st, static[-2], static[-1], cfg,
                                             size)

    call()                                  # loads the library
    torch.cuda.synchronize()
    vanishing.reset_counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    assert vanishing.kernel_launches == 1
    for c_cfg, c_state, c_cps, c_cand, _ in cases:
        for dst, src in zip(static, (*c_state, c_cps, c_cand)):
            dst.copy_(src)
        graph.replay()
        want = vanishing.process_frame_pairs_reference(
            c_state, c_cps, c_cand, c_cfg, size)
        eager = call()
        torch.cuda.synchronize()
        for g, e, w in zip(_scan_leaves(outs), _scan_leaves(eager),
                           _scan_leaves(want)):
            assert same_bits(g, w) and same_bits(e, w)
    assert vanishing.kernel_launches == 1 + len(cases)


@pytest.mark.cuda
def test_vp_scan_kernel_rejects_bad_input(cuda_device):
    from vp_scan_cases import scan_case

    cfg, state, cps, cand, size = scan_case(
        "aliased", "mixed", 3, 40, seed=5, device=cuda_device)
    with pytest.raises(TypeError):
        vanishing.process_frame_pairs(state, cps.double(), cand, cfg, size)
    with pytest.raises(ValueError):         # the state on the CPU
        cpu = vanishing.VPState(*(x.cpu() for x in state))
        vanishing.process_frame_pairs(cpu, cps, cand, cfg, size)
    import dataclasses
    big = dataclasses.replace(cfg, vp_ref_num=65)
    wide = state._replace(ring_xy=torch.zeros(3, 65, 2, device=cuda_device))
    # the launcher's limits (64 ring slots, the pairs' shared memory)
    with pytest.raises(RuntimeError, match="vp_scan kernel launch failed"):
        vanishing.process_frame_pairs(wide, cps, cand, big, size)


# --- the apps on the card ----------------------------------------------------

def _reset_all():
    from lk_tpu_torch.pipeline import runner

    for m in (blur, finish, sparse, lk, wk, runner, vanishing):
        m.reset_counters()


class _PlainTracker:
    """Context: the per-point and batched trackers' pyramid, the finish,
    the gather and the VP pair scan through their plain versions (module
    attributes looked up at call time), the batched chunks op by op (a
    chunk graph would replay the kernels it captured)."""

    def __enter__(self):
        from lk_tpu_torch.pipeline import runner, step

        self.old = (sparse.build_pyramid, finish.fused_finish,
                    sparse.gather_windows, step.process_frame_pairs,
                    runner.CHUNK_GRAPHS)
        sparse.build_pyramid = blur.build_pyramid_reference
        finish.fused_finish = finish.fused_finish_reference
        sparse.gather_windows = sparse.gather_windows_reference
        step.process_frame_pairs = vanishing.process_frame_pairs_reference
        runner.CHUNK_GRAPHS = 0

    def __exit__(self, *exc):
        from lk_tpu_torch.pipeline import runner, step

        (sparse.build_pyramid, finish.fused_finish,
         sparse.gather_windows, step.process_frame_pairs,
         runner.CHUNK_GRAPHS) = self.old


@pytest.mark.cuda
def test_stream_on_card_equals_cpu(cuda_device):
    """The synthetic stream rendered on the card is the CPU's, within one
    u8 level (the same f32/f64 elementwise operations: 0 expected)."""
    from lk_tpu_torch.io.video import SyntheticRoadStream

    kw = dict(width=430, height=242, seed=2, zoom=1.03, n_frames=24)
    card = SyntheticRoadStream(**kw, device=cuda_device)
    cpu = SyntheticRoadStream(**kw, device="cpu")
    assert card.tex.device.type == "cuda"
    assert torch.equal(card.tex.cpu(), cpu.tex)
    d = (card.gray_frames(0, 24).cpu().to(torch.int16)
         - cpu.gray_frames(0, 24).to(torch.int16)).abs()
    assert int(d.max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["final", "vp_detect", "classify"])
def test_vp_app_on_card(cuda_device, app, tmp_path):
    """A VP app's main on the card (--synthetic 1280x720, 17 frames): one
    pyramid launch and one pair-scan launch per tracked frame, no plain
    call, no other kernel, and the rows of the same run with the plain
    pyramid and scan."""
    import importlib

    module = importlib.import_module(f"lk_tpu_torch.apps.{app}")
    argv = ["--synthetic", "--frames", "17", "--chunk", "8", "--quiet",
            "--out-dir", str(tmp_path)]
    _reset_all()
    kern = module.main(argv)
    assert (blur.kernel_launches, blur.plain_calls) == (16, 0)
    assert (vanishing.kernel_launches, vanishing.plain_calls) == (16, 0)
    assert finish.kernel_launches == sparse.kernel_launches == 0
    assert (tmp_path / "vps_synthetic.csv").is_file()
    with _PlainTracker():
        plain = module.main(argv)
    assert kern.frames_done == 16 and len(kern.csv_rows) > 0
    assert kern.csv_rows == plain.csv_rows
    assert kern.vp_per_frame == plain.vp_per_frame


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["masking", "roadlines"])
def test_tracker_app_on_card(cuda_device, app):
    """A tracker app's compute part on the card: one pyramid launch per
    tracked frame, segments equal to the plain-pyramid run; roadlines'
    Hough result on the card within 1e-4 rad / 1e-2 px of the same call
    on the CPU."""
    import importlib

    from lk_tpu_torch.apps import _common
    from lk_tpu_torch.geometry.hough import hough_road_lines

    module = importlib.import_module(f"lk_tpu_torch.apps.{app}")
    parser = _common.build_parser("")
    if app == "roadlines":
        module.add_args(parser)
    args = parser.parse_args(["--synthetic", "--frames", "9", "--chunk",
                              "4"])
    _reset_all()
    kern = module.compute(args)
    assert (blur.kernel_launches, blur.plain_calls) == (8, 0)
    with _PlainTracker():
        plain = module.compute(args)
    if app == "masking":
        assert len(kern.segments) > 0 and kern.segments == plain.segments
        return
    assert len(kern.lengths) > 0 and kern.lengths == plain.lengths
    assert np.array_equal(kern.start, plain.start)
    moving = torch.from_numpy((kern.start != kern.stop).any(axis=1))
    cpu = hough_road_lines(torch.from_numpy(kern.start),
                           torch.from_numpy(kern.stop), moving,
                           (kern.width, kern.height), k=args.hough_k)
    np.testing.assert_allclose(kern.hough.theta.cpu().numpy(),
                               cpu.theta.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(kern.hough.rho.cpu().numpy(),
                               cpu.rho.numpy(), rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_serve_on_card(cuda_device):
    """serve's run_server on the card (4 streams, 17 frames, chunk 8, both
    passes counted): the finish once per chunk + the init frame, the
    pyramid once per chunk (the chunk's first fold); a chunk run op by op
    launches the gather 3 times and the pyramid once per frame, and so
    does the one captured frame (a replay launches neither from the
    host), and the pair scan once per such frame; every chunk but the
    key's first replays its frame graph; no plain call; rows within 1e-4
    px of the plain versions."""
    from lk_tpu_torch.apps import serve
    from lk_tpu_torch.pipeline import runner

    args = serve.build_parser().parse_args(
        ["--streams", "4", "--frames", "17", "--chunk", "8", "--quiet"])
    _reset_all()
    run = serve.run_server(args)
    chunks, per_chunk = 2, 8
    counts = runner.chunk_graph_counts
    stepped = counts["eager"] * per_chunk + counts["captures"]
    assert counts["eager"] + counts["replays"] == 2 * chunks
    assert counts["replays"] >= 2 * chunks - 1
    assert finish.kernel_launches == 2 * (chunks + 1)
    assert sparse.kernel_launches == 3 * stepped
    assert blur.kernel_launches == 2 * chunks + stepped
    assert vanishing.kernel_launches == stepped
    assert (finish.plain_calls + sparse.plain_calls + blur.plain_calls
            + vanishing.plain_calls) == 0
    with _PlainTracker():
        ref = serve.run_server(args)
    for a, b in zip(run.server.pipes, ref.server.pipes):
        x = np.array(a.csv_rows, np.float64).reshape(-1, 2)
        y = np.array(b.csv_rows, np.float64).reshape(-1, 2)
        assert x.shape == y.shape and len(x) > 0
        assert float(np.abs(x - y).max(initial=0.0)) <= 1e-4


@pytest.mark.cuda
def test_serve_spill_on_card(cuda_device):
    """serve on the card with a budget of one row per frame: every chunk
    overflows, the drains read the spill from the card, and the sinks equal
    those of the default budget's run exactly."""
    from lk_tpu_torch.apps import serve

    argv = ["--streams", "4", "--frames", "17", "--chunk", "8", "--quiet"]
    tight = serve.run_server(serve.build_parser().parse_args(
        argv + ["--out-cap", "1"]))
    wide = serve.run_server(serve.build_parser().parse_args(argv))
    assert tight.server.spilled_chunks > 0
    for a, b in zip(tight.server.pipes, wide.server.pipes):
        assert a.csv_rows == b.csv_rows and len(a.csv_rows) > 0
        assert a.cross_points == b.cross_points
        assert a.vp_per_frame == b.vp_per_frame


def _same_sinks(a, b) -> None:
    """Every sink of two serving pipelines equal, bit for bit, in order."""
    for p, q in zip(a.retired + a.pipes, b.retired + b.pipes):
        assert p.frames_done == q.frames_done > 0
        assert p.csv_rows == q.csv_rows and len(p.csv_rows) > 0
        assert p.cross_points == q.cross_points
        assert p.vp_per_frame == q.vp_per_frame
        assert p.motion_rows == q.motion_rows
        assert len(p.segments) == len(q.segments)
        for x, y in zip(p.segments, q.segments):
            assert np.array_equal(x["start"], y["start"])
            assert np.array_equal(x["stop"], y["stop"])


@pytest.mark.cuda
def test_serve_books_between_replays_without_sync(cuda_device, monkeypatch):
    """Serving on the card (4 streams, 860x483, chunk 8) after its key's
    capture: three chunks replay their frame graph while the rows of the
    chunks before them are booked between the replays from pinned copies,
    with no synchronising call on the feeding thread (sync debug mode
    "error"; a budget no chunk overflows, so no stream spills).  The sinks
    equal bit for bit those of the same chunks run op by op
    (CHUNK_GRAPHS 0) and booked at drain()."""
    import dataclasses

    from lk_tpu_torch.apps import serve
    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.pipeline import runner

    args = serve.build_parser().parse_args(["--streams", "4", "--frames",
                                            "41", "--chunk", "8"])
    # out_cap 190, the pair slots' count: a chunk's budget holds them all
    cfg = dataclasses.replace(PRESETS["final"], out_cap=190)

    def make():
        return runner.MultiStreamPipeline(
            cfg, src_size=(args.width, args.height), n_streams=4, chunk=8,
            device=cuda_device)

    warm = make()
    staging = serve.stage(serve.scenes_of(args, cuda_device), 41,
                          warm.height, warm.width)

    def feed(ms, chunks):
        for t in chunks:
            ms.feed_staged(staging, t, 9 if t == 0 else 8)

    feed(warm, (0, 9))                     # captures the key's graph
    warm.drain()
    ms = make()
    feed(ms, (0, 9))                       # the ring's first copies
    torch.cuda.synchronize()
    owed = sum(p.owed() for p in ms._pending)
    runner.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feed(ms, (17, 25, 33))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = dict(runner.drain_counts)
    assert runner.chunk_graph_counts == {"captures": 0, "replays": 3,
                                         "eager": 0}
    assert counts["booked_between"] > 0 and counts["booked_at_drain"] == 0
    assert counts["booked_between"] + sum(
        p.owed() for p in ms._pending) == owed + 3 * 4
    ms.drain()
    assert runner.drain_counts["spill_reads"] == 0
    monkeypatch.setattr(runner, "CHUNK_GRAPHS", 0)
    monkeypatch.setattr(runner.MultiStreamPipeline, "_book_slice",
                        lambda self: None)
    ref = make()
    ref.drain_every = 1000
    feed(ref, (0, 9, 17, 25, 33))
    assert all(p.frames_done == 0 for p in ref.pipes)
    ref.drain()
    _same_sinks(ms, ref)


@pytest.mark.cuda
def test_fleet_chunk_graph_on_card(cuda_device):
    """The fleet cell cut to 4 streams of 320x180 on the card: its chunks
    replay their CUDA graphs (captured in the warm-up), and the check's
    frame-by-frame replay, op by op, gives the graphs' outputs and end
    states bit for bit; the cell's check passes."""
    from gpubench import harness
    from gpubench.tests._tiny_fleet import tiny_fleet_spec
    from lk_tpu_torch.pipeline import runner

    spec = tiny_fleet_spec()
    runner.reset_counters()
    vanishing.reset_counters()
    cell = harness.make_cell(spec, 2 ** 31 + 9, "cuda")
    cell.setup()
    cell._reset()
    before = dict(runner.chunk_graph_counts)
    for _ in range(4):
        cell.step()
    cell.server.drain()
    cell.release()
    assert runner.chunk_graph_counts["replays"] - before["replays"] == 4
    assert runner.chunk_graph_counts["eager"] == before["eager"]
    # the warm-up's op-by-op chunk and captures ran the scan kernel
    assert vanishing.kernel_launches > 0 and vanishing.plain_calls == 0
    out = cell.compare()
    assert vanishing.plain_calls == 0
    assert out["replay_mismatch"] == 0 and out["drain_mismatch"] == 0
    limits = spec.traffic["check"]["limits"]
    assert all(v <= limits[k] for k, v in out.items()), out


# ---------------------------------------------------------------------------
# the parallel layer at world size 1 under NCCL (one card: NCCL takes one
# rank per GPU; the 2-rank legs run under gloo in chip_smoke.py phase 24)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_world1(cuda_device):
    import socket

    import torch.distributed as dist
    from lk_tpu_torch.parallel.multihost import init_multihost

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_multihost(f"localhost:{port}", 1, 0)
    assert dist.get_backend() == "nccl"
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_program(prev, nxt, flow, cfg, dcfg, per_iter, disp=8):
    """The world-1 spatial level's one rank program: the frame padded with
    its edge rows replicated (halo_exchange at the frame's edges), the
    level run on it, the frame's rows kept; per iteration with the eps
    mask carried across rounds (XLA level)."""
    import dataclasses

    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.parallel.spatial import (iteration_halo,
                                               single_exchange_halo)

    h = prev.shape[0]

    def level(f, halo, d):
        rows = torch.arange(-halo, h + halo, device=prev.device).clamp(0, h - 1)
        return dense.dense_lk_level(prev[rows], nxt[rows], f[rows], cfg, d,
                                    max_disp=disp).flow[halo:halo + h]

    if not per_iter:
        return level(flow, single_exchange_halo(cfg, dcfg, disp), dcfg)
    one = dataclasses.replace(dcfg, outer_iters=1, iter_schedule=())
    active = torch.ones(flow.shape[:2], dtype=torch.bool, device=flow.device)
    for _ in range(dcfg.outer_iters):
        f_new = level(flow, iteration_halo(cfg, disp), one)
        if dcfg.use_pallas_fused:
            flow = f_new
            continue
        d = f_new - flow
        flow = torch.where(active[..., None], f_new, flow)
        active = active & (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                           > cfg.eps * cfg.eps)
    return flow


@pytest.mark.cuda
@pytest.mark.parametrize("per_iter", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_spatial_level_world1_nccl(cuda_device, nccl_world1, fused,
                                   per_iter):
    """spatial_dense_lk_level on a 1x1 NCCL mesh at 544x480 (the fused
    level tiled, 480 columns): equal (torch.equal) to its rank program; the
    single exchange's XLA level equal to the unsharded level outside the
    replicated-edge belt; under use_pallas_fused the fused kernel launched
    once per iteration and no plain version run."""
    from lk_tpu_torch.config import DenseLKConfig, LKConfig
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.parallel import make_mesh, spatial_dense_lk_level
    from lk_tpu_torch.parallel.spatial import single_exchange_halo

    frames = _frames(2, 544, 480, cuda_device)
    zero = torch.zeros((544, 480, 2), device=cuda_device)
    cfg, dcfg = LKConfig(), DenseLKConfig(use_pallas_fused=fused)
    fn = spatial_dense_lk_level(make_mesh((1, 1)), cfg, dcfg, max_disp=8,
                                exchange_per_iter=per_iter)
    lk.reset_counters()
    got = fn(frames[0], frames[1], zero)
    torch.cuda.synchronize()
    assert lk.plain_calls == 0
    assert sum(lk.kernel_launches_by_variant.values()) == (
        dcfg.outer_iters if fused else 0)
    assert torch.equal(got, _rank_program(frames[0], frames[1], zero, cfg,
                                          dcfg, per_iter))
    if not (fused or per_iter):
        belt = single_exchange_halo(cfg, dcfg, 8)
        whole = dense.dense_lk_level(frames[0], frames[1], zero, cfg, dcfg,
                                     max_disp=8).flow
        assert torch.equal(got[belt:-belt], whole[belt:-belt])


@pytest.mark.cuda
def test_sharded_pyramid_world1_nccl(cuda_device, nccl_world1):
    """sharded_dense_pyramidal_lk on a 1x1 NCCL mesh equals the unsharded
    dense_pyramidal_lk at every pixel (the pyramid kernel on both)."""
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.parallel import make_mesh, sharded_dense_pyramidal_lk

    frames = _frames(2, 544, 960, cuda_device)
    _reset_all()
    got = sharded_dense_pyramidal_lk(make_mesh((1, 1)))(frames[0], frames[1])
    torch.cuda.synchronize()
    assert blur.kernel_launches > 0 and blur.plain_calls == 0
    assert torch.equal(got, dense.dense_pyramidal_lk(frames[0],
                                                     frames[1]).flow)


@pytest.mark.cuda
def test_sharded_serving_world1_nccl(cuda_device, nccl_world1):
    """MultiStreamPipeline(mesh=...) on a 1-rank NCCL 'streams' mesh: every
    stream's csv rows, shown VPs and cross points equal (np.array_equal)
    the unsharded pipeline's, through the finish, gather and pyramid
    kernels."""
    import dataclasses

    from lk_tpu_torch.io.video import SyntheticRoadStream
    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.parallel import make_mesh
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    w, h, b, f, chunk = 256, 144, 4, 17, 8
    cfg = dataclasses.replace(PRESETS["final"], width=w, out_cap=48)
    u8 = torch.stack([SyntheticRoadStream(
        width=w, height=h, zoom=1.03, seed=s, n_frames=f, color=False,
        vp=(w * 0.45, h * 0.45), device=cuda_device).gray_frames(0, f)
        for s in range(b)], dim=1)

    def run(mesh):
        ms = MultiStreamPipeline(cfg, src_size=(w, h), n_streams=b,
                                 chunk=chunk, mesh=mesh)
        t = 0
        while t < f:
            n = min(chunk + (1 if ms.states is None else 0), f - t)
            ms.feed_staged(u8, t, n)
            t += n
        ms.drain()
        return ms

    _reset_all()
    sharded = run(make_mesh((1,), ("streams",)))
    assert finish.kernel_launches > 0 and sparse.kernel_launches > 0
    assert finish.plain_calls + sparse.plain_calls + blur.plain_calls == 0
    single = run(None)
    for p, q in zip(sharded.pipes, single.pipes):
        assert p.frames_done == q.frames_done == f - 1
        assert p.csv_rows == q.csv_rows
        assert p.vp_per_frame == q.vp_per_frame
        assert p.cross_points == q.cross_points


# --- the per-pair program's CUDA graph ---------------------------------------

PAIR_PATHS = {
    "A": dict(use_pallas_warp=True, pallas_pyramid=True),
    "B": dict(use_pallas_warp=True, fused_grads_in_kernel=False),
    "C": dict(),
}


def _pair_setup(path, h, w, seed=0):
    """(dense module, LKConfig, DenseLKConfig, prev, next) with an empty
    graph cache and zeroed counters."""
    from lk_tpu_torch.config import DenseLKConfig, LKConfig
    from lk_tpu_torch.flow import dense

    dense._pair_graphs.clear()
    dense.reset_counters()
    f = _frames(2, h, w, "cuda", seed=seed)
    return (dense, LKConfig(), DenseLKConfig(**PAIR_PATHS[path]),
            f[0].clone(), f[1].clone())


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("path,hw", [("A", (1080, 1920)), ("A", (483, 861)),
                                     ("B", (1080, 1920)), ("C", (483, 861))])
def test_pair_graph_equals_eager(cuda_device, path, hw):
    """The second call captures and replays, later calls replay: each gives
    the op-by-op program's flow, min_eig and valid bit for bit, and the
    counters read one capture and n - 1 replays."""
    dense, cfg, dcfg, prev, nxt = _pair_setup(path, *hw)
    want = dense._pair_eager(prev, nxt, cfg, dcfg, None)
    outs = [dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)
            for _ in range(4)]
    torch.cuda.synchronize()
    assert dense.pair_graph_counts == {"captures": 1, "replays": 3,
                                       "eager": 1}
    assert len(dense._pair_graphs) == 1
    for out in outs:
        assert tuple(out.flow.shape) == (*hw, 2)
        assert _same(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [3, 5, 33])
def test_chunked_video_equals_per_frame_chain(cuda_device, n_pairs):
    """The 1080p video at the production config (chunk 4): one pyramid
    launch a chunk, the leftover pairs one shorter chunk (9 for a 34-frame
    clip), and flow, min_eig and valid bit-equal to the per-frame
    chain's."""
    import dataclasses

    from lk_tpu_torch.config import DenseLKConfig, LKConfig
    from lk_tpu_torch.flow import dense

    cfg, dcfg = LKConfig(), DenseLKConfig(**PAIR_PATHS["A"])
    assert dcfg.video_chunk == 4
    frames = _frames(n_pairs + 1, 1080, 1920, cuda_device)
    blur.reset_counters()
    chunked = dense.dense_pyramidal_lk_video(frames, cfg, dcfg)
    torch.cuda.synchronize()
    assert blur.kernel_launches == -(-n_pairs // 4)
    per_frame = dense.dense_pyramidal_lk_video(
        frames, cfg, dataclasses.replace(dcfg, video_chunk=0))
    assert tuple(chunked.flow.shape) == (n_pairs, 1080, 1920, 2)
    assert _same(chunked, per_frame)


@pytest.mark.cuda
def test_pair_graph_results_are_fresh(cuda_device):
    """A replayed call's result shares no memory with the graph: it is
    unchanged after later calls on other frames, which get their own."""
    dense, cfg, dcfg, prev, nxt = _pair_setup("A", 483, 861)
    other = _frames(2, 483, 861, "cuda", seed=5)
    want_other = dense._pair_eager(other[0], other[1], cfg, dcfg, None)
    for _ in range(2):
        dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)
    first = dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)
    kept = [x.clone() for x in first]
    seconds = [dense.dense_pyramidal_lk(other[0], other[1], cfg,
                                        dense_cfg=dcfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert dense.pair_graph_counts["replays"] == 4
    assert _same(first, kept)
    assert all(_same(s, want_other) for s in seconds)
    assert not _same(first, want_other)


def _device_kernels(run):
    """The names of the device operations of one ``run()`` under
    torch.profiler, with their counts.  A lead of device spins the host
    waits out comes first: the profiler can lose a trace's first
    kernels."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        run()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)


@pytest.mark.cuda
@pytest.mark.parametrize("path,level0", [("A", "lk"), ("B", "local_warp")])
def test_pair_graph_counts_launches(cuda_device, path, level0):
    """The kernel wrappers count the launches they make: the capturing call
    counts as the op-by-op call, a replayed call only its level 0's one
    launch.  A replayed call's device trace holds the op-by-op call's
    kernels of the port, name by name; on path A every device operation
    (path B's capture also builds the box sums' index tensors, which the
    op-by-op call takes from ``blur``'s cache)."""
    dense, cfg, dcfg, prev, nxt = _pair_setup(path, 1080, 1920)

    def run():
        dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)

    def counted():
        for m in (blur, lk, wk):
            m.reset_counters()
        run()
        return {"lk": sum(lk.kernel_launches_by_variant.values()),
                **wk.kernel_launches, "pyr_down": blur.kernel_launches,
                "plain": (lk.plain_calls + sum(wk.plain_calls.values())
                          + blur.plain_calls)}

    eager, capturing, replayed = counted(), counted(), counted()
    assert dense.pair_graph_counts == {"captures": 1, "replays": 2,
                                       "eager": 1}
    assert eager["pyr_down"] == 1 and eager["plain"] == 0
    assert sum(eager.values()) > 2
    assert capturing == eager
    assert replayed == {k: int(k == level0) for k in eager}
    def ours(trace):
        return {k: n for k, n in trace.items() if path == "A" or any(
            name in k for name in ("pyramid_kernel", "fused_lk_level",
                                   "local_warp", "fused_level_pre"))}

    for _ in range(2):       # a second trace where the profiler lost one
        dense._pair_graphs.clear()
        want = ours(_device_kernels(run))
        run()
        got = ours(_device_kernels(run))
        if got == want:
            break
    assert dense.pair_graph_counts["replays"] >= 4
    assert any("pyramid_kernel" in k for k in got)
    assert got == want, (got, want)


@pytest.mark.cuda
def test_pair_graph_one_entry_per_stream(cuda_device):
    """The current stream is part of the key: calls on two streams capture
    two graphs, each replayed on its own stream."""
    dense, cfg, dcfg, prev, nxt = _pair_setup("A", 483, 861)
    want = dense._pair_eager(prev, nxt, cfg, dcfg, None)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs += [dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)
                     for _ in range(3)]
    torch.cuda.synchronize()
    assert len(dense._pair_graphs) == 2
    assert dense.pair_graph_counts == {"captures": 2, "replays": 4,
                                       "eager": 2}
    assert all(_same(o, want) for o in outs)


@pytest.mark.cuda
def test_pair_graph_not_taken(cuda_device):
    """A call inside an enclosing capture and a call with ``init_flow`` run
    op by op and make no key; the enclosing graph replays the program."""
    dense, cfg, dcfg, prev, nxt = _pair_setup("A", 483, 861)
    want = dense._pair_eager(prev, nxt, cfg, dcfg, None)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        inside = dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)
    graph.replay()
    top = dense._effective_cfg(cfg, dcfg, (483, 861)).max_level
    init = torch.full(((483 >> top), (861 >> top), 2), 0.5,
                      device=cuda_device)
    want_init = dense._pair_eager(prev, nxt, cfg, dcfg, init)
    seeded = [dense.dense_pyramidal_lk(prev, nxt, cfg, init, dcfg)
              for _ in range(3)]
    torch.cuda.synchronize()
    assert dense.pair_graph_counts == {"captures": 0, "replays": 0,
                                       "eager": 4}
    assert len(dense._pair_graphs) == 0
    assert _same(inside, want)
    assert all(_same(s, want_init) for s in seeded)


@pytest.mark.cuda
def test_pair_graph_threads_share_a_key(cuda_device):
    """Threads calling on one stream share one key and its static pair
    buffer: the entry's lock keeps each call's copy-in, replay and level 0
    together, so every result equals its op-by-op result."""
    import sys
    import threading

    dense, cfg, dcfg, prev, nxt = _pair_setup("A", 483, 861)
    pairs = [_frames(2, 483, 861, "cuda", seed=s) for s in range(4)]
    wants = [dense._pair_eager(p[0], p[1], cfg, dcfg, None) for p in pairs]
    dense.dense_pyramidal_lk(prev, nxt, cfg, dense_cfg=dcfg)
    got, errors = {}, []

    def work(t):
        try:
            for i in range(6):
                p = pairs[(t + i) % len(pairs)]
                got[t, i] = (dense.dense_pyramidal_lk(p[0], p[1], cfg,
                                                      dense_cfg=dcfg),
                             (t + i) % len(pairs))
        except Exception as e:      # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    assert len(dense._pair_graphs) == 1
    assert dense.pair_graph_counts == {"captures": 1, "replays": 72,
                                       "eager": 1}
    assert len(got) == 72
    assert all(_same(r, wants[k]) for r, k in got.values())
