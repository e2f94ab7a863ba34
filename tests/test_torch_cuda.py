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
    """A small batched serving run through both kernels equals the same run
    through their plain versions; kernel A launches once per feed, kernel
    B three times (once per level) per processed frame, the pyramid once
    per fold."""
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

    finish.reset_counters()
    sparse.reset_counters()
    blur.reset_counters()
    kern = run()
    assert (finish.kernel_launches, finish.plain_calls) == (2, 0)
    assert (sparse.kernel_launches, sparse.plain_calls) == (3 * 8, 0)
    # the tracker's pyramid: once for the chunk's seed, once per frame
    assert (blur.kernel_launches, blur.plain_calls) == (1 + 8, 0)
    old = finish.fused_finish, sparse.gather_windows
    finish.fused_finish = finish.fused_finish_reference
    sparse.gather_windows = sparse.gather_windows_reference
    try:
        plain = run()
    finally:
        finish.fused_finish, sparse.gather_windows = old
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
def test_video_pipeline_kernel_equals_plain(cuda_device):
    """A short single-stream VideoPipeline run on the card: one pyramid
    launch per tracked frame, no plain call, and the same rows as the run
    with the plain pyramid."""
    import dataclasses

    from lk_tpu_torch.models import PRESETS
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

    blur.reset_counters()
    finish.reset_counters()
    sparse.reset_counters()
    kern = run()
    assert (blur.kernel_launches, blur.plain_calls) == (12, 0)
    assert finish.kernel_launches == sparse.kernel_launches == 0
    real = sparse.build_pyramid
    sparse.build_pyramid = blur.build_pyramid_reference
    try:
        plain = run()
    finally:
        sparse.build_pyramid = real
    assert kern.frames_done == 12
    assert kern.csv_rows == plain.csv_rows
    assert kern.vp_per_frame == plain.vp_per_frame


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
