"""lk_tpu_torch.io.video: the synthetic road stream without OpenCV,
against lk_tpu's (built with cv2), on the CPU; the file reader and the
source dispatch.

Tolerances, and why: the texture is drawn from the same rng calls and
blurred in OpenCV's own order of operations, so it equals lk_tpu's (the
bound is 1e-3, the measured difference 0).  A frame is the texture warped
with float bilinear coordinates, as cv.warpAffine does in OpenCV 5; a
float's last bit can flip the u8 truncation, so frames may differ by at
most 1 level on at most 0.1 % of their pixels (measured: <= 0.011 % over
these seeds and times).  At t = 0 the map is a pure translation and the
frames are equal."""

import numpy as np
import pytest
import torch

import cv2 as cv

from lk_tpu.io import video as jvideo
from lk_tpu_torch.io import video as tvideo

W, H, F = 430, 242, 24


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_matches_lk_tpu(seed):
    kw = dict(width=W, height=H, n_frames=F, seed=seed, zoom=1.03,
              vp=(W * (0.45 + 0.01 * seed), H * 0.45))
    j = jvideo.SyntheticRoadStream(**kw)
    t = tvideo.SyntheticRoadStream(**kw, device="cpu")
    assert t.tex.shape == j.tex.shape and t.tex.dtype == torch.float32
    np.testing.assert_allclose(t.tex.numpy(), j.tex, rtol=0, atol=1e-3)
    assert t.tex_off == j.tex_off and t.vp == j.vp
    for tt in (0, 5, 23):
        a, b = j.frame(tt), t.frame(tt)
        assert a.shape == b.shape == (H, W, 3) and b.dtype == np.uint8
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1
        assert (d > 0).mean() <= 1e-3
        if tt == 0:
            np.testing.assert_array_equal(a, b)


def test_gray_frames_iteration_and_color():
    """gray_frames, frame(t) and iteration agree; color=False gives the
    gray frame; a batch renders as the frames one at a time."""
    s = tvideo.SyntheticRoadStream(width=160, height=90, n_frames=19,
                                   seed=3, device="cpu")
    g = s.gray_frames(0, 19)
    assert g.shape == (19, 90, 160) and g.dtype == torch.uint8
    frames = list(s)
    assert len(frames) == 19
    for t in (0, 7, 18):
        np.testing.assert_array_equal(frames[t], s.frame(t))
        np.testing.assert_array_equal(frames[t][..., 0], g[t].numpy())
        np.testing.assert_array_equal(frames[t][..., 2], g[t].numpy())
        np.testing.assert_array_equal(s.gray_frames(t, 1)[0], g[t])
    gs = tvideo.SyntheticRoadStream(width=160, height=90, n_frames=19,
                                    seed=3, color=False, device="cpu")
    np.testing.assert_array_equal(gs.frame(7), g[7].numpy())


@pytest.mark.parametrize("sigma", [1.5, 6.0])
def test_gaussian_blur_equals_opencv(sigma):
    """The texture blur is bit-equal to cv.GaussianBlur on the CPU at a
    width that is a multiple of 16 (688, the 430-px stream's texture, is:
    OpenCV's vector loop then covers every column)."""
    img = (np.random.default_rng(5).random((97, 144)) * 255).astype(
        np.float32)
    got = tvideo.gaussian_blur(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_array_equal(got, cv.GaussianBlur(img, (0, 0), sigma))
    assert tvideo.gaussian_taps(sigma) == tuple(
        cv.getGaussianKernel(int(round(8 * sigma + 1)) | 1, sigma,
                             cv.CV_32F).ravel().tolist())


def test_video_reader_and_open_stream(tmp_path):
    """A file written with cv2 reads back through the port's VideoReader
    as through lk_tpu's; open_stream dispatches as lk_tpu's does."""
    path = str(tmp_path / "clip.avi")
    out = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    rng = np.random.default_rng(0)
    for _ in range(5):
        out.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    out.release()
    r = tvideo.open_stream(path)
    assert isinstance(r, tvideo.VideoReader)
    assert (r.width, r.height) == (64, 48)
    got = list(r)
    r.close()
    want = list(jvideo.VideoReader(path))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    s = tvideo.open_stream("synthetic", width=64, height=48, n_frames=3,
                           device="cpu")
    assert isinstance(s, tvideo.SyntheticRoadStream) and len(list(s)) == 3
    with pytest.raises(FileNotFoundError):
        tvideo.open_stream(str(tmp_path / "missing.avi"))
