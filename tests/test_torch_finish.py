"""The serving finish and the image ops around it: lk_tpu_torch against
lk_tpu on the same numpy inputs (CPU; lk_tpu's Pallas finish in interpret
mode).

Tolerances, and why: lk_tpu's ops called outside ``jit`` run op by op, so
each elementwise operation rounds once, as the port's do: those
comparisons are exact.  Inside ``jit`` (the runner's finish chain) XLA on
the CPU contracts ``(x - b0) * k + b1`` into an FMA, and the Pallas tone
path fuses to an FMA too (tests/test_pallas_finish.py): <= 1e-3 on 0..255
data there.  The blur's products are by powers of two, exact either way.
The matmul resize sums in another order: <= 1e-3."""

import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lk_tpu.config import PipelineConfig
from lk_tpu.ops import blur as jblur
from lk_tpu.ops import boxfilter as jbox
from lk_tpu.ops import color as jcolor
from lk_tpu.ops import gradients as jgrad
from lk_tpu.ops import rasterize as jras
from lk_tpu.ops import resize as jresize
from lk_tpu.ops import tone as jtone
from lk_tpu.ops.pallas_finish import fused_finish as j_fused_finish
from lk_tpu.pipeline import runner as jrunner
from lk_tpu_torch.ops import blur, boxfilter, color, gradients, rasterize
from lk_tpu_torch.ops import finish, resize, tone
from torch_parity import interpret_pallas, port_cfg

SHAPES = [(2, 64, 128), (1, 37, 250), (3, 61, 97)]


@pytest.fixture
def frames_u8(rng):
    return {s: rng.integers(0, 256, s).astype(np.uint8) for s in SHAPES}


@pytest.mark.parametrize("shape", SHAPES)
def test_finish_plain_matches_pallas_blur(monkeypatch, frames_u8, shape):
    """Exact: the Pallas kernel sums (0.25l + 0.5c) + 0.25r like the port."""
    interpret_pallas(monkeypatch)
    x = frames_u8[shape]
    want = np.asarray(j_fused_finish(jnp.asarray(x)))
    got = finish.fused_finish(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_finish_plain_matches_pallas_f32(monkeypatch, rng):
    interpret_pallas(monkeypatch)
    x = (rng.random((2, 40, 130)) * 255).astype(np.float32)
    want = np.asarray(j_fused_finish(jnp.asarray(x)))
    np.testing.assert_array_equal(
        finish.fused_finish(torch.from_numpy(x)).numpy(), want)


def test_finish_plain_matches_pallas_contrast(monkeypatch, frames_u8):
    """<= 1e-3: the Pallas tone path is an FMA (<= 1 ulp at image scale)."""
    interpret_pallas(monkeypatch)
    x = frames_u8[(2, 64, 128)]
    want = np.asarray(j_fused_finish(jnp.asarray(x), contrast=True))
    got = finish.fused_finish(torch.from_numpy(x), contrast=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("contrast", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_finish_plain_matches_xla_chain(frames_u8, shape, contrast):
    """Exact against lk_tpu's chain op by op (convert, tone, blur)."""
    x = frames_u8[shape]
    g = jnp.asarray(x).astype(jnp.float32)
    if contrast:
        g = jtone.contrast_brightness(g)
    want = np.asarray(jblur.gaussian_blur3(g))
    got = finish.fused_finish(torch.from_numpy(x), contrast=contrast)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("contrast", [False, True])
def test_runner_finish_matches_jitted_chain(frames_u8, contrast):
    """The runner's finish against lk_tpu's jitted runner chain: exact
    blur, <= 1e-3 with the tone curve (XLA's FMA contraction)."""
    from lk_tpu_torch.pipeline import runner

    cfg = dataclasses.replace(PipelineConfig(), contrast_enhance=contrast)
    x = frames_u8[(2, 64, 128)]
    want = np.asarray(jrunner._cached_finish(cfg)(jnp.asarray(x)))
    got = runner._cached_finish(port_cfg(cfg))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 if contrast else 0.0)


def test_finish_counts_plain_calls_on_cpu(frames_u8):
    """A CPU tensor takes the plain version and never the kernel."""
    finish.reset_counters()
    finish.fused_finish(torch.from_numpy(frames_u8[(2, 64, 128)]))
    assert (finish.plain_calls, finish.kernel_launches) == (1, 0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_finish_launch_arguments(rng, monkeypatch, dtype):
    """The kernel's wrapper, with a stand-in launcher on the CPU that
    writes the plain result where the kernel would: more frames than a
    grid dimension holds (65,535) go to one launch, with the dtype flag,
    the frame geometry and the tone constants."""
    from lk_tpu_torch import _build

    x = torch.from_numpy(rng.integers(0, 256, (70000, 2, 4)).astype(dtype))
    want = {c: finish.fused_finish_reference(x, c) for c in (False, True)}
    launches = []

    def launch(fn, t, name, *a):
        launches.append((fn, t, name, a))
        ctypes.memmove(a[2], want[bool(a[6])].data_ptr(), x.numel() * 4)

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        lk_finish_launch="finish"))
    monkeypatch.setattr(_build, "launch", launch)
    for contrast in (False, True):
        launches.clear()
        finish.reset_counters()
        out = finish._fused_finish_cuda(x, contrast)
        assert (finish.kernel_launches, finish.plain_calls) == (1, 0)
        (fn, t, name, a), = launches
        assert (fn, t, name) == ("finish", x, "finish")
        assert a[0] == x.data_ptr() and a[2] == out.data_ptr()
        assert a[1] == int(dtype == np.uint8)
        assert a[3:7] == (70000, 2, 4, int(contrast))
        assert a[7:] == pytest.approx(tone.tone_constants())
        assert torch.equal(out, want[contrast])


def test_finish_rejects_bad_input():
    with pytest.raises(ValueError):
        finish.fused_finish(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        finish.fused_finish(torch.zeros((1, 4, 4), dtype=torch.int16))


def test_gray_conversion(rng):
    """u8 fixed point bit-exact; the float path exact op by op."""
    bgr = rng.integers(0, 256, (2, 17, 23, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        color.bgr_to_gray_u8(torch.from_numpy(bgr)).numpy(),
        np.asarray(jcolor.bgr_to_gray_u8(jnp.asarray(bgr))))
    f = bgr.astype(np.float32)
    np.testing.assert_array_equal(
        color.bgr_to_gray(torch.from_numpy(f)).numpy(),
        np.asarray(jcolor.bgr_to_gray(jnp.asarray(f))))


def test_tone_exact(rng):
    x = (rng.random((19, 33)) * 255).astype(np.float32)
    for b, c in [(0.0, 100.0), (20.0, -40.0)]:
        np.testing.assert_array_equal(
            tone.contrast_brightness(torch.from_numpy(x), b, c).numpy(),
            np.asarray(jtone.contrast_brightness(jnp.asarray(x), b, c)))


@pytest.mark.parametrize("taps", [(0.25, 0.5, 0.25), (-0.5, 0.0, 0.5),
                                  (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)])
def test_sep_filter_exact(rng, taps):
    x = (rng.random((2, 21, 30)) * 255).astype(np.float32)
    for axis in (-1, -2):
        np.testing.assert_array_equal(
            blur._sep_filter_axis(torch.from_numpy(x), taps, axis).numpy(),
            np.asarray(jblur._sep_filter_axis(jnp.asarray(x), taps, axis)))
    np.testing.assert_array_equal(
        blur.sep_filter2d(torch.from_numpy(x), taps).numpy(),
        np.asarray(jblur.sep_filter2d(jnp.asarray(x), taps)))


@pytest.mark.parametrize("which", ["scharr", "sobel"])
def test_derivatives_exact(rng, which):
    """Exact: same taps, same order, same REFLECT_101 borders."""
    x = (rng.random((2, 26, 41)) * 255).astype(np.float32)
    jf = getattr(jgrad, f"{which}_derivatives")
    tf = getattr(gradients, f"{which}_derivatives")
    for a, b in zip(tf(torch.from_numpy(x)), jf(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("border", ["zero", "reflect", "edge"])
@pytest.mark.parametrize("win", [(7, 7), (15, 15), (4, 6)])
def test_box_sum_exact(rng, border, win):
    """Exact: shifted adds, rows then columns, taps in order."""
    x = (rng.random((2, 23, 37)) * 10).astype(np.float32)
    np.testing.assert_array_equal(
        boxfilter.box_sum(torch.from_numpy(x), win, border).numpy(),
        np.asarray(jbox.box_sum(jnp.asarray(x), win, border)))


def test_resize_area(rng):
    """<= 1e-3: both are two matmuls, summed in another order."""
    x = (rng.random((2, 90, 160)) * 255).astype(np.float32)
    np.testing.assert_array_equal(resize.area_weights(160, 70),
                                  jresize.area_weights(160, 70))
    got = resize.resize_area(torch.from_numpy(x), 39, 70).numpy()
    want = np.asarray(jresize.resize_area(jnp.asarray(x), 39, 70))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("wh", [(860, 483), (430, 242), (128, 64)])
def test_roi_masks_exact(wh):
    """Exact: the same float32 half-plane tests, on the host."""
    w, h = wh
    roi = PipelineConfig().roi
    troi = port_cfg(roi)
    jfull, jsubs = jras.build_roi_masks(w, h, roi)
    full, subs = rasterize.build_roi_masks(w, h, troi)
    np.testing.assert_array_equal(full, np.asarray(jfull))
    np.testing.assert_array_equal(subs, np.asarray(jsubs))
    np.testing.assert_array_equal(rasterize.roi_mask_points(w, h, troi),
                                  jras.roi_mask_points(w, h, roi))
