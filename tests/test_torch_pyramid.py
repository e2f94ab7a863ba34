"""The pyramid build, lk_tpu_torch.ops.blur.build_pyramid, against lk_tpu
on the same numpy frames (CPU), and the device guard every kernel launch
goes through.

* ``build_pyramid_reference`` against ``lk_tpu.flow.dense.build_frame_levels``
  with ``fast_pyramid=False``: the edge-padded base is exact (bit-equal);
  each level within 1e-4, the bound tests/test_torch_ops.py states for
  lk_tpu's exact pyr_down, whose column pass is a matmul that sums in
  another order (a few ulps at 255).
* Against the TPU kernel ``pallas_pyr_down_pair`` (interpret mode, as
  tests/test_pallas_warp.py runs it): 0.6, its bf16 column pass.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lk_tpu.flow.pallas_kernels as pk
from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow import dense as jd
from lk_tpu_torch import _build
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.flow import sparse as ts
from lk_tpu_torch.ops import blur
from torch_parity import interpret_pallas, port_cfg

CFG = LKConfig()
PYRAMID = DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True)


def _planes(rng, shape):
    return (rng.random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("hw,dcfg,padded", [
    ((82, 512), PYRAMID, True),              # rows: 82x512 -> 96x512
    ((90, 1900), PYRAMID, True),             # both: -> 96x2048 (as 1080p)
    ((96, 160), DenseLKConfig(), False),     # the default config: no pad
    ((99, 301), DenseLKConfig(), False),     # odd sizes, 3 levels
])
def test_reference_matches_lk_tpu_build_frame_levels(rng, hw, dcfg, padded):
    frame = _planes(rng, hw)
    want = jd.build_frame_levels(jnp.asarray(frame), CFG, dcfg)
    hp, wp = want[0].shape
    assert ((hp, wp) != hw) == padded
    got = blur.build_pyramid_reference(torch.from_numpy(frame),
                                       len(want) - 1, (hp, wp))
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)
    # the port's build_frame_levels is this one call
    port = td.build_frame_levels(torch.from_numpy(frame), port_cfg(CFG),
                                 port_cfg(dcfg))
    assert all(torch.equal(a, b) for a, b in zip(port, got))


@pytest.mark.parametrize("h,w", [(16, 512), (96, 512)])
def test_reference_matches_pallas_pyr_down_pair(rng, monkeypatch, h, w):
    interpret_pallas(monkeypatch)
    a, b = _planes(rng, (h, w)), _planes(rng, (h, w))
    pa, pb = pk.pallas_pyr_down_pair(jnp.asarray(a), jnp.asarray(b))
    got = blur.build_pyramid_reference(torch.from_numpy(np.stack([a, b])),
                                       1)[1]
    for g, want in zip(got, (pa, pb)):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=0.6)


@pytest.mark.parametrize("shape,pad,levels", [
    ((3, 37, 53), (40, 60), 3),
    ((4, 17, 30), None, 4),                 # down to 2x2, then 1x1
    ((2, 1, 9), None, 2),                   # the n == 1 clamp
])
def test_stack_is_frames_one_at_a_time(rng, shape, pad, levels):
    """A stack of frames builds bit for bit as the frames one at a time
    (the chunked video relies on it)."""
    frames = torch.from_numpy(_planes(rng, shape))
    stacked = blur.build_pyramid(frames, levels, pad)
    assert len(stacked) == levels + 1
    for i in range(shape[0]):
        one = blur.build_pyramid(frames[i], levels, pad)
        for a, b in zip(stacked, one):
            assert torch.equal(a[i], b)


def test_pad_seam_is_edge_pad_then_reflect(rng):
    """Edge pad to (hp, wp), then REFLECT_101 on the padded extent: a
    1080 -> 1088 base in small (10 -> 16 rows): the first level's last rows
    read pad rows that replicate row 9 and reflect at 16, not 10."""
    frame = torch.from_numpy(_planes(rng, (10, 24)))
    got = blur.build_pyramid(frame, 2, (16, 32))
    padded = torch.from_numpy(np.pad(frame.numpy(), ((0, 6), (0, 8)),
                                     mode="edge"))
    assert torch.equal(got[0], padded)
    assert torch.equal(got[1], blur.pyr_down(padded))
    assert torch.equal(got[2], blur.pyr_down(got[1]))
    assert got[1].shape == (8, 16) and got[2].shape == (4, 8)


def test_unpadded_base_is_the_input_and_counts(rng):
    """No pad: level 0 is the f32 input itself, no copy; one plain call per
    pyramid, none for a pyramid of no levels; pyr_down is level 1."""
    frames = torch.from_numpy(_planes(rng, (2, 20, 30)))
    blur.reset_counters()
    levels = blur.build_pyramid(frames, 2)
    assert levels[0] is frames
    assert (blur.plain_calls, blur.kernel_launches) == (1, 0)
    assert torch.equal(levels[1], blur.pyr_down(frames))
    assert blur.build_pyramid(frames, 0)[0] is frames
    assert blur.plain_calls == 2


def test_rejects_bad_arguments():
    x = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):          # pad smaller than the frames
        blur.build_pyramid(x, 1, (6, 8))
    with pytest.raises(ValueError):          # a pad needs a level
        blur.build_pyramid(x, 0, (10, 10))
    with pytest.raises(ValueError):
        blur.build_pyramid(torch.zeros(0, 8, 8), 1)
    with pytest.raises(ValueError):
        blur.build_pyramid(torch.zeros(8), 1)


def test_tracker_fold_is_one_pyramid(rng):
    """The serving tracker's fold builds its levels with one call."""
    imgs = torch.from_numpy(_planes(rng, (2, 96, 128)))
    tcfg = port_cfg(CFG)
    blur.reset_counters()
    folded = ts.fold_tracking_levels(imgs, tcfg)
    assert len(folded) == tcfg.max_level + 1
    assert blur.plain_calls == 1


def test_launch_enters_the_tensor_device(monkeypatch):
    """_build.launch calls the C launcher with the tensor's device current
    and that device's current stream appended, and raises on a CUDA error
    code (stand-ins for torch.cuda's device guard and streams)."""
    current = ["cuda:0"]
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(str(dev))
        old, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = old

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + int(str(dev).split(":")[1])

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    t = types.SimpleNamespace(device="cuda:1")    # a tensor on the 2nd card
    calls = []

    def fn(*args):
        calls.append((current[0], args))
        return 0

    _build.launch(fn, t, "fake", 7, 8)
    assert entered == ["cuda:1"] and current == ["cuda:0"]
    assert calls == [("cuda:1", (7, 8, 1001))]
    with pytest.raises(RuntimeError, match="fake kernel launch failed"):
        _build.launch(lambda *a: 719, t, "fake")
    assert current == ["cuda:0"]
