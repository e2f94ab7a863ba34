"""lk_tpu_torch.ops against lk_tpu.ops on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lk_tpu.ops.blur import pyr_down as jax_pyr_down
from lk_tpu.ops.resize import upsample2_linear as jax_upsample2_linear
from lk_tpu_torch.ops import pyr_down, upsample2_linear


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("hw", [(64, 96), (63, 97), (136, 256), (17, 30)])
def test_pyr_down_matches_lk_tpu(rng, hw, fast):
    img = (rng.random(hw) * 255).astype(np.float32)
    ref = np.asarray(jax_pyr_down(jnp.asarray(img), fast=fast))
    out = pyr_down(torch.from_numpy(img), fast=fast).numpy()
    assert out.shape == ref.shape == (-(-hw[0] // 2), -(-hw[1] // 2))
    # Same five-tap f32 sums; lk_tpu folds the column pass (both passes
    # with fast=True) into a matmul whose accumulation order differs: a few
    # ulps at 255 (f32 ulp there is 1.5e-5).
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_pyr_down_batch_is_per_frame_bitwise(rng):
    """A chunk of frames decimates exactly as the frames one at a time (the
    chunked video path relies on it)."""
    frames = torch.from_numpy((rng.random((3, 70, 90)) * 255)
                              .astype(np.float32))
    stacked = pyr_down(frames)
    for i in range(3):
        assert torch.equal(stacked[i], pyr_down(frames[i]))


@pytest.mark.parametrize("dst", [(34, 46), (33, 45), (34, 45)])
def test_upsample2_linear_matches_lk_tpu(rng, dst):
    src = ((rng.random((2, 17, 23)) - 0.5) * 8).astype(np.float32)
    ref = np.asarray(jax_upsample2_linear(jnp.asarray(src), *dst))
    out = upsample2_linear(torch.from_numpy(src), *dst).numpy()
    assert out.shape == ref.shape == (2,) + dst
    # the same two-term f32 blends in the same order: bit-identical
    np.testing.assert_array_equal(out, ref)


def test_upsample2_linear_rejects_non_2x():
    with pytest.raises(ValueError):
        upsample2_linear(torch.zeros(2, 10, 10), 25, 20)
