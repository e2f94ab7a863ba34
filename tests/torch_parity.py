"""Shared helpers of the tests that hold lk_tpu_torch against lk_tpu."""

import types

import numpy as np
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

# The tests run in several worker processes at once: one PyTorch intra-op
# thread per process keeps them from oversubscribing the cores (the port's
# CPU tests are small; more threads do not make them faster).
torch.set_num_threads(1)

# tests/test_pallas_warp.py's affine step: frame t+1 = AFFINE(frame t)
AFFINE = np.float32([[1.002, 0.0005, 1.2], [-0.0005, 0.999, -0.8]])


def interpret_pallas(monkeypatch):
    """Run every pl.pallas_call in interpret mode (CPU), as
    tests/test_pallas_warp.py does."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


class _F32Jnp(types.ModuleType):
    """jax.numpy with ``bfloat16`` standing for float32."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


def f32_jnp() -> types.ModuleType:
    """A stand-in for ``pallas_kernels.jnp`` under which the Pallas makers'
    bf16 casts (MXU box sums, coarse upsample) stay f32."""
    return _F32Jnp("jax.numpy.f32")


def affine_clip(rng, h, w, n):
    """n frames of blurred noise, each AFFINE of the one before; every
    pair's exact flow is AFFINE(p) - p."""
    import cv2 as cv

    img = (rng.random((h, w)) * 255).astype(np.float32)
    img = cv.GaussianBlur(img, (0, 0), 2.0)
    frames = [img]
    for _ in range(n - 1):
        frames.append(cv.warpAffine(frames[-1], AFFINE, (w, h),
                                    flags=cv.INTER_LINEAR,
                                    borderMode=cv.BORDER_REFLECT_101))
    return np.stack(frames)


def port_cfg(cfg):
    """The port's copy of an ``lk_tpu.config`` dataclass, built field for
    field (nested configs rebuilt): the port imports nothing of lk_tpu, so
    the tests hand it its own config classes."""
    import dataclasses

    import lk_tpu_torch.config as tc

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k, v in kw.items():
        if dataclasses.is_dataclass(v):
            kw[k] = port_cfg(v)
    return getattr(tc, type(cfg).__name__)(**kw)
