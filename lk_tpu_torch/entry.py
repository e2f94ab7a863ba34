"""The port's counterpart of ``__graft_entry__.entry()``: the flagship
program, per-pair dense pyramidal LK at 1080p, with its example inputs.

``entry()`` returns ``(fn, (prev, next))``: ``fn`` runs
``dense_pyramidal_lk(...).flow`` with the production config,
``DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True)`` and
``LKConfig()`` defaults (the pyramid base pre-padded to 1088x2048, the
pair's pyramid in one kernel launch, the grads-fused level at every
level), and the inputs are the same 1080x1920 frames as lk_tpu's,
``np.random.default_rng(0)`` noise times 255, float32.  The config does
not depend on the device: the device only picks the kernels (CUDA) or
their plain versions (CPU).

    from lk_tpu_torch.entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    flow = fn(*args)              # (1080, 1920, 2)
"""

from __future__ import annotations

import numpy as np
import torch

from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow.dense import dense_pyramidal_lk

CFG = LKConfig()
DENSE_CFG = DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True)
HEIGHT, WIDTH = 1080, 1920


def entry(device="cuda"):
    """(fn, example_args) of the flagship per-pair program on ``device``."""

    def fn(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        return dense_pyramidal_lk(prev, nxt, CFG, dense_cfg=DENSE_CFG).flow

    rng = np.random.default_rng(0)
    prev = rng.random((HEIGHT, WIDTH)).astype(np.float32) * 255
    nxt = rng.random((HEIGHT, WIDTH)).astype(np.float32) * 255
    return fn, (torch.as_tensor(prev, device=device),
                torch.as_tensor(nxt, device=device))
