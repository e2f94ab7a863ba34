"""lk_tpu_torch as a package: no JAX, unported branches refuse, and
chip_smoke.py refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow import dense as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_pulls_no_jax():
    code = ("import sys, lk_tpu_torch, lk_tpu_torch._build, "
            "lk_tpu_torch.flow.dense, lk_tpu_torch.flow.lk_kernels, "
            "lk_tpu_torch.ops; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lk_tpu.flow', 'lk_tpu.ops', 'cv2'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _pair(h=64, w=128):
    g = torch.Generator().manual_seed(0)
    return torch.rand((h, w), generator=g), torch.rand((h, w), generator=g)


@pytest.mark.parametrize("case", [
    "xla_level", "precomputed_a", "pallas_pyramid_per_pair",
    "padded_build", "batched"])
def test_unported_branch_raises(case):
    prv, nxt = _pair()
    cfg = LKConfig(max_level=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if case == "xla_level":
            td.dense_pyramidal_lk(prv, nxt, cfg, dense_cfg=DenseLKConfig())
        elif case == "precomputed_a":
            td.dense_pyramidal_lk(prv, nxt, cfg, dense_cfg=DenseLKConfig(
                use_pallas_fused=True, fused_grads_in_kernel=False))
        elif case == "pallas_pyramid_per_pair":
            td.dense_pyramidal_lk(prv, nxt, cfg, dense_cfg=DenseLKConfig(
                use_pallas_warp=True, pallas_pyramid=True))
        elif case == "padded_build":
            td.dense_pyramidal_lk_video(torch.stack([prv, nxt]), cfg,
                                        DenseLKConfig(use_pallas_fused=True,
                                                      padded_build=True))
        else:
            td.dense_pyramidal_lk_batched(prv[None], nxt[None], cfg)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="with a CUDA device chip_smoke.py runs in full")
def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device chip_smoke.py exits non-zero at once and
    prints no result line."""
    proc = _run(["chip_smoke.py"], REPO, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "kernels" not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Run from a directory holding only chip_smoke.py, it fails too (with
    or without a CUDA device: the package is missing)."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path), timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_key_tracks_sources():
    """The kernel library is keyed by a hash of the sources and flags and
    lives in the package's git-ignored _build directory."""
    from lk_tpu_torch import _build

    d = _build.build_dir()
    assert d.parent.name == "_build" and d.parent.parent.name == "lk_tpu_torch"
    assert d == _build.build_dir()
    for src in _build.SOURCES:
        assert os.path.isfile(os.path.join(REPO, "lk_tpu_torch", src))
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
