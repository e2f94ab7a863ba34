"""lk_tpu_torch as a package: nothing of JAX, lk_tpu, OpenCV or
matplotlib at import, its own configs and presets equal to lk_tpu's, the
apps' dispatcher, the unported branch refuses and the
single-stream step runs, the entry point holds lk_tpu's flagship program,
and chip_smoke.py refuses to run without a GPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

import lk_tpu.config as jc
import lk_tpu_torch.config as tc
from lk_tpu.models import PRESETS as J_PRESETS
from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.models import PRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


PORT_MODULES = (
    "lk_tpu_torch", "lk_tpu_torch._build", "lk_tpu_torch.config",
    "lk_tpu_torch.models", "lk_tpu_torch.ops", "lk_tpu_torch.ops.blur",
    "lk_tpu_torch.ops.boxfilter", "lk_tpu_torch.ops.color",
    "lk_tpu_torch.ops.finish", "lk_tpu_torch.ops.gradients",
    "lk_tpu_torch.ops.rasterize", "lk_tpu_torch.ops.resize",
    "lk_tpu_torch.ops.tone", "lk_tpu_torch.ops.warp",
    "lk_tpu_torch.features.shi_tomasi", "lk_tpu_torch.entry",
    "lk_tpu_torch.flow.dense", "lk_tpu_torch.flow.lk_kernels",
    "lk_tpu_torch.flow.warp_kernels",
    "lk_tpu_torch.flow.sparse", "lk_tpu_torch.geometry.classify",
    "lk_tpu_torch.geometry.crosspoints", "lk_tpu_torch.geometry.flowlines",
    "lk_tpu_torch.geometry.vanishing", "lk_tpu_torch.pipeline.runner",
    "lk_tpu_torch.pipeline.state", "lk_tpu_torch.pipeline.step",
    "lk_tpu_torch.pipeline.tracker", "lk_tpu_torch.utils.checkpoint",
    "lk_tpu_torch.io.prefetch", "lk_tpu_torch.io.sink",
    "lk_tpu_torch.io.video", "lk_tpu_torch.io.raw", "lk_tpu_torch.io.native",
    "lk_tpu_torch.geometry.hough", "lk_tpu_torch.ops.homography",
    "lk_tpu_torch.utils.profiling", "lk_tpu_torch.viz",
    "lk_tpu_torch.apps", "lk_tpu_torch.apps.__main__",
    "lk_tpu_torch.apps._common", "lk_tpu_torch.apps.final",
    "lk_tpu_torch.apps.vp_detect", "lk_tpu_torch.apps.classify",
    "lk_tpu_torch.apps.masking", "lk_tpu_torch.apps.roadlines",
    "lk_tpu_torch.apps.display", "lk_tpu_torch.apps.serve")


def test_import_pulls_no_jax():
    """In a fresh process, importing every module of the port (the apps
    too) loads no jax, no cv2, no matplotlib and no module of lk_tpu (not
    even its config): presentation imports OpenCV and matplotlib only
    when it draws."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'cv2', 'lk_tpu', "
            "'matplotlib') or m.startswith(('jax.', 'cv2.', 'lk_tpu.', "
            "'matplotlib.'))]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["LKConfig", "DenseLKConfig",
                                  "FeatureConfig", "ROIConfig",
                                  "PipelineConfig"])
def test_config_parity(name):
    """The port's copy of each config class has lk_tpu's fields, defaults
    and derived values, field for field."""
    j, t = getattr(jc, name), getattr(tc, name)
    jf, tf = _fields(j), _fields(t)
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, a), (_, b) in zip(tf, jf):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), n
        else:
            assert a == b, n
    jd, td_ = j(), t()
    for meth, args in [("level_iters", range(6)), ("level_local", range(6)),
                       ("level_disp", range(6)),
                       ("derived_height", [(1080, 1920), (720, 1280),
                                           (242, 430)])]:
        if hasattr(j, meth):
            for a in args:
                a = a if isinstance(a, tuple) else (a,)
                assert getattr(td_, meth)(*a) == getattr(jd, meth)(*a)
    if name == "LKConfig":
        assert td_.half_win == jd.half_win


def test_presets_parity():
    """lk_tpu_torch.models.PRESETS holds lk_tpu's three VP presets."""
    assert {k: dataclasses.asdict(v) for k, v in PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in J_PRESETS.items()}


@pytest.mark.parametrize("name", ["MASKING", "ROADLINES"])
def test_tracker_presets_parity(name):
    """MASKING and ROADLINES equal lk_tpu's, field for field (the configs
    inside as the port's own classes)."""
    import lk_tpu.models as jm
    import lk_tpu_torch.models as tm

    j, t = getattr(jm, name), getattr(tm, name)
    assert list(t) == list(j)
    for k, v in j.items():
        if dataclasses.is_dataclass(v):
            assert type(t[k]) is getattr(tc, type(v).__name__), k
            assert dataclasses.asdict(t[k]) == dataclasses.asdict(v), k
        else:
            assert t[k] == v, k


def test_apps_dispatch():
    """python -m lk_tpu_torch.apps dispatches lk_tpu's six apps; without
    one it prints the usage and exits 2."""
    from lk_tpu.apps.__main__ import APPS as J_APPS
    from lk_tpu_torch.apps.__main__ import APPS

    assert APPS == J_APPS
    proc = _run(["-m", "lk_tpu_torch.apps"], REPO)
    assert proc.returncode == 2 and "|".join(APPS) in proc.stdout
    proc = _run(["-m", "lk_tpu_torch.apps", "serve", "--help"], REPO)
    assert proc.returncode == 0 and "--async-drains" in proc.stdout


def _pair(h=64, w=128):
    g = torch.Generator().manual_seed(0)
    return torch.rand((h, w), generator=g), torch.rand((h, w), generator=g)


@pytest.mark.parametrize("case", ["padded_build", "single_stream_step"])
def test_unported_branch_raises(case):
    """padded_build is not ported and refuses; the single-stream step (a
    stub until the serving slice's remainder) runs one frame on the CPU
    and keeps lk_tpu's single-stream shapes."""
    prv, nxt = _pair()
    cfg = LKConfig(max_level=1)
    if case == "padded_build":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            td.dense_pyramidal_lk_video(torch.stack([prv, nxt]), cfg,
                                        DenseLKConfig(use_pallas_fused=True,
                                                      padded_build=True))
        return
    from lk_tpu_torch.ops.rasterize import build_roi_masks
    from lk_tpu_torch.pipeline.runner import make_chunk_runner
    from lk_tpu_torch.pipeline.step import make_step

    pcfg = tc.PipelineConfig(width=128)
    full, subs = build_roi_masks(128, 64, pcfg.roi)
    step, _, _ = make_step(pcfg, (128, 64), full, subs, device="cpu")
    _, init_fn, _ = make_chunk_runner(pcfg, (128, 64), device="cpu")
    state = init_fn(prv * 255)
    new, out = step(state, nxt * 255)
    assert new.prev_gray.shape == (64, 128)
    assert new.pts.shape == state.pts.shape == (pcfg.num_groups,
                                                pcfg.tp_num
                                                // pcfg.num_groups, 2)
    assert new.tp_ult.shape == () and int(new.tp_ult) == 1
    assert out.show_mask.shape == () and out.vp_xy.shape == (2,)
    assert torch.equal(new.prev_gray, nxt * 255)


def test_entry_is_path_a():
    """entry() holds __graft_entry__.entry()'s program: the per-pair dense
    flow with DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True) and
    LKConfig() on rng(0) noise x 255 at 1080x1920, f32 (fn is not run)."""
    import numpy as np

    from lk_tpu_torch import entry as te

    fn, (prv, nxt) = te.entry(device="cpu")
    assert callable(fn)
    assert te.CFG == LKConfig()
    assert te.DENSE_CFG == DenseLKConfig(use_pallas_warp=True,
                                         pallas_pyramid=True)
    rng = np.random.default_rng(0)
    for t in (prv, nxt):
        assert t.device.type == "cpu" and t.dtype == torch.float32
        assert tuple(t.shape) == (1080, 1920)
        want = rng.random((1080, 1920)).astype(np.float32) * 255
        assert np.array_equal(t.numpy(), want)


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
    for src in _build.SOURCES + _build.HEADERS:
        assert os.path.isfile(os.path.join(REPO, "lk_tpu_torch", src))
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_build_key_tracks_headers(tmp_path, monkeypatch):
    """Every csrc header a source includes is hashed: an edited header
    makes a new build key (a stale library is never reused)."""
    import glob
    import shutil as sh

    from lk_tpu_torch import _build

    csrc = os.path.join(REPO, "lk_tpu_torch", "csrc")
    included = {os.path.basename(h) for h in glob.glob(
        os.path.join(csrc, "*.cuh"))}
    assert included == {os.path.basename(h) for h in _build.HEADERS}
    pkg = tmp_path / "pkg"
    sh.copytree(csrc, pkg / "csrc")
    monkeypatch.setattr(_build, "_PKG", pkg)
    before = _build.build_dir()
    with open(pkg / _build.HEADERS[0], "a") as f:
        f.write("// edited\n")
    assert _build.build_dir() != before


@pytest.mark.parametrize("app", ["final", "vp_detect", "classify", "masking",
                                 "roadlines", "serve"])
def test_app_flags_match_lk_tpu(app, capsys):
    """Each app's command line has lk_tpu's flags, no more, no fewer (from
    argparse's usage line)."""
    import importlib
    import re

    flags = []
    for pkg in ("lk_tpu", "lk_tpu_torch"):
        module = importlib.import_module(f"{pkg}.apps.{app}")
        with pytest.raises(SystemExit):
            module.main(["--help"])
        usage = capsys.readouterr().out.split("\n\n")[0]
        flags.append(sorted(re.findall(r"\[(-[-\w]+)", usage)))
    assert flags[0] == flags[1] and len(flags[0]) > 3
