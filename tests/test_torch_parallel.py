"""lk_tpu_torch.parallel on gloo CPU process groups, against the port's
unsharded runs and lk_tpu's parallel layer (tests/test_parallel.py's legs)
on the same numpy inputs.

Each group of ranks is one set of OS processes (tests/torch_parallel_worker
.py), started once per module with one thread each and a free localhost
port, each with a timeout; lk_tpu runs in this process on conftest's
8-device CPU mesh, at the same shard count as the port's ranks.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import lk_tpu.parallel as jpar
from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow.dense import dense_lk_level as j_level
from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.flow import dense as td
from lk_tpu_torch.parallel.mesh import default_shape
from torch_parity import f32_jnp, interpret_pallas, port_cfg

_WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
RANK_TIMEOUT = 300          # s per rank process
# The port's dense_lk_level parity bound (tests/test_torch_dense_paths.py
# F32): where both sides agree on the gate, f32 summation order only.
F32 = dict(flow_max=1e-3, flow_mean=1e-5, flips=1e-4)
ROWS_TOL = 1e-4             # px, tests/test_parallel.py's serving bound
# The port's chunk step against lk_tpu's (tests/test_torch_video_pipeline
# .py): masks exact, positions 1e-3 px (window sums in another order, and
# XLA's FMA contraction inside jit).
STEP_TOL = 1e-3
PYR_TOL = 5e-3              # px, tests/test_parallel.py:122, every pixel
SPATIAL_MODES = ((False, False), (True, False), (False, True), (True, True))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _blur(x, sigma):
    import cv2 as cv

    return cv.GaussianBlur(x, (0, 0), sigma)


def _warp(img, dx, dy):
    import cv2 as cv

    h, w = img.shape
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR,
                         borderMode=cv.BORDER_REFLECT_101)


def _spawn(world, legs, inputs, tmp):
    """Run ``legs`` on ``world`` gloo ranks; every rank's results."""
    np.savez(tmp / "inputs.npz", **inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(r), str(world), str(port), str(tmp),
         *legs], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, \
            f"rank {r} failed (rc {p.returncode}):\n{out[-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz"),
                 **json.loads((tmp / f"rank{r}.json").read_text()))
            for r in range(world)]


@pytest.fixture(scope="module")
def inputs():
    # each scene as tests/test_parallel.py draws it, from its own rng
    def noise(h, w, sigma):
        rng = np.random.default_rng(1234)
        return _blur((rng.random((h, w)) * 255).astype(np.float32), sigma)

    h, w = 128, 256
    img, seam, auto = noise(h, w, 2.0), noise(h, w, 4.0), noise(256, 384, 2.0)
    frames = (np.random.default_rng(0).random((4, 4, 144, 256)) * 255
              ).astype(np.float32)
    road = _road_u8(4, 17, 256, 144)
    return {
        "halo_x": np.arange(16.0 * 4, dtype=np.float32).reshape(16, 4),
        "spatial_prev": img, "spatial_next": _warp(img, 2.0, 1.0),
        "spatial_flow": np.zeros((h, w, 2), np.float32),
        # flow at the displacement bound across the seam (row 64), its
        # coarse-level init 1.5 px from the truth
        "seam_prev": seam, "seam_next": _warp(seam, 0.0, 7.5),
        "seam_flow": np.tile(np.float32([0.0, 6.0]), (h, w, 1)),
        "auto_prev": auto, "auto_next": _warp(auto, 3.0, 2.0),
        "streams_frames": frames,
        # the serving scenes' first 5 frames, stream-major
        "road_frames": road[:5].transpose(1, 0, 2, 3).astype(np.float32),
        "serving_u8": road,
    }


def _road_u8(b, f, w, h):
    """tests/test_parallel.py's serving scenes: (f, b, h, w) u8 grays."""
    import cv2 as cv

    from lk_tpu.io.video import SyntheticRoadStream

    u8 = np.empty((f, b, h, w), np.uint8)
    for k in range(b):
        s = SyntheticRoadStream(width=w, height=h, zoom=1.03 + 0.002 * k,
                                seed=100 + k, n_frames=f,
                                vp=(90 + 5 * k, 60 + (k % 3) * 8))
        for t in range(f):
            u8[t, k] = cv.cvtColor(s.frame(t), cv.COLOR_BGR2GRAY)
    return u8


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    return _spawn(2, ["halo", "spatial", "seam", "streams", "serving"],
                  inputs, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def four_ranks(inputs, tmp_path_factory):
    return _spawn(4, ["halo", "auto"], inputs,
                  tmp_path_factory.mktemp("four_ranks"))


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _assert_close(want, got, valid_want, valid_got, flow_max, flow_mean,
                  flips):
    same = np.asarray(valid_want) == np.asarray(valid_got)
    assert (~same).mean() <= flips, (~same).mean()
    d = np.abs(np.asarray(want) - np.asarray(got))[same]
    assert d.max() < flow_max, d.max()
    assert d.mean() < flow_mean, d.mean()


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_rule(n):
    """make_mesh's default shape: spatial 2 when the rank count is even and
    > 2, data the rest (lk_tpu's rule, lk_tpu/parallel/mesh.py:20-30)."""
    want = jpar.make_mesh(devices=jax.devices()[:n]).devices.shape
    assert default_shape(n) == want


def test_mesh_shape_in_ranks(two_ranks, four_ranks):
    """make_mesh() over the world of the ranks: (2, 1) for 2, (2, 2) for
    4, as tests/test_parallel.py's 8-device mesh is (4, 2)."""
    assert all(tuple(r["mesh_shape"]) == (2, 1) for r in two_ranks)
    assert all(tuple(r["mesh_shape"]) == (2, 2) for r in four_ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_values(inputs, two_ranks, four_ranks, world):
    """Each rank's block with its neighbours' rows, the outer edges
    replicated: the same rows as lk_tpu's ppermute exchange at the same
    shard count (tests/test_parallel.py:62)."""
    from jax import shard_map

    ranks = two_ranks if world == 2 else four_ranks
    x = inputs["halo_x"]
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("spatial",))
    want = np.asarray(shard_map(
        lambda b: jpar.halo_exchange(b, 2, "spatial"), mesh=mesh,
        in_specs=P("spatial", None), out_specs=P("spatial", None))(
            jnp.asarray(x)))
    got = _cat(ranks, "halo")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], got[1])        # replicated edge
    np.testing.assert_array_equal(got[2], x[0])
    per = 16 // world
    np.testing.assert_array_equal(got[per + 2:per + 4], x[per:per + 2])


def _lk_tpu_spatial(inputs, leg, per_iter, fused, shards=2):
    """lk_tpu's spatial_dense_lk_level on ``shards`` devices of conftest's
    CPU mesh.  Its shard_map cannot trace a pallas_call (JAX asks for the
    output's mesh variance, which the Pallas makers do not give), so under
    ``use_pallas_fused`` the shards' own program, the local function of
    lk_tpu/parallel/spatial.py:123-176 with halo_exchange's rows, runs here
    shard by shard on the same blocks."""
    dcfg = DenseLKConfig(use_pallas_fused=fused, scharr_mxu=False)
    prev, nxt, flow = (jnp.asarray(inputs[f"{leg}_{k}"])
                       for k in ("prev", "next", "flow"))
    if not fused:
        mesh = Mesh(np.asarray(jax.devices()[:shards]), ("spatial",))
        fn = jpar.spatial_dense_lk_level(mesh, LKConfig(), dcfg, max_disp=8,
                                         exchange_per_iter=per_iter)
        sh2 = NamedSharding(mesh, P("spatial", None))
        sh3 = NamedSharding(mesh, P("spatial", None, None))
        return np.asarray(jax.jit(fn)(jax.device_put(prev, sh2),
                                      jax.device_put(nxt, sh2),
                                      jax.device_put(flow, sh3)))

    def exchange(x, halo):
        blocks = jnp.split(x, shards)
        out = []
        for i, b in enumerate(blocks):
            top = (jnp.repeat(b[:1], halo, 0) if i == 0
                   else blocks[i - 1][-halo:])
            bot = (jnp.repeat(b[-1:], halo, 0) if i == shards - 1
                   else blocks[i + 1][:halo])
            out.append(jnp.concatenate([top, b, bot]))
        return out

    def level(halo, f, d):
        rows = []
        for p_, n_, f_ in zip(exchange(prev, halo), exchange(nxt, halo),
                              exchange(f, halo)):
            rows.append(j_level(p_, n_, f_, LKConfig(), d,
                                max_disp=8).flow[halo:-halo])
        return jnp.concatenate(rows)

    base = 8 + 7 + 4
    if not per_iter:
        return np.asarray(level(base + 5 * 7, flow, dcfg))
    one = dataclasses.replace(dcfg, outer_iters=1, iter_schedule=())
    for _ in range(dcfg.outer_iters):
        flow = level(base, flow, one)
    return np.asarray(flow)


@pytest.mark.parametrize("per_iter,fused", SPATIAL_MODES)
def test_spatial_level_matches_lk_tpu(inputs, two_ranks, monkeypatch,
                                      per_iter, fused):
    """Both exchange modes, XLA level and fused kernel, over 2 row shards:
    every row (the replicated-edge belt included) within the port's
    dense_lk_level parity bound of lk_tpu's spatial_dense_lk_level on the
    same inputs and shard count (the fused kernels in interpret mode, their
    bf16 casts kept f32 as tests/test_torch_lk_level.py's "f32" cases do:
    the port is exact f32)."""
    import lk_tpu.flow.pallas_kernels as pk

    interpret_pallas(monkeypatch)
    monkeypatch.setattr(pk, "jnp", f32_jnp())
    want = _lk_tpu_spatial(inputs, "spatial", per_iter, fused)
    got = _cat(two_ranks, f"spatial_{int(per_iter)}{int(fused)}")
    ones = np.ones(want.shape[:2], bool)
    _assert_close(want, got, ones, ones, **F32)


def _port_level(inputs, leg, dcfg):
    return td.dense_lk_level(
        *(torch.from_numpy(inputs[f"{leg}_{k}"])
          for k in ("prev", "next", "flow")),
        port_cfg(LKConfig()), port_cfg(dcfg), max_disp=8).flow.numpy()


def _per_round(inputs, leg):
    """The unsharded level driven as the per-iteration exchange drives it:
    one-iteration calls, the eps mask tested on the clipped delta and
    applied outside the call (lk_tpu/parallel/spatial.py:150-153)."""
    cfg, dcfg = port_cfg(LKConfig()), port_cfg(DenseLKConfig())
    one = dataclasses.replace(dcfg, outer_iters=1, iter_schedule=())
    prev, nxt, f = (torch.from_numpy(inputs[f"{leg}_{k}"])
                    for k in ("prev", "next", "flow"))
    active = torch.ones(f.shape[:2], dtype=torch.bool)
    for _ in range(dcfg.outer_iters):
        f_new = td.dense_lk_level(prev, nxt, f, cfg, one, max_disp=8).flow
        d = f_new - f
        f = torch.where(active[..., None], f_new, f)
        active = active & (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                           > cfg.eps * cfg.eps)
    return f.numpy()


@pytest.mark.parametrize("per_iter", [False, True])
def test_spatial_interior_equals_unsharded(inputs, two_ranks, per_iter):
    """Outside the replicated-edge belt the sharded XLA level equals, bit
    for bit, the unsharded level (single exchange) or the unsharded
    per-round loop (per-iteration exchange): every operation is a
    stencil in a fixed order."""
    got = _cat(two_ranks, f"spatial_{int(per_iter)}0")
    want = (_per_round(inputs, "spatial") if per_iter
            else _port_level(inputs, "spatial", DenseLKConfig()))
    # the replicated edge rows' error front: the halo, then win//2 rows
    # per further iteration (per round, or inside the one call)
    belt = 8 + 7 + 4 + 5 * 7
    np.testing.assert_array_equal(got[belt:-belt], want[belt:-belt])


def test_spatial_seam_at_displacement_bound(inputs, two_ranks):
    """Flow at the max_disp bound crossing the seam (tests/test_parallel.py
    :186): both modes within 1e-2 of the unsharded level on interior rows;
    the per-iteration mode equal, bit for bit, to the unsharded per-round
    loop whose eps mask tests the clipped delta, and within the parity
    bound of lk_tpu's per-iteration mode: the eps carry reproduces
    lk_tpu/parallel/spatial.py:150-153."""
    single = _port_level(inputs, "seam", DenseLKConfig())
    assert abs(single[48:80, 32:-32, 1].mean() - 7.5) < 0.3
    for per_iter in (False, True):
        got = _cat(two_ranks, f"seam_{int(per_iter)}0")
        np.testing.assert_allclose(single[16:-16, 16:-16],
                                   got[16:-16, 16:-16], atol=1e-2)
    got = _cat(two_ranks, "seam_10")
    belt = 8 + 7 + 4 + 5 * 7
    np.testing.assert_array_equal(got[belt:-belt],
                                  _per_round(inputs, "seam")[belt:-belt])
    want = _lk_tpu_spatial(inputs, "seam", True, False)
    ones = np.ones(want.shape[:2], bool)
    _assert_close(want, got, ones, ones, **F32)


def test_stream_sharded_pipeline_matches_unsharded(inputs, two_ranks):
    """shard_pipeline_step over the data axis: every output leaf equals the
    unsharded per-stream run at the rows each rank owns, atol 1e-4
    (tests/multihost_worker.py:124-129), on tests/test_parallel.py:83's
    noise frames and on road scenes.  On the road scenes the ranks also
    equal lk_tpu's shard_pipeline_step over 2 devices: masks exactly,
    positions within STEP_TOL.  Not on the noise: there lk_tpu's jitted
    step moves tracked points far beyond STEP_TOL from its own op-by-op
    run (XLA's FMA contraction, amplified by ill-conditioned windows)."""
    from lk_tpu.config import PipelineConfig as JPipelineConfig
    from lk_tpu_torch.pipeline.runner import make_chunk_runner

    h, w = inputs["streams_frames"].shape[-2:]
    run_chunk, init_fn, _ = make_chunk_runner(PipelineConfig(), (w, h),
                                              "cpu")
    for scene in ("streams", "road"):
        frames = torch.from_numpy(inputs[f"{scene}_frames"])
        per = [run_chunk(init_fn(fr[0]), fr[1:])[1] for fr in frames]
        for k in per[0]._fields:
            want = np.stack([getattr(p, k).numpy() for p in per])
            np.testing.assert_allclose(_cat(two_ranks, f"{scene}_{k}"),
                                       want, atol=ROWS_TOL, err_msg=k)
    frames = inputs["road_frames"]
    mesh = jpar.make_mesh(shape=(2, 1), devices=jax.devices()[:2])
    run_batch, init_batch, shard_frames = jpar.shard_pipeline_step(
        mesh, JPipelineConfig(), (w, h))
    _, outs = run_batch(init_batch(jnp.asarray(frames[:, 0])),
                        shard_frames(frames[:, 1:]))
    assert np.asarray(outs.pts_valid).any()
    for k in outs._fields:
        want, got = np.asarray(getattr(outs, k)), _cat(two_ranks, f"road_{k}")
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _serve(ms, staging, f):
    t = 0
    while t < f:
        n = min(8 + (1 if ms.states is None else 0), f - t)
        ms.feed_staged(staging, t, n)
        t += n
    ms.drain()
    return ms


def test_mesh_sharded_serving_matches_unsharded(inputs, two_ranks):
    """MultiStreamPipeline(mesh=...) over a 2-rank 'streams' mesh, each rank
    stepping its 2 streams through feed_staged: per stream the rows equal
    the port's unsharded run's and lk_tpu's MultiStreamPipeline over a
    2-device 'streams' mesh within 1e-4 px (tests/test_parallel.py
    :125-183)."""
    from lk_tpu.models import PRESETS as JPRESETS
    from lk_tpu.pipeline.runner import MultiStreamPipeline as JMulti
    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    u8 = inputs["serving_u8"]
    f, b, h, w = u8.shape
    kw = dict(src_size=(w, h), n_streams=b, chunk=8)
    cfg = dataclasses.replace(PRESETS["final"], width=w, out_cap=48)
    ms = _serve(MultiStreamPipeline(cfg, device="cpu", **kw),
                torch.from_numpy(u8), f)
    jcfg = dataclasses.replace(JPRESETS["final"], width=w, out_cap=48)
    jms = JMulti(jcfg, mesh=Mesh(np.asarray(jax.devices()[:2]),
                                 ("streams",)), **kw)
    jms = _serve(jms, jax.device_put(u8, jms.staging_sharding), f)
    got = []
    for r, rank in enumerate(two_ranks):
        assert rank["serving"]["streams"] == [2 * r, 2 * r + 2]
        got += rank["serving"]["pipes"]
    assert len(got) == b
    assert sum(len(q.csv_rows) for q in ms.pipes) > 0
    for p, q, j in zip(got, ms.pipes, jms.pipes):
        for ref in (q, j):
            assert p["frames_done"] == ref.frames_done == f - 1
            assert len(p["csv_rows"]) == len(ref.csv_rows)
            if ref.csv_rows:
                np.testing.assert_allclose(np.array(p["csv_rows"]),
                                           np.array(ref.csv_rows),
                                           atol=ROWS_TOL)
            assert len(p["cross_points"]) == len(ref.cross_points)
            for u, v in zip(p["vp_per_frame"], ref.vp_per_frame):
                assert (u is None) == (v is None)
                if v is not None:
                    assert u == pytest.approx(v, abs=ROWS_TOL)


def test_mesh_rejects_indivisible_streams():
    """The stream count must divide over the mesh axis (lk_tpu's
    ValueError, lk_tpu/pipeline/runner.py:570-573)."""
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    class Mesh3:
        mesh_dim_names = ("streams",)

        def size(self, dim):
            return 3

    with pytest.raises(ValueError, match="not divisible"):
        MultiStreamPipeline(PipelineConfig(), src_size=(256, 144),
                            n_streams=4, device="cpu", mesh=Mesh3())


def test_sharded_pyramidal_matches_unsharded(inputs, four_ranks):
    """sharded_dense_pyramidal_lk over 4 row shards at 256x384 (levels 0-1
    on the blocks, 2-3 gathered whole): every pixel, the frame's top and
    bottom rows included, equal bit for bit to the port's unsharded
    dense_pyramidal_lk (the halos are exact copies and every operation a
    stencil in a fixed order), and within 5e-3 px of lk_tpu's GSPMD solve
    over 4 devices (tests/test_parallel.py:102-122)."""
    got = _cat(four_ranks, "auto")
    prev, nxt = inputs["auto_prev"], inputs["auto_next"]
    port = td.dense_pyramidal_lk(torch.from_numpy(prev),
                                 torch.from_numpy(nxt)).flow.numpy()
    np.testing.assert_array_equal(got, port)
    m4 = jpar.make_mesh(shape=(1, 4), devices=jax.devices()[:4])
    ref = np.asarray(jpar.sharded_dense_pyramidal_lk(m4)(
        jnp.asarray(prev), jnp.asarray(nxt)))
    np.testing.assert_allclose(got, ref, atol=PYR_TOL)
