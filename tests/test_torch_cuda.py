"""The CUDA kernel against its plain PyTorch version, on the card.

Skips without a CUDA device.  The machine with the card has no JAX and no
OpenCV, so this file imports neither and needs none of tests/conftest.py;
run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from lk_tpu_torch.flow import lk_kernels as lk

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["resident", "tiled_iters", "coarse",
                                  "coarse_nostats"])
def test_kernel_matches_plain(cuda_device, case):
    """Both sides are f32 with the same operation order (the kernel is built
    without FMA contraction; the plain version divides like it), so they
    agree to 1e-4 px and flip no valid flag; K=3 pairs equal single-pair
    calls bit for bit."""
    h, w = 128, 512
    frames = _frames(4, h, w, cuda_device)
    rng = np.random.default_rng(1)
    kw = dict(max_disp=8, local=5, min_eig_threshold=THR)
    if case == "resident":
        flow = torch.zeros((3, 2, h, w), device=cuda_device)
        kw.update(tile_h=h, tile_w=w, n_iters=4)
    elif case == "tiled_iters":
        flow = torch.from_numpy(((rng.random((3, 2, h, w)) - 0.5) * 2.0)
                                .astype(np.float32)).to(cuda_device)
        kw.update(tile_h=64, tile_w=256, n_iters=3)
    else:
        flow = torch.from_numpy(((rng.random((3, 2, h // 2, w // 2)) - 0.5)
                                 * 2.0).astype(np.float32)).to(cuda_device)
        kw.update(tile_h=64, tile_w=256, coarse_in=True,
                  write_stats=case == "coarse")
    lk.reset_counters()
    fk, mk, vk = lk.fused_lk_level(frames[:-1], frames[1:], flow, **kw)
    assert sum(lk.kernel_launches_by_variant.values()) == kw.get("n_iters",
                                                               1)
    assert lk.plain_calls == 0
    fp, mp, vp = lk.fused_lk_level_reference(frames[:-1], frames[1:], flow,
                                             **kw)
    torch.cuda.synchronize()
    assert float((fk - fp).abs().max()) < 1e-4
    if mk is not None:
        assert float((mk - mp).abs().max() / mp.abs().max()) < 1e-5
        assert torch.equal(vk, vp)
    else:
        assert mp is None and vk is None
    for f in range(3):
        one = lk.fused_lk_level(frames[f:f + 1], frames[f + 1:f + 2],
                                flow[f:f + 1], **kw)
        assert torch.equal(fk[f], one[0][0])


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
