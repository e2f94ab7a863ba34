"""The one traffic generator: the scenes every traffic mix is drawn from.

Each traffic mix under ``traffic/`` is a JSON file of parameters; this
module turns those parameters and a seed into the inputs of a run, on the
device, in a few large calls.  Nothing here imports the program under
test: the texture recipe (two blurred noise fields, normalised to 0..255)
and the affine video of ``chip_smoke.py`` are rewritten in plain PyTorch,
with the noise drawn from a ``torch.Generator`` on the device.

The seed changes the texture only.  Sizes, frame counts and motions come
from the traffic file, so every seed gives the program the same amount of
work.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (negative or
    beyond 64 bits too)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def gaussian_taps(sigma: float, device) -> torch.Tensor:
    """Normalised Gaussian taps of radius ceil(4 sigma), f32."""
    r = max(1, math.ceil(4 * sigma))
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    t = torch.exp(-x * x / (2 * sigma * sigma))
    return (t / t.sum()).to(torch.float32).to(device)


def blur(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, H, W) f32 planes, mirrored borders."""
    taps = gaussian_taps(sigma, planes.device)
    r = taps.numel() // 2
    x = planes[:, None]
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), taps.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), taps.view(1, 1, -1, 1))
    return x[:, 0]


def textures(gen: torch.Generator, n: int, h: int, w: int,
             sigmas) -> torch.Tensor:
    """(n, h, w) f32 textures: the sum of one noise field blurred at each
    sigma, each texture stretched to 0..255."""
    dev = gen.device
    tex = torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    for s in sigmas:
        noise = torch.rand((n, h, w), generator=gen, device=dev) * 255
        tex += blur(noise, float(s))
    lo = tex.amin(dim=(1, 2), keepdim=True)
    hi = tex.amax(dim=(1, 2), keepdim=True)
    return (tex - lo) / (hi - lo) * 255


def affine_matrix(motion: dict, h: int, w: int) -> np.ndarray:
    """The 2x3 map from frame t to frame t+1 of a motion entry:
    ``{"kind": "translation", "dx", "dy"}`` or ``{"kind": "zoom_rotation",
    "scale", "angle_deg"}`` about the frame centre (cv.getRotationMatrix2D)."""
    if motion["kind"] == "translation":
        return np.array([[1.0, 0.0, motion["dx"]], [0.0, 1.0, motion["dy"]]])
    if motion["kind"] == "zoom_rotation":
        t = np.deg2rad(motion["angle_deg"])
        al, be = motion["scale"] * np.cos(t), motion["scale"] * np.sin(t)
        cx, cy = w / 2.0, h / 2.0
        return np.array([[al, be, (1 - al) * cx - be * cy],
                         [-be, al, be * cx + (1 - al) * cy]])
    raise ValueError(f"unknown motion kind {motion['kind']!r}")


def affine_video(gen: torch.Generator, h: int, w: int, n: int, a: np.ndarray,
                 margin: int, sigmas) -> torch.Tensor:
    """(n, h, w) f32 frames of a textured canvas under the affine map ``a``
    (frame t+1 = frame t moved by a): frame t samples the canvas at
    a^-t(p), bilinear, mirrored at the canvas edge."""
    dev = gen.device
    canvas = textures(gen, 1, h + 2 * margin, w + 2 * margin, sigmas)
    ch, cw = canvas.shape[1:]
    inv = np.linalg.inv(np.vstack([a, [0.0, 0.0, 1.0]]))
    mats, cur = [], np.eye(3)
    for _ in range(n):
        mats.append(cur[:2])
        cur = inv @ cur
    m = torch.as_tensor(np.stack(mats), dtype=torch.float64, device=dev)
    ys = torch.arange(h, dtype=torch.float64, device=dev)
    xs = torch.arange(w, dtype=torch.float64, device=dev)
    out = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    for t in range(n):
        sx = m[t, 0, 0] * xs[None] + m[t, 0, 1] * ys[:, None] + m[t, 0, 2]
        sy = m[t, 1, 0] * xs[None] + m[t, 1, 1] * ys[:, None] + m[t, 1, 2]
        grid = torch.stack([(sx + margin) / (cw - 1) * 2 - 1,
                            (sy + margin) / (ch - 1) * 2 - 1], dim=-1)
        out[t] = F.grid_sample(canvas[None], grid[None].to(torch.float32),
                               mode="bilinear", padding_mode="reflection",
                               align_corners=True)[0, 0]
    return out


def dense_scenes(traffic: dict, height: int, width: int, seed: int,
                 device) -> list:
    """The staged clips of a dense-flow mix: one (frames, H, W) f32 clip
    per entry of ``traffic["scenes"]``, each on its own texture."""
    gen = generator(seed, device)
    tex = traffic["texture"]
    return [affine_video(gen, height, width, traffic["frames_per_clip"],
                         affine_matrix(s, height, width), tex["margin"],
                         tex["sigmas"])
            for s in traffic["scenes"]]
