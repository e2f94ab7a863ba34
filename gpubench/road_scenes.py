"""Forward-driving dashcam scenes for the VP serving mix, rendered on the
device from a seed.

A scene is the view ahead while the car drives forward: everything streams
radially away from a vanishing point (VP) at ``zoom`` - 1 of its distance
per frame.  The zoom is the traffic's ``drive`` (``drive_zoom``): the rate
at which the road grows in a dashcam's image where it enters the ROI, for a
car at a stated speed filmed at a stated frame rate, by a camera of stated
height and focal length.  To keep textured, trackable content at every frame of a trip
of any length, the texture lives in log-polar coordinates around the VP:
frame t samples it at (ln r - t ln zoom, angle) for a pixel at distance r
and angle from the VP, and the texture repeats along ln r.  A point at
radius r in frame t is at radius r * zoom in frame t + 1 (the same texture
coordinate), and new content keeps emerging from the VP.  Features grow
with their distance from the VP, as the road does towards the car.

The texture is one noise field per stream blurred at each sigma (in texels,
wrapping on both axes) and stretched to 0..255; frames are its bilinear
samples, rounded to u8, as a dashcam's decoded gray frames would be staged.
Towards the bottom of the frame the texture's contrast fades (``fade``: full
above ``top`` x H, falling geometrically to ``floor`` at ``bottom`` x H, as
the road near the car shows little texture), so the points the tracker
follows down the road weaken until the min-eigenvalue gate drops them.
Stream s plants its VP at ((0.45 + 0.01 (s % 5)) W, 0.45 H), as
``apps/serve.py`` plants the synthetic streams'.  The seed changes the
texture only: every seed gives the program the same amount of work.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

from gpubench.scenes import gaussian_taps, generator

BLOCK = 16            # frames rendered per call (bounds the temporaries)


def planted_vp(stream: int, width: int, height: int) -> tuple:
    """The VP (x, y) of stream ``stream``."""
    return (width * (0.45 + 0.01 * (stream % 5)), height * 0.45)


def drive_zoom(drive: dict, height: int, width: int) -> float:
    """The per-frame zoom about the VP of a flat road seen from a car
    driving at ``speed_kmh``, filmed at ``fps`` by a camera
    ``camera_height_m`` above the road whose focal length is ``focal_px``
    at an image ``focal_width_px`` wide (scaled to ``width``), at the
    image row ``road_row`` x ``height``.  A road point at that row is
    Z = f h / d ahead of the camera, d its rows below the horizon (the
    planted VP's row); one frame later it is v / fps closer, and its
    image, like every point's at that depth, lies Z / (Z - v / fps) times
    as far from the VP."""
    f = drive["focal_px"] * width / drive["focal_width_px"]
    d = (drive["road_row"] - planted_vp(0, width, height)[1] / height) \
        * height
    z = f * drive["camera_height_m"] / d
    step = drive["speed_kmh"] / 3.6 / drive["fps"]
    return z / (z - step)


def _wrap_blur(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, U, A) planes that wraps on both
    axes, the taps summed in order (no convolution library: the same
    bits on every run)."""
    taps = gaussian_taps(sigma, "cpu").tolist()
    r = len(taps) // 2
    for dim in (1, 2):
        out = torch.zeros_like(planes)
        for k, t in enumerate(taps):
            out += torch.roll(planes, r - k, dims=dim) * t
        planes = out
    return planes


def textures(gen: torch.Generator, n: int, size_u: int, size_a: int,
             sigmas) -> torch.Tensor:
    """(n, size_u, size_a) f32 log-polar textures, each 0..255."""
    dev = gen.device
    tex = torch.zeros((n, size_u, size_a), dtype=torch.float32, device=dev)
    for s in sigmas:
        noise = torch.rand((n, size_u, size_a), generator=gen, device=dev)
        tex += _wrap_blur(noise * 255, float(s))
    lo = tex.amin(dim=(1, 2), keepdim=True)
    hi = tex.amax(dim=(1, 2), keepdim=True)
    return (tex - lo) / (hi - lo) * 255


class RoadScenes:
    """The ``streams`` scenes of one traffic mix at (height, width).

    ``frames(t0, n)`` renders frames t0 .. t0+n-1 of every scene as a
    time-major (n, streams, H, W) u8 tensor on the device."""

    def __init__(self, traffic: dict, height: int, width: int, seed: int,
                 device):
        sc = traffic["scenes"]
        self.streams = traffic["streams"]
        self.height, self.width = height, width
        self.device = torch.device(device)
        self.size_a = sc["texels_around"]
        self.size_u = sc["texels_along"]
        # one texel is as long along ln r as around the circle
        self.du = 2 * math.pi / self.size_a
        self.zoom = drive_zoom(sc["drive"], height, width)
        self.shift = math.log(self.zoom) / self.du    # texels per frame
        self.tex = textures(generator(seed, self.device), self.streams,
                            self.size_u, self.size_a, sc["sigmas"])
        ys = torch.arange(height, dtype=torch.float64, device=self.device)
        xs = torch.arange(width, dtype=torch.float64, device=self.device)
        u, a = [], []
        for s in range(self.streams):
            vx, vy = planted_vp(s, width, height)
            dx, dy = xs[None, :] - vx, ys[:, None] - vy
            r = torch.sqrt(dx * dx + dy * dy).clamp(min=1.0)
            u.append(torch.log(r) / self.du)
            a.append(torch.remainder(torch.atan2(dy, dx) / (2 * math.pi), 1.0)
                     * self.size_a)
        # per stream and pixel: texture coordinates at frame 0, f64
        self.u0 = torch.stack(u)
        self.a0 = torch.stack(a)
        fd = sc["fade"]
        y0, y1 = fd["top"] * height, fd["bottom"] * height
        k = ((ys - y0) / (y1 - y0)).clamp(0, 1)
        floor = torch.tensor(fd["floor"], dtype=torch.float64,
                             device=self.device)
        self.contrast = torch.pow(floor, k).to(torch.float32)[:, None]

    def _render(self, s: int, t0: int, n: int) -> torch.Tensor:
        """(n, H, W) u8 frames t0 .. t0+n-1 of stream s."""
        ts = torch.arange(t0, t0 + n, dtype=torch.float64,
                          device=self.device)
        u = self.u0[s][None] - ts[:, None, None] * self.shift
        iu = torch.floor(u)
        fu = (u - iu).to(torch.float32)
        ia = torch.floor(self.a0[s])
        fa = (self.a0[s] - ia).to(torch.float32)
        nu, na = self.size_u, self.size_a
        u0 = torch.remainder(iu.to(torch.int64), nu)
        u1 = torch.remainder(u0 + 1, nu)
        a0 = torch.remainder(ia.to(torch.int64), na)[None]
        a1 = torch.remainder(a0 + 1, na)
        flat = self.tex[s].reshape(-1)

        def at(uu, aa):
            return flat[uu * na + aa]

        v = ((1 - fu) * ((1 - fa) * at(u0, a0) + fa * at(u0, a1))
             + fu * ((1 - fa) * at(u1, a0) + fa * at(u1, a1)))
        v = 127.5 + (v - 127.5) * self.contrast
        return torch.round(v).clamp(0, 255).to(torch.uint8)

    def frames(self, t0: int, n: int) -> torch.Tensor:
        """Time-major (n, streams, H, W) u8 frames t0 .. t0+n-1."""
        out = torch.empty((n, self.streams, self.height, self.width),
                          dtype=torch.uint8, device=self.device)
        for s in range(self.streams):
            for b in range(0, n, BLOCK):
                k = min(BLOCK, n - b)
                out[b:b + k, s] = self._render(s, t0 + b, k)
        return out
