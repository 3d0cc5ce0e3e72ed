"""The office room of the port's synthetic scene, rendered on the device.

A PyTorch rewrite of ``utils/synthetic_scene.py`` (walls at +-2.5 m in x
and y, floor and ceiling at z = -1.5 and 1.5, four furniture boxes) that
the benchmark owns, so that a change to the port cannot move its inputs.
The camera orbits the room's centre looking outward (radius, period, frame
rate and the number of distinct frames come from the traffic mix); depth is
pinhole z-depth in uint16 millimetres with Gaussian noise on every return,
and a texture colours each surface with a seeded palette and stripes.

The seed sets the noise, the orbit's starting phase and the palette; every
seed renders the same number of frames of the same size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROOM = 2.5
Z_RANGE = (-1.5, 1.5)
BOXES = (
    ((1.4, 0.8, -0.8), (0.4, 0.4, 0.7)),     # crate
    ((-1.2, -1.0, -1.0), (0.6, 0.4, 0.5)),   # desk
    ((-0.2, 1.5, -0.6), (0.3, 0.3, 0.9)),    # shelf
    ((0.6, -1.6, -1.1), (0.5, 0.3, 0.4)),    # bench
)
N_SURF = 6 + len(BOXES)

# the bounds every ray ends inside, in metres (what a reference grid holds)
BOUNDS_LO = (-ROOM, -ROOM, Z_RANGE[0])
BOUNDS_HI = (ROOM, ROOM, Z_RANGE[1])


def orbit_poses(n: int, radius: float, phase: float):
    """(Rs (n, 3, 3), Ts (n, 3)) float64: the camera at angle
    ``phase + 2 pi t / n`` on a circle of ``radius``, bobbing 0.1 m at
    twice the rate, its +z (view) axis pointing outward."""
    cam_axes = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], float).T
    Rs = np.empty((n, 3, 3))
    Ts = np.empty((n, 3))
    for t in range(n):
        th = phase + 2 * np.pi * t / n
        Rz = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        Rs[t] = Rz @ cam_axes
        Ts[t] = (radius * np.cos(th), radius * np.sin(th),
                 0.1 * np.sin(2 * th))
    return Rs, Ts


def _hits(dirs_w, T):
    """Nearest hit distance (P,) and surface id (P,) of rays ``dirs_w``
    (P, 3) from ``T`` (3,) against the walls and the boxes (f32)."""
    P = dirs_w.shape[0]
    dev = dirs_w.device
    lo = torch.tensor([-ROOM, -ROOM, Z_RANGE[0]], device=dev)
    hi = torch.tensor([ROOM, ROOM, Z_RANGE[1]], device=dev)
    best = torch.full((P,), math.inf, device=dev)
    sid = torch.full((P,), -1, dtype=torch.int64, device=dev)
    s = 0
    for axis in range(3):
        for bound in (lo[axis], hi[axis]):
            t = (bound - T[axis]) / dirs_w[:, axis]
            ok = (t > 0.05) & torch.isfinite(t)
            p = T + dirs_w * t[:, None]
            for o in range(3):
                if o != axis:
                    ok &= (p[:, o] >= lo[o] - 1e-6) & (p[:, o] <= hi[o] + 1e-6)
            t = torch.where(ok, t, math.inf)
            better = t < best
            best = torch.where(better, t, best)
            sid = torch.where(better, s, sid)
            s += 1
    inv = 1.0 / dirs_w
    for c, half in BOXES:
        c = torch.tensor(c, dtype=torch.float32, device=dev)
        half = torch.tensor(half, dtype=torch.float32, device=dev)
        t1 = (c - half - T) * inv
        t2 = (c + half - T) * inv
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = (tmax >= torch.clamp(tmin, min=0.05)) & torch.isfinite(tmin)
        t = torch.where(hit, torch.clamp(tmin, min=0.05), math.inf)
        better = t < best
        best = torch.where(better, t, best)
        sid = torch.where(better, s, sid)
        s += 1
    return best, sid


def render(traffic: dict, K: np.ndarray, seed: int, device,
           with_texture: bool, batch: int = 10):
    """Render the traffic mix's distinct frames. Returns a dict with
    ``depth`` (n, h, w) uint16 and, with ``with_texture``, ``texture``
    (n, h, w, 3) uint8, both on the host, and the poses ``Rs``, ``Ts``
    (float64). Everything random comes from one ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    n = int(traffic["distinct_frames"])
    h, w = traffic["height"], traffic["width"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand((2 + 3 * N_SURF,), generator=gen, device=device).cpu()
    phase = float(u[0]) * 2 * math.pi
    Rs, Ts = orbit_poses(n, traffic["orbit_radius_m"], phase)
    palette = (40 + 200 * u[2:2 + 3 * N_SURF].reshape(N_SURF, 3)).to(device)
    stripe = 2 * math.pi / (0.15 + 0.3 * float(u[1]))
    K = np.asarray(K, np.float32)
    fx, cx, fy, cy = (float(K[i]) for i in (0, 2, 4, 5))
    jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    dirs = torch.stack([(ii - cx) / fx, (jj - cy) / fy,
                        torch.ones_like(ii)], -1).reshape(-1, 3)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    depth = np.empty((n, h, w), np.uint16)
    tex = np.empty((n, h, w, 3), np.uint8) if with_texture else None
    noise_mm = float(traffic["depth_noise_mm"])
    for f0 in range(0, n, batch):
        fs = range(f0, min(n, f0 + batch))
        d_out, t_out = [], []
        for f in fs:
            R = torch.tensor(Rs[f], dtype=torch.float32, device=device)
            T = torch.tensor(Ts[f], dtype=torch.float32, device=device)
            dw = dirs @ R.T
            t, sid = _hits(dw, T)
            z = t * dirs[:, 2]
            mm = torch.where(torch.isfinite(z), z * 1000.0, 0.0)
            mm = mm + torch.where(mm > 0, noise_mm * torch.randn(
                mm.shape, generator=gen, device=device), 0.0)
            d_out.append(torch.clamp(mm, 0, 65535).to(torch.int32)
                         .reshape(h, w))
            if with_texture:
                p = T + dw * torch.where(torch.isfinite(t), t, 0.0)[:, None]
                band = 0.75 + 0.25 * torch.sin(stripe * (p[:, 0] + p[:, 1]) +
                                               2.0 * p[:, 2])
                col = palette[sid.clamp(min=0)] * band[:, None]
                col = torch.where((sid >= 0)[:, None], col, 0.0)
                t_out.append(col.clamp(0, 255).to(torch.uint8)
                             .reshape(h, w, 3))
        depth[fs.start:fs.stop] = torch.stack(d_out).cpu().numpy() \
            .astype(np.uint16)
        if with_texture:
            tex[fs.start:fs.stop] = torch.stack(t_out).cpu().numpy()
    return {"depth": depth, "texture": tex, "Rs": Rs, "Ts": Ts}
