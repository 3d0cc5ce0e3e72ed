"""Synthetic D435-like scene and orbit sequence (numpy only).

The same generator as the JAX package's ``utils/synthetic_scene.py``: an
office-like room (walls + boxes) rendered to metric uint16 depth with
D435-ish intrinsics along an orbit trajectory. It lives here too because
this package must not import the JAX one; a test holds the two equal.
"""

from __future__ import annotations

import numpy as np

# D435-ish depth intrinsics at 640x480 (the reference launch defaults,
# taichislam_node.py Kdepth fx/fy ~384, cx ~323, cy ~235)
D435_K = np.array([384.2377, 0.0, 323.4873,
                   0.0, 384.2377, 235.0628,
                   0.0, 0.0, 1.0], np.float32)
D435_RES = (480, 640)


def office_boxes():
    """Axis-aligned furniture boxes: (center (3,), half-extent (3,))."""
    return [
        (np.array([1.4, 0.8, -0.8]), np.array([0.4, 0.4, 0.7])),   # crate
        (np.array([-1.2, -1.0, -1.0]), np.array([0.6, 0.4, 0.5])),  # desk
        (np.array([-0.2, 1.5, -0.6]), np.array([0.3, 0.3, 0.9])),  # shelf
        (np.array([0.6, -1.6, -1.1]), np.array([0.5, 0.3, 0.4])),  # bench
    ]


def render_depth(R, T, K, h, w, room=2.5, boxes=None, z_range=(-1.5, 1.5)):
    """Depth image of a room (walls at ±room in x/y, floor/ceiling at
    z_range) containing axis-aligned boxes. Camera looks along +z of its
    frame; output is pinhole z-depth in uint16 millimeters (0 = no return).
    """
    if boxes is None:
        boxes = office_boxes()
    fx, cx, fy, cy = K[0], K[2], K[4], K[5]
    jj, ii = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    # f32 throughout: plane/slab tests at 307k pixels in f64 dominated the
    # bench's host setup; f32 keeps depth well inside the u16-mm rounding
    dirs = np.stack([(ii - cx) / fx, (jj - cy) / fy,
                     np.ones_like(ii, np.float32)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dw = dirs @ np.asarray(R, np.float32).T
    T = np.asarray(T, np.float32)

    lo = np.array([-room, -room, z_range[0]], np.float32)
    hi = np.array([room, room, z_range[1]], np.float32)
    t_best = np.full((h, w), np.inf, np.float32)

    # room walls: nearest plane hit whose point lies on the wall rectangle
    for axis in range(3):
        for bound in (lo[axis], hi[axis]):
            denom = dw[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (bound - T[axis]) / denom
            ok = (t > 0.05) & np.isfinite(t)
            p = T + dw * t[..., None]
            others = [a for a in range(3) if a != axis]
            inside = np.ones_like(ok)
            for o in others:
                inside &= (p[..., o] >= lo[o] - 1e-6) & \
                          (p[..., o] <= hi[o] + 1e-6)
            t_best = np.minimum(t_best, np.where(ok & inside, t, np.inf))

    # boxes: slab-method ray/AABB (vectorized over pixels per box)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (1.0 / dw).astype(np.float32)
    for c, half in boxes:
        blo = (c - half).astype(np.float32)
        bhi = (c + half).astype(np.float32)
        t1 = (blo - T) * inv
        t2 = (bhi - T) * inv
        tmin = np.max(np.minimum(t1, t2), axis=-1)
        tmax = np.min(np.maximum(t1, t2), axis=-1)
        hit = (tmax >= np.maximum(tmin, 0.05)) & np.isfinite(tmin)
        t_best = np.minimum(t_best, np.where(hit, np.maximum(tmin, 0.05),
                                             np.inf))

    depth_z = t_best * dirs[..., 2]
    mm = np.where(np.isfinite(depth_z), depth_z * 1000.0, 0.0)
    return np.clip(mm, 0, 65535).astype(np.uint16)


def orbit_sequence(n_frames=40, h=None, w=None, K=None, radius=0.8,
                   room=2.5, seed=0, noise_mm=3.0):
    """D435-like recorded sequence: the camera orbits the room center,
    always looking outward. Returns (depth (n,h,w) u16, Rs (n,3,3),
    Ts (n,3), K (9,))."""
    if K is None:
        K = D435_K
    if h is None:
        h, w = D435_RES
    rng = np.random.default_rng(seed)
    depth = np.empty((n_frames, h, w), np.uint16)
    Rs = np.empty((n_frames, 3, 3), np.float32)
    Ts = np.empty((n_frames, 3), np.float32)
    # camera frame: +z = view direction, +x right, +y down
    cam_axes = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], float).T
    for t in range(n_frames):
        th = 2 * np.pi * t / n_frames
        Rz = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        R = (Rz @ cam_axes).astype(np.float32)
        T = np.array([radius * np.cos(th), radius * np.sin(th),
                      0.1 * np.sin(2 * th)], np.float32)
        d = render_depth(R, T, K, h, w, room=room).astype(np.float32)
        noise = noise_mm * rng.standard_normal(d.shape, dtype=np.float32)
        d += np.where(d > 0, noise, np.float32(0.0))
        depth[t] = np.clip(d, 0, 65535).astype(np.uint16)
        Rs[t], Ts[t] = R, T
    return depth, Rs, Ts, np.asarray(K, np.float32)
