"""Independent numpy model of the reference's TSDF fusion math.

A copy of the repository's ``tests/reference_math.py`` (``RefTSDF`` and its
helpers) and of ``mask_boundary_pixels`` from ``tests/test_tsdf.py``, kept
in the port because the port imports nothing of the JAX side; a test holds
the copies equal to their sources. ``RefTSDF`` re-derives, step by step,
the reference's sequential voxblox update (binning by sensor-local voxel,
one ray march per bin, weighted-average TSDF updates) over a dict of voxel
tuples, accumulating in f32.
"""

from __future__ import annotations

import numpy as np


def round_half_away(x):
    return np.trunc(x + np.where(x >= 0, 0.5, -0.5)).astype(np.int64)


def sign(v):
    return (0 < v) - (v < 0)


def w_x_p(d, z, voxel):
    epi = voxel
    theta = voxel * 4
    if d > -epi:
        return 1.0 / (z * z)
    if d > -theta:
        return (d + theta) / (z * z * (theta - epi))
    return 0.0


class RefTSDF:
    """Sequential-reference TSDF map over a dict of voxel tuples."""

    def __init__(self, voxel=0.1, max_ray=2.0, min_ray=0.3, internal=10,
                 w_max=1000.0, recast_step=2):
        self.voxel = voxel
        self.max_ray = max_ray
        self.min_ray = min_ray
        self.internal = internal
        self.w_max = w_max
        self.step = recast_step
        self.D = {}
        self.W = {}
        self.obs = set()
        self.occ = set()

    def _bins_from_depth(self, depth_mm, K, R):
        fx, cx, fy, cy = K[0], K[2], K[4], K[5]
        h, w = depth_mm.shape
        bins = {}
        for jj in range(h // self.step):
            j = jj * self.step
            for ii in range(w // self.step):
                i = ii * self.step
                mm = depth_mm[j, i]
                if mm == 0 or mm > self.max_ray * 1000 or mm < self.min_ray * 1000:
                    continue
                dep = np.float32(mm) / 1000.0
                pt = np.array([(i - cx) * dep / fx, (j - cy) * dep / fy, dep],
                              np.float32)
                pt_map = (R @ pt).astype(np.float32)
                key = tuple(round_half_away(pt_map / self.voxel))
                c, sp, sz = bins.get(key, (0, np.zeros(3, np.float32),
                                           np.float32(0.0)))
                bins[key] = (c + 1, sp + pt_map, np.float32(sz + dep))
        return bins

    def integrate_depth(self, depth_mm, K, R, T):
        T = np.asarray(T, np.float32)
        bins = self._bins_from_depth(depth_mm, K, R)
        voxel32 = np.float32(self.voxel)
        for _, (c, sp, sz) in bins.items():
            pos_s2p = (sp / np.float32(c)).astype(np.float32)
            length = np.float32(np.sqrt(np.sum(pos_s2p * pos_s2p)))
            d_s2p = pos_s2p / length
            pos_p = pos_s2p + T
            z = np.float32(sz) / np.float32(c)
            self.occ.add(tuple(round_half_away(pos_p / self.voxel)))
            n_steps = int(np.minimum(length / voxel32 + np.float32(self.internal),
                                     np.float32(self.max_ray) / voxel32))
            for j in range(n_steps):
                dist = np.float32(j + 1) * voxel32
                x = d_s2p * dist + T
                xi = tuple(round_half_away(x / self.voxel))
                v2p = pos_p - x
                d_x_p = float(np.linalg.norm(v2p))
                ds = d_x_p * sign(float(np.dot(v2p, pos_s2p)))
                w = w_x_p(d_x_p, z, self.voxel)  # unsigned-dist quirk
                D0 = self.D.get(xi, 0.0)
                W0 = self.W.get(xi, 0.0)
                self.D[xi] = (D0 * W0 + w * ds) / (W0 + w)
                self.W[xi] = min(W0 + w, self.w_max)
                self.obs.add(xi)


def mask_boundary_pixels(depth, K, R, voxel=0.1, margin=2e-3):
    """Zero out pixels whose binned voxel coordinate sits within ``margin``
    of a rounding boundary: XLA's FMA fusion vs numpy produces last-bit
    differences that would flip bin membership there, which is fp noise, not
    semantics. With these pixels removed, bin membership must match exactly.
    """
    h, w = depth.shape
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dep = depth.astype(np.float32) / 1000.0
    fx, cx, fy, cy = K[0], K[2], K[4], K[5]
    pt = np.stack([(ii - cx) * dep / fx, (jj - cy) * dep / fy, dep], -1)
    pt_map = pt @ np.asarray(R, np.float32).T
    frac = np.abs((pt_map / voxel) - np.floor(pt_map / voxel) - 0.5)
    bad = np.any(frac < margin, axis=-1)
    out = depth.copy()
    out[bad] = 0
    return out
