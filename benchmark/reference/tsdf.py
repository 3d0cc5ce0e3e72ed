"""Plain TSDF fusion of one depth frame into a dense voxel box.

The mapping semantics the node's maps state, written out for one dense
grid with no block table, no kernel and no capacity buckets but those the
semantics fix:

- depth pixels on a stride, kept between the minimum and maximum ray
  length, unprojected with the depth intrinsics; colours read from the
  texture at the same pixel or reprojected through the colour intrinsics;
- rays binned by sensor-local voxel (ties away from zero) and sorted by bin
  id; only the first ``bucket`` bins are kept, the bucket following the
  load of the frame before as ``bucket_for`` says;
- each bin marched from the sensor along its mean direction, one voxel a
  step, out to ``internal_voxels`` behind its mean point, capped at the
  maximum ray length; a sample weighs ``1/z^2`` (the unsigned distance
  feeds the drop-off, so only that branch is live) and carries its signed
  distance to the mean point;
- the per-voxel sums of a frame taken over samples whose (weight, weighted
  distance) and, textured, the first two weighted colours are rounded to
  f16 first, at most ``max_touched_blocks`` blocks a frame (the lowest
  block ids);
- merged by the weighted average, the weight clamped at ``w_max``, the
  colour replaced by the frame's weighted mean colour.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import dot3, fma, inv, round_half_away, sign, sqrt_rn

W_MAX = 1000.0
INTERNAL_VOXELS = 10
RECAST_STEP = 2
MAX_TOUCHED_BLOCKS = 1024
MAX_BINS = 32768


def bucket_for(n: int, lo: int = 2048) -> int:
    """Smallest {1, 1.25, 1.5} * 2^k at least n * 21 / 20."""
    want = max(n * 21 // 20, 1)
    b = lo
    while True:
        for num in (4, 5, 6):
            if want <= b * num // 4:
                return b * num // 4
        b *= 2


class Spec:
    """The map's voxel index space: voxels of ``voxel`` m, centred indices
    ``[-N/2, N/2)`` (``Nz`` in z), blocks of ``V`` voxels a side."""

    def __init__(self, voxel: float, V: int, map_xy: float, map_z: float):
        self.voxel = voxel
        self.V = V
        bn_xy = max(1, math.ceil(map_xy / voxel / V))
        bn_z = max(1, math.ceil(map_z / voxel / V))
        self.N, self.Nz = bn_xy * V, bn_z * V
        self.bn_xy, self.bn_z = bn_xy, bn_z
        self.origin = (-(self.N // 2), -(self.N // 2), -(self.Nz // 2))

    def in_map(self, i, j, k):
        o = self.origin
        return ((i - o[0] >= 0) & (i - o[0] < self.N) & (j - o[1] >= 0) &
                (j - o[1] < self.N) & (k - o[2] >= 0) & (k - o[2] < self.Nz))

    def block_key(self, i, j, k):
        o, V = self.origin, self.V
        bi = torch.div(i - o[0], V, rounding_mode="floor")
        bj = torch.div(j - o[1], V, rounding_mode="floor")
        bk = torch.div(k - o[2], V, rounding_mode="floor")
        return (bi * self.bn_xy + bj) * self.bn_z + bk


class Grid:
    """A block-aligned dense box of the map's voxels: TSDF, weight,
    observed and, textured, colour, each flat over (X, Y, Z)."""

    def __init__(self, spec: Spec, lo_m, hi_m, texture: bool, dtype, device):
        V, o = spec.V, spec.origin
        lo, dims = [], []
        for a in range(3):
            i0 = math.floor(lo_m[a] / spec.voxel) - 1
            i1 = math.ceil(hi_m[a] / spec.voxel) + 2
            b0 = (i0 - o[a]) // V
            b1 = -(-(i1 - o[a]) // V)
            lo.append(o[a] + b0 * V)
            dims.append((b1 - b0) * V)
        self.spec, self.lo, self.dims = spec, lo, dims
        self.dtype, self.device = dtype, device
        n = dims[0] * dims[1] * dims[2]
        self.tsdf = torch.zeros(n, dtype=dtype, device=device)
        self.w = torch.zeros(n, dtype=dtype, device=device)
        self.obs = torch.zeros(n, dtype=torch.bool, device=device)
        self.color = (torch.zeros((3, n), dtype=dtype, device=device)
                      if texture else None)
        self.outside = 0     # samples in the map that fell outside the box

    def flat(self, i, j, k):
        X, Y, Z = self.dims
        a, b, c = i - self.lo[0], j - self.lo[1], k - self.lo[2]
        inbox = (a >= 0) & (a < X) & (b >= 0) & (b < Y) & (c >= 0) & (c < Z)
        return ((a.long() * Y + b) * Z + c), inbox

    def ijk(self):
        """(i, j, k) int32 of every voxel of the box, flat order."""
        X, Y, Z = self.dims
        dev = self.device
        ii, jj, kk = torch.meshgrid(
            torch.arange(X, device=dev, dtype=torch.int32) + self.lo[0],
            torch.arange(Y, device=dev, dtype=torch.int32) + self.lo[1],
            torch.arange(Z, device=dev, dtype=torch.int32) + self.lo[2],
            indexing="ij")
        return ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)

    def block_view(self, x):
        """``x`` (flat) as (blocks, V^3) in block order of the box."""
        X, Y, Z = self.dims
        V = self.spec.V
        return x.reshape(X // V, V, Y // V, V, Z // V, V).permute(
            0, 2, 4, 1, 3, 5).reshape(-1, V ** 3)

    def from_block_view(self, xb):
        X, Y, Z = self.dims
        V = self.spec.V
        return xb.reshape(X // V, Y // V, Z // V, V, V, V).permute(
            0, 3, 1, 4, 2, 5).reshape(-1)


class Sensor:
    """The frame constants of one map: ray lengths, stride, texture."""

    def __init__(self, voxel, max_ray, min_ray, texture, color_same_proj):
        self.voxel = voxel
        self.max_ray = max_ray
        self.min_ray = min_ray
        self.texture = texture
        self.color_same_proj = color_same_proj
        self.steps = int(math.ceil(max_ray / voxel))


def _points(sn: Sensor, depth, tex, K, Kc):
    h, w = depth.shape
    s = RECAST_STEP
    dev = depth.device
    rows = torch.arange(0, h // s, dtype=torch.int32, device=dev) * s
    cols = torch.arange(0, w // s, dtype=torch.int32, device=dev) * s
    jj, ii = torch.meshgrid(rows, cols, indexing="ij")
    jj, ii = jj.reshape(-1), ii.reshape(-1)
    d_mm = depth[:(h // s) * s:s, :(w // s) * s:s].reshape(-1).float()
    valid = (d_mm != 0) & (d_mm <= sn.max_ray * 1000.0) & (
        d_mm >= sn.min_ray * 1000.0)
    dep = d_mm * inv(1000.0)
    fx, cx, fy, cy = K[0], K[2], K[4], K[5]
    px = (ii.float() - cx) * dep / fx
    py = (jj.float() - cy) * dep / fy
    color = None
    if sn.texture:
        if sn.color_same_proj:
            color = tex[:(h // s) * s:s, :(w // s) * s:s, :].reshape(
                -1, 3).float()
        else:
            th, tw = tex.shape[0], tex.shape[1]
            i, j = ii.float(), jj.float()
            ci = fma((i - cx) / fx, Kc[0], Kc[2]).to(torch.int32)
            cj = fma((j - cy) / fy, Kc[4], Kc[5]).to(torch.int32)
            oob = (ci < 0) | (ci >= th) | (cj < 0) | (cj >= tw)
            row = torch.where(oob, 0, cj).long().clamp(0, th - 1)
            col = torch.where(oob, 0, ci).long().clamp(0, tw - 1)
            color = tex[row, col, :].float()
    return px, py, dep, dep, color, valid


def integrate(sn: Spec, grid: Grid, sensor: Sensor, depth, tex, R, T, K, Kc,
              bucket: int):
    """Fuse one frame into ``grid`` at pose (R (3, 3), T (3,)) f32 tensors
    in the grid's frame, keeping ``bucket`` bins. Returns (total bins,
    touched voxel mask (flat))."""
    dev = grid.device
    vs = sensor.voxel
    px, py, pz, z, color, valid = _points(sensor, depth, tex, K, Kc)
    m = tuple(dot3(R[a, 0], px, R[a, 1], py, R[a, 2], pz) for a in range(3))
    px, py, pz = m

    # bins
    r = int(math.ceil(sensor.max_ray / vs)) + 1
    G = 2 * r + 1
    iv = inv(vs)
    vi = round_half_away(px * iv).to(torch.int32)
    vj = round_half_away(py * iv).to(torch.int32)
    vk = round_half_away(pz * iv).to(torch.int32)
    inb = (vi.abs() <= r) & (vj.abs() <= r) & (vk.abs() <= r) & valid
    bin_id = ((vi + r) * G + (vj + r)) * G + (vk + r)
    bin_id = torch.where(inb, bin_id, torch.full_like(bin_id, G * G * G))
    bid, perm = torch.sort(bin_id, stable=True)
    ok = bid < G * G * G
    head = ok & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           bid[1:] != bid[:-1]])
    rank = torch.cumsum(head.to(torch.int64), 0) - 1
    total = int(head.sum())
    B = bucket
    keep = ok & (rank < B)
    vals = [ok.float(), px[perm], py[perm], pz[perm], z[perm]]
    if sensor.texture:
        c = color[perm]
        vals += [c[:, 0], c[:, 1], c[:, 2]]
    acc = torch.zeros((len(vals), B), device=dev)
    idx = rank[keep]
    for a, v in enumerate(vals):
        acc[a].index_add_(0, idx, v[keep])
    count = acc[0]
    bvalid = count > 0

    # march
    S = sensor.steps
    cnt = torch.clamp(count, min=1.0)
    p0, p1, p2 = acc[1] / cnt, acc[2] / cnt, acc[3] / cnt
    length = sqrt_rn(dot3(p0, p0, p1, p1, p2, p2))
    inv_len = 1.0 / torch.clamp(length, min=1e-12)
    d0, d1, d2 = p0 * inv_len, p1 * inv_len, p2 * inv_len
    e0, e1, e2 = p0 + T[0], p1 + T[1], p2 + T[2]
    zb = acc[4] / cnt
    n_steps = torch.floor(torch.clamp(
        fma(length, torch.full_like(length, inv(vs)),
            torch.full_like(length, float(INTERNAL_VOXELS))),
        max=sensor.max_ray / vs)).to(torch.int32)
    step = (torch.arange(S, dtype=torch.float32, device=dev) + 1.0) * vs
    x0 = fma(d0[None, :], step[:, None], T[0])
    x1 = fma(d1[None, :], step[:, None], T[1])
    x2 = fma(d2[None, :], step[:, None], T[2])
    live = (torch.arange(S, device=dev)[:, None] < n_steps[None, :]) & \
        bvalid[None, :]
    v0, v1, v2 = e0[None, :] - x0, e1[None, :] - x1, e2[None, :] - x2
    dist = sqrt_rn(dot3(v0, v0, v1, v1, v2, v2))
    dsign = dist * sign(dot3(v0, p0[None, :], v1, p1[None, :], v2,
                             p2[None, :]))
    inv_z2 = 1.0 / (zb * zb)
    theta = vs * 4.0
    ramp = (dist + theta) * inv_z2[None, :] * inv(theta - vs)
    wgt = torch.where(dist > -vs, inv_z2[None, :],
                      torch.where(dist > -theta, ramp, 0.0))
    wgt = torch.where(live, wgt, 0.0)

    inv_v = 1.0 / vs
    ii, jj, kk = (round_half_away(x * inv_v).to(torch.int32)
                  for x in (x0, x1, x2))
    lane = (live & sn.in_map(ii, jj, kk)).reshape(-1)
    ii, jj, kk = ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)
    # at most MAX_TOUCHED_BLOCKS blocks a frame: the lowest block ids
    bkey = sn.block_key(ii, jj, kk)
    ub = torch.unique(bkey[lane])
    if ub.numel() > MAX_TOUCHED_BLOCKS:
        lane &= bkey <= ub[MAX_TOUCHED_BLOCKS - 1]
    wf = torch.where(lane, wgt.reshape(-1), 0.0)
    lvals = [wf, wf * dsign.reshape(-1)]
    if sensor.texture:
        rgb = acc[5:8] / cnt[None, :] * inv(255.0)          # (3, B)
        for a in range(3):
            lvals.append(wf * torch.where(
                lane, rgb[a][None, :].expand(live.shape).reshape(-1), 0.0))
    n_pair = len(lvals) // 2 * 2
    lvals = [v.half().float() for v in lvals[:n_pair]] + lvals[n_pair:]

    flat, inbox = grid.flat(ii, jj, kk)
    grid.outside += int((lane & ~inbox).sum())
    sel = lane & inbox
    fi = flat[sel]
    n = grid.tsdf.numel()
    sums = torch.zeros((len(lvals), n), device=dev)
    for a, v in enumerate(lvals):
        sums[a].index_add_(0, fi, v[sel])
    w_sum, wd_sum = sums[0], sums[1]
    touched = w_sum > 0
    D = grid.tsdf.float()
    W = grid.w.float()
    grid.tsdf.copy_(torch.where(touched, fma(D, W, wd_sum) / (W + w_sum),
                                D).to(grid.dtype))
    grid.w.copy_(torch.where(touched, torch.clamp(W + w_sum, max=W_MAX),
                             W).to(grid.dtype))
    grid.obs |= touched
    if sensor.texture:
        den = torch.clamp(w_sum, min=1e-20)
        grid.color.copy_(torch.where(touched[None, :], sums[2:5] / den,
                                     grid.color.float()).to(grid.dtype))
    return total, touched
