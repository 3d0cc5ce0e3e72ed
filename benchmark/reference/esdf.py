"""The ESDF the node's map converges to, and the snapshot it is taken from.

The distance field is defined over the voxels of the ESDF's snapshot: a
block's snapshot of TSDF and observed flags is refreshed when the frame
touched the block and some voxel of it moved more than a quarter voxel (or
flipped its observed flag). Over the observed voxels of the snapshot:

- voxels with ``|tsdf| < voxel`` are fixed at their TSDF;
- a free voxel (``tsdf >= voxel``) takes the least of ``e_n + |n|`` over
  its 26 neighbours ``n`` that are fixed or free (``|n|`` = 1, sqrt 2 or
  sqrt 3 voxels), at most the maximum ray length;
- an occupied voxel (``tsdf <= -voxel``) takes the greatest of ``e_n -
  |n|`` over its neighbours that are fixed or occupied, at least minus the
  maximum ray length;
- every other voxel is 0.

``fixed_point`` relaxes these equations from +-max_ray until nothing moves,
which is their one solution: the shortest-path distance to the fixed band
over the 26-neighbour graph.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

BIG = 1e9
SEED_EPS_VOXELS = 0.25


def refresh_snapshot(grid, seen_tsdf, seen_obs, touched):
    """Refresh the snapshot's blocks that the frame touched and that moved
    (in place). ``touched``: the frame's touched voxels (flat)."""
    eps = float(np.float32(SEED_EPS_VOXELS * grid.spec.voxel))
    tb = grid.block_view(touched).any(dim=1)
    t = grid.block_view(grid.tsdf.float())
    o = grid.block_view(grid.obs)
    st = grid.block_view(seen_tsdf)
    so = grid.block_view(seen_obs)
    moved = (((t - st).abs() > eps) | (o != so)).any(dim=1) & tb
    st = torch.where(moved[:, None], t, st)
    so = torch.where(moved[:, None], o, so)
    seen_tsdf.copy_(grid.from_block_view(st))
    seen_obs.copy_(grid.from_block_view(so))


def _neighbour_extrema(x, op, fill):
    """Per voxel, ``op`` over its face, edge and corner neighbours of the
    3-D grid ``x`` (cells outside hold ``fill``)."""
    X, Y, Z = x.shape
    p = torch.full((X + 2, Y + 2, Z + 2), fill, dtype=x.dtype,
                   device=x.device)
    p[1:-1, 1:-1, 1:-1] = x
    out = [None, None, None]
    for d in itertools.product((-1, 0, 1), repeat=3):
        n = abs(d[0]) + abs(d[1]) + abs(d[2])
        if n == 0:
            continue
        v = p[1 + d[0]:1 + d[0] + X, 1 + d[1]:1 + d[1] + Y,
              1 + d[2]:1 + d[2] + Z]
        out[n - 1] = v if out[n - 1] is None else op(out[n - 1], v)
    return out


def fixed_point(grid, tsdf, participate, voxel: float, max_ray: float,
                max_iters: int = 4000):
    """The ESDF of the equations above on ``grid``'s box, from the flat
    ``tsdf`` and ``participate`` (flat f32)."""
    shape = tuple(grid.dims)
    f32 = np.float32
    gamma = float(f32(voxel))
    v = (gamma, float(f32(np.sqrt(2.0) * voxel)),
         float(f32(np.sqrt(3.0) * voxel)))
    mr = float(f32(max_ray))
    t = tsdf.reshape(shape)
    part = participate.reshape(shape)
    fixed = part & (t.abs() < gamma)
    pos_src = part & (fixed | (t >= gamma))
    neg_src = part & (fixed | (t <= -gamma))
    pos = part & ~fixed & (t >= 0)
    neg = part & ~fixed & (t < 0)
    e = torch.where(fixed, t, torch.where(pos, mr, torch.where(neg, -mr,
                                                               0.0)))
    for _ in range(max_iters):
        lo = torch.where(pos_src, e, BIG)
        hi = torch.where(neg_src, e, -BIG)
        fl = _neighbour_extrema(lo, torch.minimum, BIG)
        fh = _neighbour_extrema(hi, torch.maximum, -BIG)
        cand_lo = torch.minimum(torch.minimum(fl[0] + v[0], fl[1] + v[1]),
                                fl[2] + v[2])
        cand_hi = torch.maximum(torch.maximum(fh[0] - v[0], fh[1] - v[1]),
                                fh[2] - v[2])
        new = torch.where(pos, torch.minimum(e, cand_lo), e)
        new = torch.where(neg, torch.maximum(new, cand_hi), new)
        if torch.equal(new, e):
            break
        e = new
    return e.reshape(-1)
