"""Decide ``correct``: the program's map and published clouds against the
reference's, by the numbers a cell's ``checks/<cell>.json`` limits.

Every number is a gap between the program and the reference over the union
of the voxels either side holds, so a voxel that one side lacks counts:

- ``*tsdf_gap``: mean |TSDF difference| (m); a voxel observed on one side
  only counts one voxel size;
- ``*weight_gap``: sum of |weight difference| (a lone voxel: its weight)
  over the reference's total weight;
- ``color_gap``: mean |colour difference| over voxels both observed;
- ``esdf_gap``, ``esdf_gap_p90``: the mean and the 90th percentile of
  |ESDF difference| (m) over the voxels either side's field covers, a lone
  voxel against 0. The mean sees a fault in any share of the field; the
  percentile, beside it, a fault in most of it that a few large gaps
  elsewhere would not hide;
- ``surface_gap``: (points on one side only + the sum of the matched
  points' mean |colour difference|) over the reference's points;
- ``slice_gap``, ``slice_gap_p90``: the mean and the 90th percentile over
  the points of both of |ESDF difference| (m), one voxel size for a point
  on one side only;
  each of the clouds' numbers the worst of the frames compared.

The program's state is read, never changed; the reference gets nothing of
it.
"""

from __future__ import annotations

import numpy as np
import torch


class Voxels:
    """Sparse voxels: int64 keys (sorted) and value rows in key order."""

    def __init__(self, keys, **vals):
        order = torch.argsort(keys)
        self.keys = keys[order]
        self.vals = {k: v[order] for k, v in vals.items()}


def voxel_key(spec, ijk, sub=None):
    o = spec.origin
    k = ((ijk[:, 0].long() - o[0]) * spec.N + (ijk[:, 1].long() - o[1])) * \
        spec.Nz + (ijk[:, 2].long() - o[2])
    if sub is not None:
        k = k + sub.long() * (spec.N * spec.N * spec.Nz)
    return k


def program_voxels(state, spec, channels, extra=None):
    """The observed voxels of a program grid state as ``Voxels`` keyed by
    (submap, i, j, k); ``channels``: names of ``state.channels`` to take,
    ``extra``: {name: (nb, V^3) tensor} to take beside them."""
    V = spec.V
    act = state.block_active.clone()
    act[-1] = False
    rows = torch.nonzero(act).reshape(-1)
    coords = state.block_coords[rows].long()
    intra = torch.arange(V ** 3, device=rows.device)
    off = torch.stack([intra // (V * V), (intra // V) % V, intra % V], 1)
    o = torch.tensor(spec.origin, device=rows.device)
    ijk = (coords[:, None, 1:4] * V + o + off[None]).reshape(-1, 3)
    sub = coords[:, 0:1].expand(-1, V ** 3).reshape(-1)
    keep = state.channels["TSDF_observed"][rows].reshape(-1) > 0
    vals = {}
    for name in channels:
        t = state.channels[name][rows]
        if t.dim() == 3:            # colour (rows, 3, V^3)
            vals[name] = t.permute(0, 2, 1).reshape(-1, 3).float()[keep]
        else:
            vals[name] = t.reshape(-1).float()[keep]
    for name, t in (extra or {}).items():
        vals[name] = t[rows].reshape(-1)[keep]
    return Voxels(voxel_key(spec, ijk[keep], sub[keep]), **vals)


def grid_voxels(grid, spec, mask, sub=None, **vals):
    i, j, k = grid.ijk()
    ijk = torch.stack([i, j, k], 1)[mask]
    s = None if sub is None else torch.full((ijk.shape[0],), sub,
                                            device=ijk.device)
    return Voxels(voxel_key(spec, ijk, s),
                  **{n: v[mask] for n, v in vals.items()})


def match(a: Voxels, b: Voxels):
    """(index into a, index into b) of the keys both hold, and the masks
    of a's and b's keys the other lacks."""
    if b.keys.numel() == 0:
        hit = torch.zeros_like(a.keys, dtype=torch.bool)
        pos = torch.zeros_like(a.keys)
    else:
        pos = torch.searchsorted(b.keys, a.keys).clamp(
            max=b.keys.numel() - 1)
        hit = b.keys[pos] == a.keys
    ia = torch.nonzero(hit).reshape(-1)
    ib = pos[hit]
    only_b = torch.ones_like(b.keys, dtype=torch.bool)
    only_b[ib] = False
    return ia, ib, ~hit, only_b


def tsdf_numbers(p: Voxels, r: Voxels, voxel: float, prefix: str = ""):
    ia, ib, only_p, only_r = match(p, r)
    n_union = ia.numel() + int(only_p.sum()) + int(only_r.sum())
    dt = (p.vals["TSDF"][ia] - r.vals["TSDF"][ib]).abs().sum()
    lone = int(only_p.sum()) + int(only_r.sum())
    out = {f"{prefix}tsdf_gap": float((dt + voxel * lone) /
                                      max(n_union, 1))}
    dw = (p.vals["W_TSDF"][ia] - r.vals["W_TSDF"][ib]).abs().sum() + \
        p.vals["W_TSDF"][only_p].sum() + r.vals["W_TSDF"][only_r].sum()
    out[f"{prefix}weight_gap"] = float(dw / torch.clamp(
        r.vals["W_TSDF"].sum(), min=1e-30))
    if "color" in p.vals and "color" in r.vals:
        dc = (p.vals["color"][ia] - r.vals["color"][ib]).abs().mean(1)
        out[f"{prefix}color_gap"] = float(dc.mean()) if dc.numel() else 0.0
    return out


def quantile(x, q: float) -> float:
    """The ``q`` quantile of ``x`` by nearest rank (0.0 when empty)."""
    if x.numel() == 0:
        return 0.0
    k = max(1, int(np.ceil(q * x.numel())))
    return float(torch.kthvalue(x.float().cpu(), k).values)


def esdf_gaps(p: Voxels, r: Voxels) -> dict:
    """The mean and the 90th percentile of the per-voxel |ESDF gap| over
    the union (a lone voxel against 0)."""
    ia, ib, only_p, only_r = match(p, r)
    d = torch.cat([(p.vals["esdf"][ia] - r.vals["esdf"][ib]).abs(),
                   p.vals["esdf"][only_p].abs(),
                   r.vals["esdf"][only_r].abs()])
    return {"esdf_gap": float(d.mean()) if d.numel() else 0.0,
            "esdf_gap_p90": quantile(d, 0.9)}


def cloud_gaps(spec, voxel, published, ref_cloud, device, lone_cost=1.0):
    """The per-point gaps of one published cloud (xyz (n, 3), values (n,
    c)) against the reference's (ijk, values): each matched point's mean
    |value difference|, ``lone_cost`` for each point on one side only."""
    xyz, val = published
    xyz = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    val = torch.as_tensor(np.asarray(val, np.float32), device=device)
    ijk = torch.round(xyz / voxel).long()
    width = ref_cloud[1].shape[1]
    p = Voxels(voxel_key(spec, ijk), v=val.reshape(xyz.shape[0], width))
    r = Voxels(voxel_key(spec, ref_cloud[0]), v=ref_cloud[1])
    ia, ib, only_p, only_r = match(p, r)
    dv = (p.vals["v"][ia] - r.vals["v"][ib]).abs().mean(1)
    lone = int(only_p.sum()) + int(only_r.sum())
    return torch.cat([dv, torch.full((lone,), float(lone_cost),
                                     device=dv.device)]), r.keys.numel()


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the limited numbers; a
    number the run could not produce fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= lim["limit"]
        ok &= bool(good)
        rows.append((name, v, lim["limit"]))
    return ok, rows
