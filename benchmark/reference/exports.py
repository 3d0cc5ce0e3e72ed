"""What the node publishes, worked out from a reference grid.

- The surface cloud: observed voxels with ``|tsdf|`` under 1.8 voxels whose
  centre lies between the display floor and ceiling, coloured by their
  stored colour (textured) or by jet over height.
- The ESDF slice: the snapshot's observed voxels in the z-index plane of
  the slice height, with their ESDF (which the node colours by jet over
  +-max_ray/4).

Each comes back as voxel indices (n, 3) int64 and values (n, c) f32.
Jet is matplotlib's 256-entry quantisation sampled into 1024 entries.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .geometry import inv

_JET = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0),
     (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)


@functools.lru_cache(maxsize=1)
def jet_lut() -> np.ndarray:
    """(1024, 3) f32: entry i is jet(i / 1024) of the 256-entry map."""
    n_mpl = 256
    xind = (n_mpl - 1) * np.linspace(0.0, 1.0, n_mpl)
    cols = []
    for seg in _JET:
        x = np.array([p[0] for p in seg]) * (n_mpl - 1)
        y = np.array([p[1] for p in seg])
        ind = np.searchsorted(x, xind)[1:-1]
        dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        cols.append(np.clip(np.concatenate(
            [[y[0]], dist * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]]),
            0.0, 1.0))
    base = np.stack(cols, axis=1)
    idx = np.minimum((np.arange(1024) / 1024.0 * n_mpl).astype(np.int64),
                     n_mpl - 1)
    return base[idx].astype(np.float32)


def jet(x, lo: float, hi: float):
    lut = torch.from_numpy(jet_lut()).to(x.device)
    span = float(np.float32(hi - lo))
    t = (x - lo) * inv(span)
    return lut[torch.clamp(t * 1023.0, 0, 1023).to(torch.int64)]


def _ijk(grid, mask):
    i, j, k = grid.ijk()
    return torch.stack([i[mask], j[mask], k[mask]], 1).long()


def surface(grid, voxel: float, floor: float, ceiling: float):
    i, j, k = grid.ijk()
    z = k.float() * voxel
    mask = grid.obs & (grid.tsdf.float().abs() <
                       float(np.float32(voxel * 1.8)))
    mask &= (z <= float(np.float32(ceiling))) & (z >= float(np.float32(floor)))
    if grid.color is not None:
        col = grid.color.float()[:, mask].T
    else:
        col = jet(z[mask], floor, ceiling)
    return _ijk(grid, mask), col


def esdf_slice(grid, esdf, participate, voxel: float, z: float):
    i, j, k = grid.ijk()
    f32 = np.float32
    zi = float(np.trunc(f32(z) * f32(inv(voxel))))
    kf = k.float()
    mask = participate & (kf > zi - 0.5) & (kf < zi + 0.5)
    return _ijk(grid, mask), esdf[mask][:, None]
