"""Coordinate, camera and pose math shared by the map types.

Conventions are those of ``taichislam_tpu.core.geometry``: voxel index =
round(xyz / voxel_scale) with ties away from zero, pinhole back-projection
with ``i`` the image column and ``j`` the row, ``sign(0) == 0``.
"""

from __future__ import annotations

import numpy as np
import torch


def sign(x: torch.Tensor) -> torch.Tensor:
    """Signum with sign(0) == 0."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest integer, ties away from zero (like C ``round``)."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def convert_by_base(base_R, base_T, R, T):
    """Express world pose (R, T) in the frame of base pose (host numpy)."""
    base_R = np.asarray(base_R)
    base_R_inv = base_R.T
    R_ = base_R_inv @ np.asarray(R)
    T_ = base_R_inv @ (np.asarray(T) - np.asarray(base_T))
    return R_, T_


def strided_depth_f32(depth_mm: torch.Tensor, step: int) -> torch.Tensor:
    """Depth image decimated by ``step`` in both axes, as flat f32 mm."""
    h, w = depth_mm.shape
    return depth_mm[:(h // step) * step:step,
                    :(w // step) * step:step].reshape(-1).float()


def pixel_grid(h: int, w: int, step: int, device=None):
    """Strided pixel coordinate grids (rows j, cols i), int32, each of
    shape (h//step, w//step)."""
    rows = torch.arange(0, h // step, dtype=torch.int32, device=device) * step
    cols = torch.arange(0, w // step, dtype=torch.int32, device=device) * step
    jj, ii = torch.meshgrid(rows, cols, indexing="ij")
    return jj, ii
