"""Coordinate, camera and pose math shared by the map types.

Conventions are those of the JAX package's ``core/geometry.py``: voxel index =
round(xyz / voxel_scale) with ties away from zero, pinhole back-projection
with ``i`` the image column and ``j`` the row, ``sign(0) == 0``.

Rounding follows the JAX package as XLA compiles it on the CPU. Inside a
jitted function XLA rewrites a division by a constant as a multiply by its
f32 reciprocal (as PyTorch's CUDA division by a Python scalar also does),
so ``x / c`` is written ``x * inv(c)``; and it contracts multiply-adds into
fused multiply-adds, computed here with one rounding (``fma``, ``dot3``).
sqrt is taken in f64 (``sqrt_rn``): PyTorch's vectorized CPU sqrt is not
correctly rounded. Voxel and pixel indices hang on these roundings.
"""

from __future__ import annotations

import numpy as np
import torch


def inv(c: float) -> float:
    """f32 reciprocal of a constant divisor (exactly representable)."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as the fused multiply-add XLA's CPU
    backend contracts these expressions into: the f64 product is exact and
    the f64 sum is rounded to f32 (a double rounding that differs from a
    true FMA only on exact f32 ties)."""
    return (a.double() * b.double() + c.double()).float()


def sqrt_rn(x):
    """Correctly rounded f32 square root (taken in f64)."""
    return torch.sqrt(x.double()).float()


def dot3(a0, b0, a1, b1, a2, b2):
    """``a0*b0 + a1*b1 + a2*b2`` with the contraction XLA applies:
    fma(a2, b2, fma(a0, b0, a1*b1))."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def sign(x: torch.Tensor) -> torch.Tensor:
    """Signum with sign(0) == 0."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest integer, ties away from zero (like C ``round``)."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def xyz_to_ijk(xyz: torch.Tensor, voxel_scale: float,
               reciprocal: bool = False) -> torch.Tensor:
    """World position -> signed int32 voxel index, round(xyz / voxel_scale)
    ties away from zero. The JAX function divides: called eagerly that is
    a true division (a tensor divisor here, which CUDA does not turn into a
    reciprocal); inside its jitted callers (the raycasts) XLA multiplies by
    the f32 reciprocal, which ``reciprocal`` selects. The two differ near
    half-voxel ties."""
    if reciprocal:
        q = xyz * inv(voxel_scale)
    else:
        q = xyz / torch.tensor(voxel_scale, dtype=xyz.dtype,
                               device=xyz.device)
    return round_half_away(q).to(torch.int32)


def ijk_to_xyz(ijk: torch.Tensor, voxel_scale: float) -> torch.Tensor:
    """Voxel index -> world position of the voxel centre."""
    return ijk.float() * voxel_scale


def unproject_point_dep(i, j, dep, K_dep):
    """Back-project pixel (col ``i``, row ``j``) at depth ``dep`` (m) with
    the flattened 3x3 intrinsic ``K_dep``: (..., 3) camera-frame points."""
    fx, cx, fy, cy = K_dep[0], K_dep[2], K_dep[4], K_dep[5]
    x = (i.float() - cx) * dep / fx
    y = (j.float() - cy) * dep / fy
    return torch.stack([x, y, dep], dim=-1)


def color_ind_from_depth_pt(i, j, K_dep, K_color, w: int, h: int):
    """Re-project depth pixel (col ``i``, row ``j``, f32) into the color
    image; returns (row index, col index) int32. Out-of-bounds pixels clamp
    to (0, 0); the bounds test compares the column with ``h`` and the row
    with ``w``, as the reference does."""
    fx_c, cx_c, fy_c, cy_c = K_color[0], K_color[2], K_color[4], K_color[5]
    fx, cx, fy, cy = K_dep[0], K_dep[2], K_dep[4], K_dep[5]
    color_i = fma((i - cx) / fx, fx_c, cx_c).to(torch.int32)
    color_j = fma((j - cy) / fy, fy_c, cy_c).to(torch.int32)
    oob = (color_i < 0) | (color_i >= h) | (color_j < 0) | (color_j >= w)
    zero = torch.zeros_like(color_i)
    return torch.where(oob, zero, color_j), torch.where(oob, zero, color_i)


def texture_at(texture: torch.Tensor, row, col) -> torch.Tensor:
    """``texture[row, col, :]`` as f32 with the indices clamped into the
    image, as JAX's gather clamps them: the reference's bounds test (rows
    against ``w``) lets rows past the image through."""
    h, w = texture.shape[0], texture.shape[1]
    return texture[row.long().clamp(0, h - 1),
                   col.long().clamp(0, w - 1), :].float()


def transform_points(R, T, pts: torch.Tensor) -> torch.Tensor:
    """Rigid transform of (..., 3) points: R @ p + T."""
    return rotate_points(R, pts) + torch.as_tensor(T, dtype=pts.dtype,
                                                   device=pts.device)


def rotate_points(R, pts: torch.Tensor) -> torch.Tensor:
    """Rotation of (..., 3) points: R @ p."""
    return pts @ torch.as_tensor(R, dtype=pts.dtype, device=pts.device).T


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
