"""Rounding rules and pose arithmetic of the reference.

The node's voxels and pixels hang on f32 roundings, so the reference
computes each quantity with the same single roundings the mapping semantics
fix: a product-sum rounded once (taken in f64 and rounded to f32), square
roots correctly rounded, voxel indices rounded half away from zero, and
division by a constant as a multiply by its f32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch


def inv(c: float) -> float:
    """f32 reciprocal of a constant."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a, b, c):
    """``a * b + c`` in f32 with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def sqrt_rn(x):
    return torch.sqrt(x.double()).float()


def dot3(a0, b0, a1, b1, a2, b2):
    """``a0*b0 + a1*b1 + a2*b2`` contracted as fma(a2, b2, fma(a0, b0,
    a1*b1))."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def sign(x):
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def round_half_away(x):
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def quaternion_matrix(q) -> np.ndarray:
    """[x, y, z, w] -> 3x3 rotation, computed in f32 and held in f64, as a
    pose message is read."""
    q = np.asarray(q, np.float64).astype(np.float32)
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = np.float32(1), np.float32(2)
    m = np.array([
        [one - two * (yy + zz), two * (xy - wz), two * (xz + wy)],
        [two * (xy + wz), one - two * (xx + zz), two * (yz - wx)],
        [two * (xz - wy), two * (yz + wx), one - two * (xx + yy)]],
        np.float32)
    return m.astype(np.float64)


def quaternion_from_matrix(R) -> np.ndarray:
    """Rotation -> [x, y, z, w] (Shepperd's method), for the messages."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    if R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array([0.25 * s, (R[0, 1] + R[1, 0]) / s,
                         (R[0, 2] + R[2, 0]) / s, (R[2, 1] - R[1, 2]) / s])
    if R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        return np.array([(R[0, 1] + R[1, 0]) / s, 0.25 * s,
                         (R[1, 2] + R[2, 1]) / s, (R[0, 2] - R[2, 0]) / s])
    s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
    return np.array([(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s,
                     0.25 * s, (R[1, 0] - R[0, 1]) / s])


def pose_from_msg(pose) -> tuple:
    """(R, T) float64 of a Pose-shaped message."""
    q = pose.orientation
    T = np.array([pose.position.x, pose.position.y, pose.position.z])
    return quaternion_matrix([q.x, q.y, q.z, q.w]), T


def in_base(base_R, base_T, R, T):
    """Pose (R, T) in the frame of a base pose held in f32; f32 results."""
    base_R = np.asarray(base_R, np.float32)
    base_T = np.asarray(base_T, np.float32)
    R_ = base_R.T @ np.asarray(R)
    T_ = base_R.T @ (np.asarray(T) - base_T)
    return R_.astype(np.float32), T_.astype(np.float32)
