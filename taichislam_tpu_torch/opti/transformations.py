"""Quaternion and rigid-transform math (x, y, z, w convention).

Counterpart of the JAX package's ``opti/transformations.py``: rotation-matrix
conversion, inverse, rotation, Hamilton product, tangent-space retraction
and the lift Jacobian that maps gradients onto the quaternion tangent
space. The tensor functions are vectorized over leading batch dims and
differentiable with ``torch.func`` / autograd; the ``_np`` twins and
``quaternion_from_matrix`` are numpy, for host-side pose bookkeeping.
"""

from __future__ import annotations

import numpy as np
import torch


def quaternion_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [x,y,z,w] -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_inverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, both (..., 4) [x,y,z,w]."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quaternion_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by unit quaternions (..., 4)."""
    qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    out = quaternion_multiply(quaternion_multiply(q, qv),
                              quaternion_inverse(q))
    return out[..., :3]


def quaternion_retraction(q: torch.Tensor, dtheta: torch.Tensor
                          ) -> torch.Tensor:
    """Retract a tangent increment (..., 3) onto the unit quaternions:
    q ⊞ δ = normalize(q ⊗ [δ/2, 1]), the first-order exponential update of
    the reference's bundle adjustment."""
    dq = torch.cat([dtheta * 0.5, torch.ones_like(dtheta[..., :1])], dim=-1)
    out = quaternion_multiply(q, dq)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def plus_quaternion_jacobian(q: torch.Tensor) -> torch.Tensor:
    """∂(q ⊞ δ)/∂δ at δ = 0: the (..., 4, 3) lift matrix 0.5·L(q) that
    maps ambient quaternion gradients to the 3-dof tangent space."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    J = torch.stack([
        w, -z, y,
        z, w, -x,
        -y, x, w,
        -x, -y, -z,
    ], dim=-1).reshape(q.shape[:-1] + (4, 3))
    return 0.5 * J


# numpy twins for host-side pose bookkeeping -------------------------------

def quaternion_matrix_np(q) -> np.ndarray:
    """:func:`quaternion_matrix` in numpy, float32."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = np.float32(1), np.float32(2)
    m = np.stack([
        one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
        two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
        two * (xz - wy), two * (yz + wx), one - two * (xx + yy),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_from_matrix(R) -> np.ndarray:
    """Rotation matrix -> quaternion [x,y,z,w] (Shepperd's method)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])
