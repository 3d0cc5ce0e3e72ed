"""Bundle-adjustment demo: gradient descent with quaternion retraction.

Counterpart of the JAX package's ``examples/gradient_descent_BA.py`` on
``torch.func``: a synthetic scene of camera poses, landmarks and
reprojection observations, optimized by manifold gradient descent
(quaternions updated through the tangent-space retraction). Runs on the
CUDA card unless ``--cpu`` (or ``device="cpu"``) is given:

    python -m taichislam_tpu_torch.opti.ba_demo [--iters 300] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from taichislam_tpu_torch.core.device import resolve_device
from taichislam_tpu_torch.opti import transformations as tf


def project(qs, ts, pts):
    """Reproject all landmarks into all cameras: (C, P, 2)."""
    p_cam = tf.quaternion_rotate(qs[:, None, :],
                                 pts[None, :, :] - ts[:, None, :])
    return p_cam[..., :2] / torch.clamp(p_cam[..., 2:3], min=1e-3)


def make_scene(n_cams=8, n_pts=200, pix_noise=0.0, seed=0, device=None):
    """(qs, ts, pts) as numpy and the observations as a tensor on
    ``device``: landmarks 4-8 m ahead, cameras near the origin with small
    rotations, observations reprojected (plus pixel noise) from numpy
    draws of ``seed``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    qs, ts = [], []
    for _ in range(n_cams):
        axis = rng.normal(size=3) * 0.05
        q = np.concatenate([axis, [1.0]])
        qs.append(q / np.linalg.norm(q))
        ts.append(rng.normal(scale=0.3, size=3))
    qs = np.asarray(qs, np.float32)
    ts = np.asarray(ts, np.float32)

    def dev(a):
        return torch.as_tensor(a).to(device)
    obs = project(dev(qs), dev(ts), dev(pts)).cpu().numpy()
    obs = obs + rng.normal(scale=pix_noise, size=obs.shape)
    return qs, ts, pts, dev(obs.astype(np.float32))


def reprojection_loss(qs, ts, pts, obs):
    r = project(qs, ts, pts) - obs
    return 0.5 * torch.sum(r * r)


def initial_guess(qs, ts, seed=1, device=None):
    """The demo's perturbed start: quaternions +N(0, 0.01) renormalized,
    translations +N(0, 0.05), drawn with numpy from ``seed``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(qs + rng.normal(scale=0.01, size=qs.shape)
                        .astype(np.float32)).to(device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    t = torch.as_tensor(ts + rng.normal(scale=0.05, size=ts.shape)
                        .astype(np.float32)).to(device)
    return q, t


def gradient_descent(qs, ts, pts, obs, iters=200, lr_q=1e-4, lr_t=1e-4):
    """Manifold GD: a translation step and a quaternion tangent
    retraction per iteration. Returns (qs, ts, losses) with the loss before
    each step (one host read per iteration, as the JAX demo's)."""
    grad = torch.func.grad_and_value(reprojection_loss, argnums=(0, 1))
    losses = []
    for _ in range(iters):
        (gq, gt), loss = grad(qs, ts, pts, obs)
        # lift ambient quaternion grads to the tangent space
        J = tf.plus_quaternion_jacobian(qs)              # (C, 4, 3)
        dtheta = torch.einsum("cij,ci->cj", J, gq)       # (C, 3)
        qs = tf.quaternion_retraction(qs, -lr_q * dtheta)
        ts = ts - lr_t * gt
        losses.append(float(loss))
    return qs, ts, losses


def benchmark(iters=1000, device=None):
    """Host ms per loss-and-gradient evaluation at the demo's scene."""
    device = resolve_device(device)
    qs, ts, pts, obs = make_scene(device=device)
    q0 = torch.as_tensor(qs).to(device)
    t0 = torch.as_tensor(ts).to(device) + 0.05
    p = torch.as_tensor(pts).to(device)
    grad = torch.func.grad_and_value(reprojection_loss, argnums=(0, 1))
    float(grad(q0, t0, p, obs)[1])
    s = time.time()
    for _ in range(iters):
        loss = grad(q0, t0, p, obs)[1]
    float(loss)
    print(f"BA gradient step: {(time.time()-s)*1000/iters:.3f} ms/iter "
          f"({iters} iters)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.benchmark:
        benchmark(device=device)
        return
    qs, ts, pts, obs = make_scene(device=device)
    q0, t0 = initial_guess(qs, ts, device=obs.device)
    p = torch.as_tensor(pts).to(obs.device)
    loss0 = float(reprojection_loss(q0, t0, p, obs))
    _, _, losses = gradient_descent(q0, t0, p, obs, iters=args.iters)
    print(f"loss: {loss0:.6f} -> {losses[-1]:.6f} ({args.iters} iterations)")
    assert losses[-1] < loss0 * 0.05, "BA failed to converge"
    print("BA demo OK")


if __name__ == "__main__":
    main()
