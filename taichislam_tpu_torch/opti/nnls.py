"""Nonlinear least squares on ``torch.func``.

Counterpart of the JAX package's ``opti/nnls.py``: named parameter blocks
packed into one flat f32 vector, cost functions that reference blocks by name,
the loss and its gradient, and two solvers: plain gradient descent and a damped
Gauss-Newton (Levenberg-Marquardt) on ``torch.func.jacfwd`` residual Jacobians
with the normal equations solved densely. The parameters live on ``device``:
the CUDA card unless the caller passes another.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from taichislam_tpu_torch.core.device import resolve_device


class CostFunction:
    """A residual term over named parameter blocks: ``residual_fn(*blocks)
    -> residual tensor``; the squared L2 norm of all residuals is the
    objective."""

    def __init__(self, residual_fn: Callable, param_names: List[str]):
        self.residual_fn = residual_fn
        self.param_names = list(param_names)


class NNLS:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.blocks: Dict[str, torch.Tensor] = {}
        self.costs: List[CostFunction] = []
        self._packed = None
        self._layout = None

    # -- parameter blocks ---------------------------------------------------
    def add_parameter_block(self, name: str, value):
        self.blocks[name] = torch.as_tensor(value, dtype=torch.float32).to(
            self.device)

    def add_cost_function(self, cost: CostFunction):
        self.costs.append(cost)

    # -- packing --------------------------------------------------------------
    def pre_solve(self):
        layout = {}
        off = 0
        for name, v in self.blocks.items():
            layout[name] = (off, tuple(v.shape))
            off += int(np.prod(v.shape))
        self._layout = layout
        self._packed = torch.cat(
            [v.reshape(-1) for v in self.blocks.values()]) if self.blocks \
            else torch.zeros((0,), device=self.device)
        return self._packed

    def _unpack(self, x):
        out = {}
        for name, (off, shape) in self._layout.items():
            n = int(np.prod(shape))
            out[name] = x[off:off + n].reshape(shape)
        return out

    # -- objective ----------------------------------------------------------
    def residuals(self, x):
        blocks = self._unpack(x)
        res = [c.residual_fn(*[blocks[n] for n in c.param_names]).reshape(-1)
               for c in self.costs]
        return torch.cat(res) if res else torch.zeros((0,), device=x.device)

    def loss(self, x):
        r = self.residuals(x)
        return 0.5 * torch.sum(r * r)

    def evaluate_test(self):
        """Loss and gradient at the current packed parameters."""
        if self._packed is None:
            self.pre_solve()
        grad, val = torch.func.grad_and_value(self.loss)(self._packed)
        return float(val), grad.cpu().numpy()

    def _result(self, x):
        return {n: v.cpu().numpy() for n, v in self._unpack(x).items()}

    # -- solvers -----------------------------------------------------------
    def solve(self, iters: int = 100, lr: float = 1e-2):
        """Plain gradient descent; returns the final blocks as numpy."""
        if self._packed is None:
            self.pre_solve()
        grad = torch.func.grad(self.loss)
        x = self._packed
        for _ in range(iters):
            x = x - lr * grad(x)
        self._packed = x
        return self._result(x)

    def solve_lm(self, iters: int = 20, damping: float = 1e-3):
        """Damped Gauss-Newton (LM) for small problems: J by forward-mode
        autodiff, normal equations solved densely. A step is kept when the
        loss at its start beat the best so far (then the damping halves),
        else the damping grows fourfold."""
        if self._packed is None:
            self.pre_solve()
        res_fn = self.residuals
        jac = torch.func.jacfwd(res_fn)

        def step(x, lam):
            r = res_fn(x)
            J = jac(x)
            H = J.T @ J + lam * torch.eye(x.shape[0], device=x.device)
            g = J.T @ r
            dx = torch.linalg.solve(H, g)
            return x - dx, 0.5 * torch.sum(r * r)

        x = self._packed
        lam = damping
        prev = float("inf")
        for _ in range(iters):
            x_new, f = step(x, lam)
            f = float(f)
            if f < prev:
                x, prev, lam = x_new, f, max(lam * 0.5, 1e-9)
            else:
                lam = min(lam * 4.0, 1e6)
        self._packed = x
        return self._result(x)


# reference-compatible alias
TaichiNNLS = NNLS
