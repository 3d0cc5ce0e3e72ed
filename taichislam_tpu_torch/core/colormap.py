"""Jet colormap lookup table.

The JAX package samples matplotlib's ``cm.jet`` into a 1024-entry LUT. The
same table is built here from jet's published segment data with numpy, so
the port needs no matplotlib: matplotlib quantizes a colormap to N = 256
entries, interpolated linearly between the segment points, and looks a
float x up at entry ``int(x * 256)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from taichislam_tpu_torch.core.device import resolve_device
from taichislam_tpu_torch.core.geometry import inv

# matplotlib's _jet_data (x, value) breakpoints per channel
_JET = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0),
     (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)
_MPL_N = 256


@functools.lru_cache(maxsize=1)
def _jet_base() -> np.ndarray:
    """matplotlib's quantized jet: (256, 3) float64, interpolated between
    the segment points with matplotlib's own arithmetic."""
    xind = (_MPL_N - 1) * np.linspace(0.0, 1.0, _MPL_N)
    cols = []
    for seg in _JET:
        x = np.array([p[0] for p in seg]) * (_MPL_N - 1)
        y = np.array([p[1] for p in seg])
        ind = np.searchsorted(x, xind)[1:-1]
        dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        cols.append(np.clip(np.concatenate(
            [[y[0]], dist * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]]),
            0.0, 1.0))
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=1)
def jet_lut_np(n: int = 1024) -> np.ndarray:
    """(n, 3) float32 jet LUT, entry i = jet(i / n)."""
    idx = np.minimum((np.arange(n) / float(n) * _MPL_N).astype(np.int64),
                     _MPL_N - 1)
    return _jet_base()[idx].astype(np.float32)


def jet_lut(n: int = 1024, device=None) -> torch.Tensor:
    """The jet LUT as an (n, 3) float32 tensor on ``device`` (the CUDA card
    unless given, see :func:`resolve_device`)."""
    return torch.from_numpy(jet_lut_np(n).copy()).to(resolve_device(device))


def jet_rgba_np(x: np.ndarray) -> np.ndarray:
    """(N, 4) float64 RGBA of jet at float ``x`` in [0, 1], as matplotlib's
    ``cm.jet(x)`` gives it: entry ``int(x * 256)`` of the quantized map
    (computed in x's dtype), 1.0 going to the last entry, alpha 1."""
    x = np.asarray(x)
    xa = x * x.dtype.type(_MPL_N)
    xa = np.where(xa == _MPL_N, _MPL_N - 1, xa)
    idx = np.clip(xa, 0, _MPL_N - 1).astype(np.int64)
    rgba = np.ones(x.shape + (4,), np.float64)
    rgba[..., :3] = _jet_base()[idx]
    return rgba


@functools.lru_cache(maxsize=4)
def _jet_lut(device) -> torch.Tensor:
    return torch.from_numpy(jet_lut_np()).to(device)


def color_from_colormap(z: torch.Tensor, min_z: float, max_z: float,
                        lut=None, reciprocal: bool = True) -> torch.Tensor:
    """(..., 3) colors of ``clamp((z - min) / (max - min) * (n - 1))`` in
    the (n, 3) ``lut``, the 1024-entry jet LUT by default.

    ``reciprocal`` divides by the range as the JAX package's jitted exports
    compute it (a multiply by the f32 reciprocal); ``False`` takes the true
    division of its eagerly run callers (``init_sphere``)."""
    lut = _jet_lut(z.device) if lut is None else torch.as_tensor(
        lut, device=z.device)
    n = lut.shape[0]
    span = float(np.float32(max_z - min_z))
    if reciprocal:
        t = (z - min_z) * inv(span)
    else:
        # a tensor divisor: CUDA would turn a Python scalar into 1/c
        t = (z - min_z) / torch.tensor(span, device=z.device)
    c = torch.clamp(t * float(n - 1), 0, n - 1).to(torch.int64)
    return lut[c]
