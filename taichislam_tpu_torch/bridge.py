"""Carry map state between the JAX package and this one, through numpy.

The JAX package's ``GridState`` (or any object with the same fields) is read
with ``np.asarray`` field by field, so this module needs no JAX. Dtypes are
kept exactly: int32 tables and coordinates, bool flags, int8 / float16 /
float32 channels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from taichislam_tpu_torch.core.grid import GridState

ESDF_KEYS = ("esdf", "fixed", "pending", "seen_tsdf", "seen_obs")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"no torch counterpart for numpy dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def grid_state_from_numpy(state, device=None) -> GridState:
    """Build this package's GridState on ``device`` from a GridState-like
    object whose fields are numpy (or numpy-convertible) arrays."""
    return GridState(
        table=_to_tensor(state.table, device),
        block_coords=_to_tensor(state.block_coords, device),
        block_active=_to_tensor(state.block_active, device),
        num_blocks=_to_tensor(state.num_blocks, device),
        alloc_overflow=_to_tensor(state.alloc_overflow, device),
        channels={k: _to_tensor(v, device)
                  for k, v in state.channels.items()},
    )


def grid_state_to_numpy(state: GridState) -> GridState:
    """The same GridState with every field as a numpy array."""
    def f(t):
        return t.detach().cpu().numpy()
    return GridState(
        table=f(state.table), block_coords=f(state.block_coords),
        block_active=f(state.block_active), num_blocks=f(state.num_blocks),
        alloc_overflow=f(state.alloc_overflow),
        channels={k: f(v) for k, v in state.channels.items()})


def esdf_state_from_numpy(arrays: Dict[str, np.ndarray],
                          device=None) -> Dict[str, torch.Tensor]:
    """ESDF arrays (keys among ``ESDF_KEYS``) as tensors on ``device``."""
    unknown = set(arrays) - set(ESDF_KEYS)
    if unknown:
        raise KeyError(f"unknown ESDF arrays {sorted(unknown)}")
    return {k: _to_tensor(v, device) for k, v in arrays.items()}


def esdf_state_to_numpy(arrays: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in arrays.items()}
