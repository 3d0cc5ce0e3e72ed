"""Carry map state between the JAX package and this one, through numpy.

The JAX package's ``GridState`` (or any object with the same fields) is read
with ``np.asarray`` field by field, so this module needs no JAX. Dtypes are
kept exactly: int32 tables and coordinates, bool flags, int8 / float16 /
float32 channels.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from taichislam_tpu_torch.core.device import resolve_device
from taichislam_tpu_torch.core.grid import GridState

ESDF_KEYS = ("esdf", "fixed", "pending", "seen_tsdf", "seen_obs")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"no torch counterpart for numpy dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def grid_state_from_numpy(state, device=None) -> GridState:
    """Build this package's GridState on ``device`` (the CUDA card unless
    given) from a GridState-like object whose fields are numpy (or
    numpy-convertible) arrays."""
    device = resolve_device(device)
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


OCTOMAP_CHANNELS = {"occupy": np.float32, "color": np.float32}


def octomap_state_from_numpy(state, device=None) -> GridState:
    """An Octomap grid (f32 hit counts ``occupy`` and, textured, f32
    ``color`` (nb, 3, V³)) as this package's GridState on ``device`` (the
    CUDA card unless given)."""
    for k, v in state.channels.items():
        if OCTOMAP_CHANNELS.get(k) != np.asarray(v).dtype:
            raise TypeError(f"not an octomap channel: {k} "
                            f"{np.asarray(v).dtype}")
    return grid_state_from_numpy(state, device)


_MAP_REGISTRY = ("submaps_base_R_np", "submaps_base_T_np", "active_submap_id",
                 "remote_submap_num")
_MAPPING_REGISTRY = ("submaps", "pgo_poses", "ego_motion_poses",
                     "last_frame_id", "active_submap_frame_id", "frame_count",
                     "first_init", "_fusion_dirty", "_active_in_global")


def copy_submap_registry(src, dst):
    """Copy a SubmapMapping's host registry from ``src`` (either package's)
    into ``dst`` (this package's): base poses, active and remote submap
    counts of the collection and the global map, the frame -> submap map,
    PGO and ego-motion poses, and the ingestion counters; and the two maps'
    grids, onto ``dst``'s devices."""
    for name in ("submap_collection", "global_map"):
        s, d = getattr(src, name), getattr(dst, name)
        for k in _MAP_REGISTRY:
            v = getattr(s, k)
            setattr(d, k, np.array(v, copy=True) if isinstance(
                v, np.ndarray) else v)
        d.state = grid_state_from_numpy(s.state, d.device)
    for k in _MAPPING_REGISTRY:
        setattr(dst, k, copy.deepcopy(getattr(src, k)))
    return dst


def esdf_state_from_numpy(arrays: Dict[str, np.ndarray],
                          device=None) -> Dict[str, torch.Tensor]:
    """ESDF arrays (keys among ``ESDF_KEYS``) as tensors on ``device`` (the
    CUDA card unless given)."""
    device = resolve_device(device)
    unknown = set(arrays) - set(ESDF_KEYS)
    if unknown:
        raise KeyError(f"unknown ESDF arrays {sorted(unknown)}")
    return {k: _to_tensor(v, device) for k, v in arrays.items()}


def esdf_state_to_numpy(arrays: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in arrays.items()}


def sharded_rows_from_numpy(a, mesh) -> torch.Tensor:
    """This rank's rows of a full ``(max_blocks+1, ...)`` array (a channel,
    an ESDF field or its flags; e.g. a sharded JAX array read with
    ``np.asarray``), on the mesh's device."""
    a = np.asarray(a)
    rows = a.shape[0] // mesh.size
    lo = mesh.rank * rows
    return _to_tensor(a[lo:lo + rows], mesh.device)


def sharded_state_from_numpy(state, mesh) -> GridState:
    """This rank's shard (``parallel/block_sharded.py`` layout) of a full
    GridState-like object of numpy arrays: the bookkeeping whole, the
    channels' rows of this rank's slot range, on the mesh's device."""
    dev = mesh.device
    return GridState(
        table=_to_tensor(state.table, dev),
        block_coords=_to_tensor(state.block_coords, dev),
        block_active=_to_tensor(state.block_active, dev),
        num_blocks=_to_tensor(state.num_blocks, dev),
        alloc_overflow=_to_tensor(state.alloc_overflow, dev),
        channels={k: sharded_rows_from_numpy(v, mesh)
                  for k, v in state.channels.items()})
