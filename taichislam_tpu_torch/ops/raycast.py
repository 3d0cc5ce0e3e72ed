"""Batched fixed-step raycasts and point queries against map occupancy.

Counterpart of the JAX package's ``ops/raycast.py``: a fan of rays is one dense
(rays x steps) lattice of samples, each looked up in the map's block grid;
the first occupied sample of a ray is its hit. Plain PyTorch on the map's
device: the JAX module is XLA with no Pallas kernel, and the lattice is a
handful of elementwise ops and one gather.

The occupancy predicates keep the reference's semantics, including the
quirk that **unallocated TSDF voxels read 0 and so count as occupied**
(``TSDF < tsdf_surface_thres``), which confines the topo graph's skeleton to
observed free space.

Rounding: the JAX raycasts and point queries are jitted with the config
static, and XLA turns ``xyz / voxel_scale`` into a multiply by the f32
reciprocal, so the predicates round ``xyz * inv(voxel_scale)`` (an eager
call of a JAX predicate divides instead, and can differ at half-voxel
ties). The lattice's samples ``pos + dir * step`` are formed without
contraction; XLA's CPU code contracts some lanes of that multiply-add into
FMAs, so a sample can differ from the JAX one by an ulp, and its voxel
index only where that ulp straddles a half-voxel tie.
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.core import geometry
from taichislam_tpu_torch.core.grid import (flat_voxel_index, gather_channel,
                                            lookup_slots, voxel_to_block)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _lookup_channel(spec, state, channel, s, ijk):
    blin, intra, _ = voxel_to_block(spec, s, ijk)
    slots = lookup_slots(spec, state.table, blin)
    return gather_channel(state.channels[channel],
                          flat_voxel_index(spec, slots, intra))


def make_tsdf_occupancy_fn(cfg, state, active_submap):
    """xyz (..., 3) -> bool: is_occupy of a DenseTSDF map (TSDF below the
    surface threshold, unallocated voxels included)."""
    spec = cfg.grid
    thres = _f32(cfg.tsdf_surface_thres)

    def occ(xyz):
        ijk = geometry.xyz_to_ijk(xyz, cfg.voxel_scale, reciprocal=True)
        tsdf = _lookup_channel(spec, state, "TSDF", active_submap, ijk)
        return tsdf.float() < thres

    return occ


def make_tsdf_unobserved_fn(cfg, state, active_submap):
    """xyz (..., 3) -> bool: is_unobserved of a DenseTSDF map."""
    spec = cfg.grid

    def unobs(xyz):
        ijk = geometry.xyz_to_ijk(xyz, cfg.voxel_scale, reciprocal=True)
        o = _lookup_channel(spec, state, "TSDF_observed", active_submap, ijk)
        return o == 0

    return unobs


def make_octomap_occupancy_fn(cfg, state, active_submap):
    """xyz (..., 3) -> bool: is_occupy of an Octomap (hit count above
    ``min_occupy_thres``)."""
    spec = cfg.grid
    thres = _f32(cfg.min_occupy_thres)

    def occ(xyz):
        ijk = geometry.xyz_to_ijk(xyz, cfg.voxel_scale, reciprocal=True)
        c = _lookup_channel(spec, state, "occupy", active_submap, ijk)
        return c > thres

    return occ


def raycast(occupancy_fn, pos, dirs, max_dist, voxel_scale, max_steps: int):
    """March ``dirs`` (R, 3) from ``pos`` ((3,) shared or (R, 3) per ray)
    one voxel per step: samples at 0, v, 2v, ... below ``max_dist`` (a
    float or an (R,) tensor); the first occupied sample wins. Returns
    (hit (R,) bool, hit_pos (R, 3), hit_len (R,))."""
    steps = torch.arange(max_steps, dtype=torch.float32,
                         device=dirs.device) * _f32(voxel_scale)
    if isinstance(max_dist, torch.Tensor) and max_dist.ndim == 1:
        live = steps[None, :] < max_dist[:, None]
    else:
        live = (steps < (max_dist if isinstance(max_dist, torch.Tensor)
                         else _f32(max_dist)))[None, :]
    pos_b = pos if pos.ndim == 1 else pos[:, None, :]
    x = pos_b + dirs[:, None, :] * steps[None, :, None]       # (R, S, 3)
    occ = occupancy_fn(x) & live                                # (R, S)
    hit = occ.any(dim=-1)
    # the first occupied sample: argmax returns the first maximum
    first = occ.to(torch.int32).argmax(dim=-1)
    hit_len = torch.where(hit, steps[first], torch.zeros_like(steps[first]))
    hit_pos = pos + dirs * hit_len[:, None]
    return hit, hit_pos, hit_len


def tsdf_raycast(cfg, max_steps: int, state, active_submap, pos, dirs,
                 max_dist):
    """Fan raycast against a DenseTSDF map."""
    occ = make_tsdf_occupancy_fn(cfg, state, active_submap)
    return raycast(occ, pos, dirs, max_dist, cfg.voxel_scale, max_steps)


def octomap_raycast(cfg, max_steps: int, state, active_submap, pos, dirs,
                    max_dist):
    """Fan raycast against an Octomap."""
    occ = make_octomap_occupancy_fn(cfg, state, active_submap)
    return raycast(occ, pos, dirs, max_dist, cfg.voxel_scale, max_steps)


def tsdf_point_query(cfg, state, active_submap, xyz):
    """Batched (occupied, unobserved) point queries on a DenseTSDF map."""
    occ = make_tsdf_occupancy_fn(cfg, state, active_submap)(xyz)
    unobs = make_tsdf_unobserved_fn(cfg, state, active_submap)(xyz)
    return occ, unobs


def octomap_point_query(cfg, state, active_submap, xyz):
    """Batched (occupied, unobserved = False) point queries on an Octomap."""
    occ = make_octomap_occupancy_fn(cfg, state, active_submap)(xyz)
    return occ, torch.zeros_like(occ)


def is_near_pos_occupy(occupancy_fn, xyz, voxel_scale, radius_voxels: int):
    """Any occupied voxel within [-r, r)^3 voxels of ``xyz`` (..., 3). At
    radius 0 the range is empty and the answer is always False, as in the
    reference."""
    r = radius_voxels
    a = torch.arange(-r, r, device=xyz.device)
    offs = torch.stack(torch.meshgrid(a, a, a, indexing="ij"),
                       dim=-1).reshape(-1, 3).float()
    probes = xyz[..., None, :] + offs * _f32(voxel_scale)
    return occupancy_fn(probes).any(dim=-1)
