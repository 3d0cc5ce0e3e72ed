"""Static configuration for the block voxel grid and the TSDF map.

Field names and defaults are those of the JAX package's ``core/config.py`` so
one set of keyword arguments builds the configuration of either package. The
``pallas_*`` and ``esdf_loop_kernel`` fields are kept for that name
compatibility only: in this package they select nothing (there is one
accumulation path and the sweep dispatch follows ``max_sweeps``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Geometry and capacity of one block voxel grid.

    - voxel index space: centered, ``i,j in [-N//2, N//2)``,
      ``k in [-Nz//2, Nz//2)``;
    - blocks of ``V**3`` voxels; block coord ``b = (ijk + N//2) // V``;
    - a direct-mapped block table of shape
      ``(num_submaps * bn_xy^2 * bn_z,)`` mapping linear block coordinates
      to storage slots (-1 = unallocated);
    - channel arrays of shape ``(max_blocks + 1, V^3)``; the last slot is a
      garbage row absorbing writes to unallocated or overflowed blocks.
    """

    voxel_scale: float = 0.05
    map_size_xy: float = 10.0
    map_size_z: float = 10.0
    num_voxel_per_blk_axis: int = 16
    num_submaps: int = 1024
    max_blocks: int = 8192

    # ---- derived (computed in __post_init__) ----
    N: int = 0
    Nz: int = 0
    bn_xy: int = 0
    bn_z: int = 0

    def __post_init__(self):
        V = self.num_voxel_per_blk_axis
        bn_xy = max(1, math.ceil(self.map_size_xy / self.voxel_scale / V))
        bn_z = max(1, math.ceil(self.map_size_z / self.voxel_scale / V))
        object.__setattr__(self, "bn_xy", bn_xy)
        object.__setattr__(self, "bn_z", bn_z)
        object.__setattr__(self, "N", bn_xy * V)
        object.__setattr__(self, "Nz", bn_z * V)
        object.__setattr__(self, "map_size_xy", self.voxel_scale * self.N)
        object.__setattr__(self, "map_size_z", self.voxel_scale * self.Nz)

    @property
    def V(self) -> int:
        return self.num_voxel_per_blk_axis

    @property
    def voxels_per_block(self) -> int:
        return self.V ** 3

    @property
    def blocks_per_submap(self) -> int:
        return self.bn_xy * self.bn_xy * self.bn_z

    @property
    def table_size(self) -> int:
        return self.num_submaps * self.blocks_per_submap

    @property
    def origin_voxel(self) -> Tuple[int, int, int]:
        """Voxel index of the grid's lower corner (the negative offset)."""
        return (-(self.N // 2), -(self.N // 2), -(self.Nz // 2))

    @property
    def voxel_bounds_lo(self) -> Tuple[int, int, int]:
        return self.origin_voxel

    @property
    def voxel_bounds_hi(self) -> Tuple[int, int, int]:
        o = self.origin_voxel
        return (o[0] + self.N, o[1] + self.N, o[2] + self.Nz)


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """DenseTSDF map configuration (same fields as the JAX package)."""

    map_scale: Tuple[float, float] = (10.0, 10.0)
    voxel_scale: float = 0.05
    texture_enabled: bool = False
    max_disp_particles: int = 1024 * 1024
    num_voxel_per_blk_axis: int = 16
    max_ray_length: float = 10.0
    min_ray_length: float = 0.3
    internal_voxels: int = 10
    max_submap_num: int = 1024
    is_global_map: bool = False
    disp_ceiling: float = 1.8
    disp_floor: float = -0.3
    recast_step: int = 2
    color_same_proj: bool = True

    max_blocks: int = 8192
    max_bins: int = 32768
    storage_dtype: str = "float32"  # 'float32' | 'float16' | 'bfloat16'

    w_max: float = 1000.0

    # name compatibility only (see module docstring)
    pallas_accum: str = "auto"
    # static cap on post-sort march lanes fed to the accumulation kernel
    # (0 = uncapped); integrate reports lanes_dropped / live_lanes
    max_march_lanes: int = 0
    pallas_esdf: str = "auto"
    max_touched_blocks: int = 1024

    # ESDF knobs: meanings as in the JAX package's TSDFConfig
    esdf_raise_slack_voxels: float = 0.0
    esdf_converge_eps: float = 1e-4
    esdf_seed_eps_voxels: float = 0.25
    esdf_scan_sweeps: int = 1
    esdf_scan_period: int = 0
    esdf_force_sweeps: bool = False
    esdf_loop_kernel: str = "auto"

    @property
    def tsdf_surface_thres(self) -> float:
        return self.voxel_scale * 1.8

    @property
    def max_ray_steps(self) -> int:
        return int(math.ceil(self.max_ray_length / self.voxel_scale))

    @property
    def grid(self) -> GridSpec:
        return GridSpec(
            voxel_scale=self.voxel_scale,
            map_size_xy=self.map_scale[0],
            map_size_z=self.map_scale[1],
            num_voxel_per_blk_axis=self.num_voxel_per_blk_axis,
            num_submaps=1 if self.is_global_map else self.max_submap_num,
            max_blocks=self.max_blocks,
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.storage_dtype)


@dataclasses.dataclass(frozen=True)
class OctomapConfig:
    """Octomap configuration (same fields as the JAX package). The grid is
    sized like the reference's K**R tree, ``N = K**ceil(log_K(map/voxel))``,
    and the voxel scale is re-derived as ``map_size / N``."""

    map_scale: Tuple[float, float] = (10.0, 10.0)
    voxel_scale: float = 0.05
    min_occupy_thres: float = 3.0
    texture_enabled: bool = False
    min_ray_length: float = 0.3
    max_ray_length: float = 3.0
    max_disp_particles: int = 1000000
    K: int = 2
    max_submap_num: int = 1024
    disp_ceiling: float = 10.0
    disp_floor: float = -10.0
    is_global_map: bool = False
    recast_step: int = 2
    color_same_proj: bool = True

    max_blocks: int = 8192
    num_voxel_per_blk_axis: int = 16

    def __post_init__(self):
        lk = math.log2(self.K)
        Rxy = math.ceil(math.log2(self.map_scale[0] / self.voxel_scale) / lk)
        Rz = math.ceil(math.log2(self.map_scale[1] / self.voxel_scale) / lk)
        object.__setattr__(self, "Rxy", Rxy)
        object.__setattr__(self, "Rz", Rz)
        object.__setattr__(self, "N", self.K ** Rxy)
        object.__setattr__(self, "Nz", self.K ** Rz)
        object.__setattr__(self, "voxel_scale", self.map_scale[0] / self.N)

    @property
    def grid(self) -> GridSpec:
        # N is a power of K: halve the block size until blocks divide it
        V = self.num_voxel_per_blk_axis
        while self.N % V != 0 or (self.Nz % V != 0 and self.Nz > V):
            V //= 2
        V = max(V, 1)
        return GridSpec(
            voxel_scale=self.voxel_scale,
            map_size_xy=self.voxel_scale * self.N,
            map_size_z=self.voxel_scale * max(self.Nz, V),
            num_voxel_per_blk_axis=V,
            num_submaps=1 if self.is_global_map else self.max_submap_num,
            max_blocks=self.max_blocks,
        )
