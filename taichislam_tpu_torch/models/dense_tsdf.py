"""DenseTSDF: voxblox-style TSDF map with the reference's public API.

The per-frame depth path of ``taichislam_tpu.models.dense_tsdf``:
constructor, adaptive ray-bin bucket, ``recast_depth_to_map`` and
``count_active``. The map state lives on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.models.base_map import BaseMap
from taichislam_tpu_torch.ops import tsdf as tsdf_ops


def bin_bucket_for(n: int, headroom_num=21, headroom_den=20,
                   lo: int = 2048) -> int:
    """Smallest {1, 1.25, 1.5}·2^k bucket ≥ n·headroom (fusion lane count
    scales with the bucket, so granularity matters)."""
    want = max(n * headroom_num // headroom_den, 1)
    b = lo
    while True:
        for num in (4, 5, 6):
            if want <= b * num // 4:
                return b * num // 4
        b *= 2


class DenseTSDF(BaseMap):
    def __init__(self, map_scale=[10, 10], voxel_scale=0.05,
                 texture_enabled=False, max_disp_particles=1024 * 1024,
                 num_voxel_per_blk_axis=16, max_ray_length=10,
                 min_ray_length=0.3, internal_voxels=10, max_submap_num=1024,
                 is_global_map=False, disp_ceiling=1.8, disp_floor=-0.3,
                 recast_step=2, color_same_proj=True, max_blocks=8192,
                 max_bins=32768, max_fuse_voxels=1 << 20,
                 storage_dtype="float32", device=None):
        super().__init__(voxel_scale)
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.cfg = TSDFConfig(
            map_scale=tuple(map_scale), voxel_scale=voxel_scale,
            texture_enabled=texture_enabled,
            max_disp_particles=max_disp_particles,
            num_voxel_per_blk_axis=num_voxel_per_blk_axis,
            max_ray_length=max_ray_length, min_ray_length=min_ray_length,
            internal_voxels=internal_voxels, max_submap_num=max_submap_num,
            is_global_map=is_global_map, disp_ceiling=disp_ceiling,
            disp_floor=disp_floor, recast_step=recast_step,
            color_same_proj=color_same_proj, max_blocks=max_blocks,
            max_bins=max_bins, storage_dtype=storage_dtype)
        spec = self.cfg.grid
        self.map_size_xy = spec.map_size_xy
        self.map_size_z = spec.map_size_z
        self.N = spec.N
        self.Nz = spec.Nz
        self.block_num_xy = spec.bn_xy
        self.block_num_z = spec.bn_z
        self.num_voxel_per_blk_axis = num_voxel_per_blk_axis
        self.max_disp_particles = max_disp_particles
        self.enable_texture = texture_enabled
        self.max_ray_length = max_ray_length
        self.min_ray_length = min_ray_length
        self.tsdf_surface_thres = self.cfg.tsdf_surface_thres
        self.internal_voxels = internal_voxels
        self.max_submap_num = max_submap_num
        self.is_global_map = is_global_map
        self.disp_ceiling = disp_ceiling
        self.disp_floor = disp_floor
        self.recast_step = recast_step
        self.color_same_proj = color_same_proj
        self.max_fuse_voxels = max_fuse_voxels
        # bytes per voxel from the storage dtype: TSDF + W + observed +
        # occupy (+ 3 color components)
        item = self.cfg.dtype.itemsize
        self.mem_per_voxel = 2 * item + 1 + 1 + (3 * item if texture_enabled
                                                 else 0)

        self.state = tsdf_ops.make_tsdf_state(self.cfg, device=self.device)
        self.initialize_submap_fields(max_submap_num)
        # adaptive ray-bin capacity: the lattice scales with the bucket
        self._bin_bucket = min(4096, self.cfg.max_bins)
        self.last_stats = {}

    def _recast_cfg(self):
        if self._bin_bucket >= self.cfg.max_bins:
            return self.cfg
        return dataclasses.replace(self.cfg, max_bins=self._bin_bucket)

    def _update_bin_bucket(self, stats):
        """Adapt the bin bucket to the observed load (one host read)."""
        pack = torch.stack([stats["num_bins"], stats["bins_dropped"]]).cpu()
        n = int(pack[0]) + int(pack[1])
        self._bin_bucket = min(bin_bucket_for(n), self.cfg.max_bins)

    def recast_depth_to_map(self, R, T, depthmap, texture):
        """Fuse one uint16-mm depth image taken at world pose (R, T)."""
        self.set_pose(R, T)
        dev = self.device
        depth = torch.from_numpy(np.asarray(depthmap).astype(np.int32)).to(
            dev)
        self.state, stats = tsdf_ops.integrate_depth(
            self._recast_cfg(), self.state, depth,
            torch.from_numpy(self.input_R).to(dev),
            torch.from_numpy(self.input_T).to(dev),
            torch.from_numpy(self.K_cam_dep).to(dev), self.active_submap_id)
        self.last_stats = stats
        self._update_bin_bucket(stats)

    def count_active(self):
        """Observed voxels in the active submap."""
        st = self.state
        blk = st.block_active & (st.block_coords[:, 0] ==
                                 self.active_submap_id)
        blk[-1] = False
        obs = st.channels["TSDF_observed"] > 0
        return int((obs & blk[:, None]).sum())
