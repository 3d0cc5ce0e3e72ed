"""Octomap: hit-count occupancy map with K³-tree LOD exports.

Counterpart of the JAX package's ``models/octomap.py``. Storage is the block
voxel grid, on ``device``; the K**R tree levels survive as the LOD
parameter of ``cvt_occupy_to_voxels(level)``.
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.core.config import OctomapConfig
from taichislam_tpu_torch.core.grid import reset_grid
from taichislam_tpu_torch.models.base_map import BaseMap, resolve_device
from taichislam_tpu_torch.ops import exports as exports_ops
from taichislam_tpu_torch.ops import occupancy as occ_ops
from taichislam_tpu_torch.utils import profiling
from taichislam_tpu_torch.utils.profiling import host_read


class Octomap(BaseMap):
    def __init__(self, map_scale=[10, 10], voxel_scale=0.05,
                 min_occupy_thres=3, texture_enabled=False,
                 min_ray_length=0.3, max_ray_length=3.0,
                 max_disp_particles=1000000, K=2, max_submap_num=1024,
                 disp_ceiling=10.0, disp_floor=-10.0, is_global_map=False,
                 recast_step=2, color_same_proj=True, max_blocks=8192,
                 device=None):
        super().__init__(voxel_scale)
        self.device = resolve_device(device)
        self.cfg = OctomapConfig(
            map_scale=tuple(map_scale), voxel_scale=voxel_scale,
            min_occupy_thres=min_occupy_thres,
            texture_enabled=texture_enabled, min_ray_length=min_ray_length,
            max_ray_length=max_ray_length,
            max_disp_particles=max_disp_particles, K=K,
            max_submap_num=max_submap_num, disp_ceiling=disp_ceiling,
            disp_floor=disp_floor, is_global_map=is_global_map,
            recast_step=recast_step, color_same_proj=color_same_proj,
            max_blocks=max_blocks)
        self.K = K
        self.Rxy = self.cfg.Rxy
        self.Rz = self.cfg.Rz
        self.N = self.cfg.N
        self.Nz = self.cfg.Nz
        self.voxel_scale = self.cfg.voxel_scale   # re-derived map / N
        self.map_size_xy = map_scale[0]
        self.map_size_z = map_scale[1]
        self.max_disp_particles = max_disp_particles
        self.min_occupy_thres = min_occupy_thres
        self.max_ray_length = max_ray_length
        self.min_ray_length = min_ray_length
        self.enable_texture = texture_enabled
        self.max_submap_num = max_submap_num
        self.disp_ceiling = disp_ceiling
        self.disp_floor = disp_floor
        self.is_global_map = is_global_map
        self.recast_step = recast_step
        self.color_same_proj = color_same_proj

        self.state = occ_ops.make_octomap_state(self.cfg, device=self.device)
        self.initialize_submap_fields(max_submap_num)
        self.num_export_particles = 0
        self.export_x = np.zeros((0, 3), np.float32)
        self.export_color = np.zeros((0, 3), np.float32)

    # -- ingestion ----------------------------------------------------------
    def recast_pcl_to_map(self, R, T, xyz_array, rgb_array, n):
        """Add one hit per point of the first ``n`` points, taken at world
        pose (R, T)."""
        self.set_pose(R, T)
        xyz = np.asarray(xyz_array)[:n]
        rgb = np.asarray(rgb_array)[:n] if self.enable_texture else \
            np.zeros((len(xyz), 3), np.float32)
        self.state = occ_ops.integrate_pcl(
            self.cfg, self.state, self._tensor(xyz, np.float32),
            self._tensor(rgb, np.float32), self._tensor(self.input_R),
            self._tensor(self.input_T), self.active_submap_id)

    def recast_depth_to_map(self, R, T, depthmap, texture):
        """Add one hit per gated depth pixel (uint16 mm) taken at world pose
        (R, T); the (h, w, 3) texture colors the voxels when textured."""
        self.set_pose(R, T)
        tex = texture if self.enable_texture else np.zeros((1, 1, 3),
                                                           np.uint8)
        kc = self.K_cam_color if self.K_cam_color is not None else \
            self.K_cam_dep
        self.state = occ_ops.integrate_depth(
            self.cfg, self.state, self._tensor(depthmap, np.int32),
            self._tensor(tex), self._tensor(self.input_R),
            self._tensor(self.input_T), self._tensor(self.K_cam_dep),
            self._tensor(kc), self.active_submap_id)

    # -- exports ------------------------------------------------------------
    def _occupy_export(self, capacity, level):
        bcap = min(exports_ops.pow2_capacity(
            int(host_read("octo.block_count", self.state.num_blocks)) + 1,
            lo=64), self.cfg.max_blocks)
        buf = occ_ops.occupy_export_packed(
            self.cfg, capacity, int(level), bcap, self.state,
            self._tensor(self.submaps_base_R_np, np.float32),
            self._tensor(self.submaps_base_T_np, np.float32),
            self.active_submap_id)
        xyz, _, color, n = exports_ops.unpack_export(
            buf, capacity, False, "export.occupy_packed")
        return xyz, color, n

    def cvt_occupy_to_voxels(self, level=0):
        (self.export_x, self.export_color,
         self.num_export_particles) = self._occupy_export(
            self.max_disp_particles, level)

    def cvt_occupy_voxels_to(self, level, cur_num, max_disp_particles,
                             x, color):
        """Append the level-``level`` export to host buffers that already
        hold ``cur_num`` particles; returns the new count."""
        xyz, col, kept = self._occupy_export(max_disp_particles, level)
        copy = min(kept, max(0, max_disp_particles - cur_num))
        if copy > 0:
            sl = slice(cur_num, cur_num + copy)
            x[sl] = xyz[:copy]
            color[sl] = col[:copy]
        return cur_num + copy

    def get_occupy_voxels(self, l=0):
        self.cvt_occupy_to_voxels(l)
        return self.export_x, self.export_color

    def get_voxels_occupy(self):
        self.cvt_occupy_to_voxels(0)
        return self.export_x, self.export_color

    # -- fusion / reset -----------------------------------------------------
    def _fuse(self, submaps, only_submap):
        self.state = occ_ops.fuse_submaps(
            submaps.cfg, self.cfg, self.state, submaps.state,
            self._tensor(self.submaps_base_R_np, np.float32),
            self._tensor(self.submaps_base_T_np, np.float32),
            submaps.max_submap_num, only_submap=only_submap)

    def fuse_submaps(self, submaps: "Octomap"):
        """Reset, then fuse every submap of ``submaps`` through THIS map's
        pose registry (the one PGO updates)."""
        self.reset()
        with profiling.span("submap.refuse") as sp:
            self._fuse(submaps, None)
        print(f"[OctoMap] Fuse submaps {sp.ms:.1f}ms, "
              f"active local: {submaps.active_submap_id} "
              f"remote: {submaps.remote_submap_num}")

    def fuse_submaps_incremental(self, submaps: "Octomap", submap_id: int,
                                 sub_bcap=None, defer_verdict=False):
        """Add ONE finished submap's counts without a reset (counts add,
        so this equals reset + refuse-all until PGO moves base poses).
        ``sub_bcap`` and ``defer_verdict`` are accepted for DenseTSDF's
        signature; the count splat has no capacity verdict."""
        with profiling.span("submap.refuse") as sp:
            self._fuse(submaps, submap_id)
        print(f"[OctoMap] Fuse submap {submap_id} incrementally "
              f"{sp.ms:.1f}ms")

    def resolve_deferred_fuse(self):
        """Nothing to settle: octomap fuses have no capacity verdict."""

    def reset(self):
        self.state = reset_grid(self.state)

    # -- misc ---------------------------------------------------------------
    def random_init_octo(self, pts=1000):
        """Random smoke-test fill: counts 0-9 at random voxels."""
        rng = np.random.default_rng(0)
        half_n, half_z = self.N // 2, self.Nz // 2
        ijk = np.stack([
            rng.integers(-half_n, half_n, pts),
            rng.integers(-half_n, half_n, pts),
            rng.integers(-half_z, half_z, pts)], -1).astype(np.float32)
        xyz = ijk * self.voxel_scale
        counts = rng.integers(0, 10, pts).astype(np.float32)
        rep = self._tensor(np.repeat(xyz, counts.astype(np.int64), axis=0))
        if len(rep):
            self.state = occ_ops._scatter_hits(
                self.cfg, self.state, (rep[:, 0], rep[:, 1], rep[:, 2]), None,
                torch.ones(len(rep), dtype=torch.bool, device=self.device),
                self.active_submap_id)

    def is_occupy_fn(self):
        """Predicate xyz (..., 3) -> bool over the active submap: hit count
        above ``min_occupy_thres``."""
        from taichislam_tpu_torch.ops.raycast import make_octomap_occupancy_fn
        return make_octomap_occupancy_fn(self.cfg, self.state,
                                         self.active_submap_id)

    def saveMap(self, path):
        pass

    def export_submap(self):
        return {}

    def input_remote_submap(self, submap):
        """A peer's octomap submap holds no voxels (its export is the
        reference's empty dict): take the next descending slot and set its
        base pose; returns the slot."""
        self.remote_submap_num += 1
        idx = self.max_submap_num - self.remote_submap_num
        R, T = submap["pose"]
        self.set_base_pose_submap(idx, R, T)
        return idx

    def finalization_current_submap(self):
        pass
