"""ShardedDenseTSDF: the DenseTSDF/DenseESDF frame loop on a mesh of ranks.

Counterpart of the JAX package's ``models/sharded_dense_tsdf.py``: a map
whose voxel channels exceed one card's memory lives split over the slot
axis of a :class:`~taichislam_tpu_torch.parallel.mesh.Mesh`
(``parallel/block_sharded.py``) while the whole frame loop runs as
collectives —

    integrate (K1 on this rank's lanes)  →  dirty union  →  incremental
    ESDF (working set by a sum over ranks, all_gather halo sweeps, K2 on
    this rank's rows)  →  surface-block gather (sum over ranks)  →
    marching-cubes mesh patch on the compact surface working set

— so only the surface shell (``surface_block_cap`` blocks) has to fit on
one device. Every rank of the mesh constructs the model and calls the same
methods in the same order (SPMD); ``device`` is the mesh's.

One divergence from the JAX model: ``num_voxel_per_blk_axis`` sets the
block size (the JAX model accepts it and keeps V = 16).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.device import resolve_device
from taichislam_tpu_torch.core.grid import lookup_slots, make_grid_state
from taichislam_tpu_torch.models.base_map import BaseMap
from taichislam_tpu_torch.ops import exports as exports_ops
from taichislam_tpu_torch.ops import marching_cubes as mc_ops
from taichislam_tpu_torch.ops import tsdf as tsdf_ops
from taichislam_tpu_torch.parallel.block_sharded import (
    gather_surface_blocks, sharded_integrate_depth, surface_block_cfg)
from taichislam_tpu_torch.parallel.mesh import Mesh, make_mesh
from taichislam_tpu_torch.parallel.sharded_esdf import sharded_esdf_update


def make_sharded_tsdf_state(cfg: TSDFConfig, mesh: Mesh):
    """An empty sharded TSDF state: the bookkeeping of the whole grid and
    this rank's rows of the channels, on the mesh's device."""
    nb = cfg.grid.max_blocks + 1
    rows = nb // mesh.size
    books = make_grid_state(cfg.grid, {}, device=mesh.device)
    shard = tsdf_ops.make_tsdf_state(
        dataclasses.replace(cfg, max_blocks=rows - 1), device=mesh.device)
    return books._replace(channels=shard.channels)


class ShardedDenseTSDF(BaseMap):
    def __init__(self, mesh: Mesh | None = None, map_scale=[10, 10],
                 voxel_scale=0.05, texture_enabled=False,
                 min_ray_length=0.3, max_ray_length=3.0,
                 max_disp_particles=1 << 20, num_voxel_per_blk_axis=16,
                 max_blocks=8191, max_submap_num=64, recast_step=2,
                 enable_esdf=True, max_esdf_sweeps=8, esdf_block_cap=512,
                 esdf_raise_slack_voxels=None, surface_block_cap=512,
                 max_triangles=1 << 18, max_bins=8192,
                 max_march_lanes=262144, storage_dtype="float32",
                 device=None):
        super().__init__(voxel_scale)
        if mesh is None:
            # every rank of the default group, or a one-rank mesh
            mesh = make_mesh(None if dist.is_initialized() else 1, "block",
                             device=resolve_device(device))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        n = mesh.size
        # the slot axis must divide the mesh: round up
        max_blocks = -(-(max_blocks + 1) // n) * n - 1
        kw = dict(
            map_scale=tuple(map_scale), voxel_scale=voxel_scale,
            texture_enabled=texture_enabled, min_ray_length=min_ray_length,
            max_ray_length=max_ray_length, recast_step=recast_step,
            num_voxel_per_blk_axis=num_voxel_per_blk_axis,
            max_blocks=max_blocks, max_bins=max_bins,
            max_submap_num=max_submap_num, max_march_lanes=max_march_lanes,
            storage_dtype=storage_dtype)
        if esdf_raise_slack_voxels is not None:
            kw["esdf_raise_slack_voxels"] = esdf_raise_slack_voxels
        self.cfg = TSDFConfig(**kw)
        self.map_size_xy, self.map_size_z = map_scale[0], map_scale[1]
        self.max_ray_length = max_ray_length
        self.min_ray_length = min_ray_length
        self.enable_texture = texture_enabled
        self.max_disp_particles = max_disp_particles
        self.num_voxel_per_blk_axis = num_voxel_per_blk_axis
        self.is_global_map = False
        self.initialize_submap_fields(max_submap_num)

        self.enable_esdf = enable_esdf
        self.max_esdf_sweeps = max_esdf_sweeps
        self.esdf_block_cap = esdf_block_cap
        self._esdf_cap_bucket = min(128, esdf_block_cap)
        self.surface_block_cap = surface_block_cap
        self.max_triangles = max_triangles
        self.tsdf_surface_thres = self.cfg.tsdf_surface_thres

        self.state = make_sharded_tsdf_state(self.cfg, mesh)
        self._integrate_fn = sharded_integrate_depth(self.cfg, mesh)
        self._gather_fn = gather_surface_blocks(self.cfg, mesh,
                                                surface_block_cap)
        self._esdf_fns = {}
        nb = self.cfg.grid.max_blocks + 1
        shape = (nb // n, self.cfg.grid.voxels_per_block)
        self.esdf = torch.zeros(shape, dtype=torch.float32,
                                device=self.device)
        self.esdf_fixed = torch.zeros(shape, dtype=torch.int8,
                                      device=self.device)
        self._esdf_pending = torch.zeros((nb,), dtype=torch.bool,
                                         device=self.device)
        self._mesh_dirty = torch.zeros_like(self._esdf_pending)
        self.last_esdf_sweeps = 0
        self.num_TSDF_particles = 0
        self.export_TSDF_xyz = np.zeros((0, 3), np.float32)
        self.export_TSDF = np.zeros((0,), np.float32)
        self.export_color = np.zeros((0, 3), np.float32)

    # -- frame loop ----------------------------------------------------------
    def _esdf_fn(self, cap):
        if cap not in self._esdf_fns:
            self._esdf_fns[cap] = sharded_esdf_update(
                self.cfg, self.max_esdf_sweeps, cap, self.mesh,
                incremental=True)
        return self._esdf_fns[cap]

    def recast_depth_to_map(self, R, T, depthmap, texture=None):
        """Integrate one depth frame (world-frame camera pose) and run the
        incremental sharded ESDF on the touched ∪ pending working set."""
        self.set_pose(R, T)
        tex = (texture if texture is not None and self.enable_texture
               else np.zeros((1, 1, 3), np.uint8))
        kc = self.K_cam_color if self.K_cam_color is not None else \
            self.K_cam_dep
        self.state, touched = self._integrate_fn(
            self.state, self._tensor(depthmap, np.int32), self._tensor(tex),
            self._tensor(self.input_R), self._tensor(self.input_T),
            self._tensor(self.K_cam_dep), self._tensor(kc),
            self.active_submap_id)
        self._mesh_dirty = self._mesh_dirty | touched
        if self.enable_esdf:
            self.update_esdf(touched)

    def update_esdf(self, touched=None):
        """The sharded incremental ESDF; a working-set overflow grows the
        cap bucket (up to ``esdf_block_cap``) before the update runs, so
        the update reads the same inputs at every cap."""
        dirty = self._esdf_pending if touched is None else \
            (touched | self._esdf_pending)
        s = self.active_submap_id
        while True:
            cap = self._esdf_cap_bucket
            ov = self._esdf_fn(cap).overflow(self.state, s, dirty)
            if ov > 0 and cap < self.esdf_block_cap:
                grown = cap
                while grown < cap + ov:
                    grown *= 2
                self._esdf_cap_bucket = min(grown, self.esdf_block_cap)
                continue
            if ov > 0:
                print(f"[ShardedDenseTSDF] ESDF working set over "
                      f"esdf_block_cap by {ov}")
            break
        esdf, fixed, _, sweeps, changed, _ = self._esdf_fn(cap)(
            self.state, self.esdf, self.esdf_fixed, s, dirty)
        self.esdf, self.esdf_fixed = esdf, fixed
        self._esdf_pending = changed
        self.last_esdf_sweeps = int(sweeps)

    # -- consumption: compact surface working set -----------------------------
    def _surface_state(self):
        """Gather the replicated surface-block mini state; grows the cap on
        overflow — the only part of the map that must fit one device."""
        while True:
            mini, n_kept, ov = self._gather_fn(self.state,
                                               self.active_submap_id)
            if int(ov) == 0:
                break
            self.surface_block_cap = exports_ops.pow2_capacity(
                int(n_kept), lo=self.surface_block_cap * 2)
            self._gather_fn = gather_surface_blocks(self.cfg, self.mesh,
                                                    self.surface_block_cap)
        return mini, surface_block_cfg(self.cfg, self.surface_block_cap)

    def cvt_TSDF_surface_to_voxels(self):
        mini, mini_cfg = self._surface_state()
        x, y, z, color, tsdf, nkept = exports_ops.tsdf_surface_export(
            mini_cfg, self.max_disp_particles, self.surface_block_cap,
            mini, self._tensor(self.submaps_base_R_np),
            self._tensor(self.submaps_base_T_np), self.active_submap_id)
        self.export_TSDF_xyz = torch.stack([x, y, z], dim=1).cpu().numpy()
        self.export_TSDF = tsdf.cpu().numpy()
        self.export_color = color.cpu().numpy()
        self.num_TSDF_particles = int(nkept)

    def get_voxels_TSDF_surface(self):
        self.cvt_TSDF_surface_to_voxels()
        return (self.export_TSDF_xyz, self.export_TSDF,
                self.export_color if self.enable_texture else None)

    def _local_blocks(self):
        """This rank's rows of the active submap's block mask."""
        rows = self.esdf.shape[0]
        lo = self.mesh.rank * rows
        nb = self.cfg.grid.max_blocks + 1
        st = self.state
        blk = st.block_active[lo:lo + rows] & \
            (st.block_coords[lo:lo + rows, 0] == self.active_submap_id)
        glob = torch.arange(lo, lo + rows, device=self.device)
        return blk & (glob != nb - 1)

    def count_active(self):
        obs = self.state.channels["TSDF_observed"] > 0
        n = (obs & self._local_blocks()[:, None]).sum(dtype=torch.int32)
        return int(self.mesh.psum(n))

    def extract_mesh(self, incremental=True):
        """Marching-cubes triangles of the surface working set.

        ``incremental=True`` restricts extraction to the 26-dilation of the
        blocks touched since the last call (the per-frame mesh patch);
        False re-extracts every surface block. Returns the op's output
        dict (vertices/normals/colors/num_triangles/block spans)."""
        mini, mini_cfg = self._surface_state()
        s = self.active_submap_id
        mask = None
        if incremental:
            # full-map dirty bitmap -> mini rows (the mini table maps kept
            # linear block ids to mini slots; dirty rows outside the mini
            # state hold no surface and extract nothing anyway)
            c4 = mini.block_coords
            spec = self.cfg.grid
            blin = ((c4[:, 1] * spec.bn_xy + c4[:, 2]) * spec.bn_z +
                    c4[:, 3] + c4[:, 0] * spec.blocks_per_submap)
            full_slot = lookup_slots(spec, self.state.table, torch.where(
                mini.block_active, blin, torch.full_like(blin, -1)))
            nb = spec.max_blocks + 1
            dil = mc_ops.dilate_blocks(self.cfg, self.state, s,
                                       self._mesh_dirty)
            mask = dil[torch.clamp(full_slot, 0, nb - 1).long()] & \
                mini.block_active
        out = mc_ops.extract_mesh(
            mini_cfg, self.max_triangles, 1, self.surface_block_cap, mini, s,
            self.tsdf_surface_thres, block_mask=mask)
        if incremental:
            self._mesh_dirty = torch.zeros_like(self._mesh_dirty)
        return out

    # -- ESDF consumption -----------------------------------------------------
    def esdf_at_blocks(self, dirty=None):
        """The replicated surface working set — planner-local lookups
        without materializing the sharded field on one device."""
        mini, _ = self._surface_state()
        return mini

    def get_esdf_dict(self):
        """Debug/test helper (small maps only): voxel-tuple -> esdf over
        observed voxels. Gathers the full field on every rank."""
        obs = (self.state.channels["TSDF_observed"] > 0) & \
            self._local_blocks()[:, None]
        mask = self.mesh.all_gather(obs).reshape(-1).cpu().numpy()
        esdf = self.mesh.all_gather(self.esdf).reshape(-1).cpu().numpy()
        ijk = exports_ops.voxel_ijk_all(self.cfg.grid, self.state)
        ijk = ijk.reshape(-1, 3).cpu().numpy()
        return {tuple(i): e for i, e, m in zip(ijk, esdf, mask) if m}
