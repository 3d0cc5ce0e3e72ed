"""DenseTSDF: voxblox-style TSDF map with the reference's public API.

Counterpart of the JAX package's ``models/dense_tsdf.py`` for a single map:
constructor, adaptive ray-bin bucket, depth and point-cloud ingest
(textured or not), the mesh-dirty protocol of the incremental mesher,
surface / slice exports, ``count_active``, the npy submap dict
(``export_submap``, or ``start_export_submap`` to read it later on another
thread; ``saveMap`` / ``loadMap``, byte-compatible with the JAX
package's), the compact submap gather of the voxgraph wire
(``export_submap_async`` / ``finish_export_submap``), remote submaps in
descending slots, submap fusion (``fuse_submaps``,
``fuse_submaps_incremental``), ``reset``, the ``init_sphere`` fixture and
the multi-frame ingest ``recast_depth_sequence`` (``ops/sequence.py``:
one CUDA graph replay per frame on the card). ``capacity_check_interval``
(an attribute, default 1) reads the bin load every that many frames, as in
the JAX package.
The map state lives on ``device``: the CUDA card unless the caller passes
another (``device="cpu"``); with no card and no device it raises. Its
tensors keep their addresses for the map's life (every op writes them in
place), so the sequences' captured graphs stay valid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.grid import clone_state, copy_state_, reset_grid
from taichislam_tpu_torch.models.base_map import BaseMap, resolve_device
from taichislam_tpu_torch.ops import exports as exports_ops
from taichislam_tpu_torch.ops import fusion as fusion_ops
from taichislam_tpu_torch.ops import sequence as seq_ops
from taichislam_tpu_torch.ops import tsdf as tsdf_ops
from taichislam_tpu_torch.utils import profiling
from taichislam_tpu_torch.utils.profiling import host_read, host_read_start


# the most source block slots one refuse pass splats: the default block
# capacity, so a collection that has not grown past it fuses in one pass
_FUSE_GROUP_BLOCKS = 8192


def _block_cap(need: int, limit: int) -> int:
    """A source block cap for ``need`` block slots: ``need`` rounded up to
    a multiple of a sixteenth of the power of two at or above it, at least
    64, at most ``limit``. As a collection fills, the refuse's lanes, time
    and scratch then grow in steps of at most an eighth, not in doublings."""
    p = 64
    while p < need:
        p *= 2
    step = p // 16
    return min(max(-(-need // step) * step, 64), limit)


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
        self.device = resolve_device(device)
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
        # adaptive ray-bin capacity: the lattice scales with the bucket,
        # read every capacity_check_interval frames (an under-sized bucket
        # drops bins until the next check)
        self._bin_bucket = min(4096, self.cfg.max_bins)
        self.capacity_check_interval = 1
        self._cap_frame = -1
        self.last_stats = {}
        # mesh-dirty protocol (models/mesher.py): the device union of the
        # touched-block bitmaps since the mesher last consumed them; the
        # full flag covers events that can move any voxel
        self._mesh_dirty_full = True
        self._mesh_dirty = None
        # host-side export mirrors (the reference's export_* fields)
        self.num_TSDF_particles = 0
        self.export_TSDF_xyz = np.zeros((0, 3), np.float32)
        self.export_color = np.zeros((0, 3), np.float32)
        self.export_TSDF = np.zeros((0,), np.float32)

    # -- mesh-dirty protocol --------------------------------------------------
    def _mark_mesh_dirty(self, touched):
        if self._mesh_dirty_full or touched is None:
            return
        # a copy: ``touched`` may be a buffer its producer writes again
        self._mesh_dirty = touched.clone() if self._mesh_dirty is None \
            else (self._mesh_dirty | touched)

    def _mark_mesh_dirty_full(self):
        self._mesh_dirty_full = True
        self._mesh_dirty = None

    def consume_mesh_dirty(self):
        """(needs_full, bitmap), clearing the pending set: ``needs_full``
        after events that can move any voxel (and on first use); otherwise
        ``bitmap`` is the per-slot union of the blocks touched since the
        last consume (None: nothing changed)."""
        if self._mesh_dirty_full:
            self._mesh_dirty_full = False
            self._mesh_dirty = None
            return True, None
        d = self._mesh_dirty
        self._mesh_dirty = None
        return False, d

    def finalization_current_submap(self):
        # the mesher extracts the ACTIVE submap; a switch changes it wholesale
        self._mark_mesh_dirty_full()
        self._reserve_blocks()

    def _reserve_blocks(self):
        """Keep a quarter of the block slots free for the next submap. A
        submap collection keeps every submap's blocks, so once more than
        three quarters of its slots are allocated (one host read a switch)
        the state moves into one with twice the slots: the blocks keep
        their slots and the table its entries, and no block is dropped
        however long the collection runs."""
        used = int(host_read("tsdf.block_capacity", self.state.num_blocks))
        cap = self.cfg.max_blocks
        while used * 4 > cap * 3:
            cap *= 2
        if cap == self.cfg.max_blocks:
            return
        print(f"[DenseTSDF] block capacity {self.cfg.max_blocks} -> {cap} "
              f"at {used} blocks")
        old, n = self.state, self.cfg.max_blocks
        self.cfg = dataclasses.replace(self.cfg, max_blocks=cap)
        self.state = tsdf_ops.make_tsdf_state(self.cfg, device=self.device)
        for f in ("table", "num_blocks", "alloc_overflow"):
            getattr(self.state, f).copy_(getattr(old, f))
        for f in ("block_coords", "block_active"):
            getattr(self.state, f)[:n].copy_(getattr(old, f)[:n])
        for k, v in self.state.channels.items():
            v[:n].copy_(old.channels[k][:n])

    # -- ingestion ------------------------------------------------------------
    def _recast_cfg(self):
        if self._bin_bucket >= self.cfg.max_bins:
            return self.cfg
        return dataclasses.replace(self.cfg, max_bins=self._bin_bucket)

    def _update_bin_bucket(self, stats):
        """Adapt the bin bucket to the observed load: one host read every
        ``capacity_check_interval`` frames (the first frame included)."""
        self._cap_frame += 1
        if self._cap_frame % self.capacity_check_interval:
            return
        pack = host_read("tsdf.bin_load", torch.stack(
            [stats["num_bins"], stats["bins_dropped"]]))
        n = int(pack[0]) + int(pack[1])
        self._bin_bucket = min(bin_bucket_for(n), self.cfg.max_bins)

    def _trace_scalars(self):
        """The last frame's bin count and dropped bins (device tensors)."""
        return {k: self.last_stats[k] for k in ("num_bins", "bins_dropped")
                if k in self.last_stats}

    def _after_recast(self, stats):
        self.last_stats = stats
        self._mark_mesh_dirty(stats.get("touched_blocks"))
        self._update_bin_bucket(stats)

    def _integrate_frame(self, cfg, R, T, depthmap, tex):
        """Fuse one depth image at world pose (R, T) with ``cfg`` and the
        texture ``tex`` as given; returns the frame's stats."""
        self.set_pose(R, T)
        kc = self.K_cam_color if self.K_cam_color is not None else \
            self.K_cam_dep
        self.state, stats = tsdf_ops.integrate_depth(
            cfg, self.state, self._input(depthmap, np.int32),
            self._input(tex, np.uint8), self._input(self.input_R),
            self._input(self.input_T), self._input(self.K_cam_dep),
            self._input(kc), self.active_submap_id)
        return stats

    def recast_depth_to_map(self, R, T, depthmap, texture):
        """Fuse one uint16-mm depth image taken at world pose (R, T), with
        its (h, w, 3) uint8 texture when the map is textured."""
        tex = texture if self.enable_texture else np.zeros((1, 1, 3),
                                                           np.uint8)
        self._after_recast(self._integrate_frame(self._recast_cfg(), R, T,
                                                 depthmap, tex))

    def recast_pcl_to_map(self, R, T, xyz_array, rgb_array):
        """Fuse one point cloud (sensor frame, rotated only) taken at world
        pose (R, T)."""
        self.set_pose(R, T)
        rgb = rgb_array if self.enable_texture else np.zeros(
            (len(xyz_array), 3), np.float32)
        self.state, stats = tsdf_ops.integrate_pcl(
            self._recast_cfg(), self.state,
            self._input(xyz_array, np.float32), self._input(rgb, np.float32),
            self._input(self.input_R), self._input(self.input_T),
            self.active_submap_id)
        self._after_recast(stats)

    # -- exports --------------------------------------------------------------
    def _export_block_bucket(self):
        """Block cap of the exports: the allocated block count, bucketed to
        a power of two."""
        return min(exports_ops.pow2_capacity(
            int(host_read("tsdf.block_count", self.state.num_blocks)) + 1,
            lo=64), self.cfg.max_blocks)

    def _bases(self):
        return (self._tensor(self.submaps_base_R_np, np.float32),
                self._tensor(self.submaps_base_T_np, np.float32))

    def _surface_export(self, capacity):
        """(xyz, tsdf, color, kept): host views of one packed read."""
        buf = exports_ops.tsdf_surface_export_packed(
            self.cfg, capacity, self._export_block_bucket(), self.state,
            *self._bases(), self.active_submap_id)
        return exports_ops.unpack_export(buf, capacity, True,
                                         "export.surface_packed")

    def cvt_occupy_to_voxels(self):
        self.cvt_TSDF_surface_to_voxels()

    def cvt_TSDF_surface_to_voxels(self):
        (self.export_TSDF_xyz, self.export_TSDF, self.export_color,
         self.num_TSDF_particles) = self._surface_export(
            self.max_disp_particles)

    def cvt_TSDF_surface_to_voxels_to(self, num_particles, max_disp_particles,
                                      export_TSDF_xyz, export_color):
        """Append the surface export to host buffers that already hold
        ``num_particles``; returns the new count."""
        xyz, _, color, kept = self._surface_export(max_disp_particles)
        copy = min(kept, max(0, max_disp_particles - num_particles))
        if copy > 0:
            sl = slice(num_particles, num_particles + copy)
            export_TSDF_xyz[sl] = xyz[:copy]
            export_color[sl] = color[:copy]
        return num_particles + copy

    def cvt_TSDF_to_voxels_slice(self, z, dz=0.5, clear_last=True):
        buf = exports_ops.tsdf_slice_export_packed(
            self.cfg, self.max_disp_particles, self._export_block_bucket(),
            self.state, *self._bases(), self.active_submap_id, z, dz)
        (self.export_TSDF_xyz, self.export_TSDF, self.export_color,
         self.num_TSDF_particles) = exports_ops.unpack_export(
            buf, self.max_disp_particles, True, "export.tsdf_slice_packed")

    def get_voxels_TSDF_surface(self):
        self.cvt_TSDF_surface_to_voxels()
        if self.enable_texture:
            return self.export_TSDF_xyz, self.export_TSDF, self.export_color
        return self.export_TSDF_xyz, self.export_TSDF, None

    def get_voxels_TSDF_slice(self, z):
        self.cvt_TSDF_to_voxels_slice(z)
        return self.export_TSDF_xyz, self.export_TSDF

    def get_voxels_occupy(self):
        self.cvt_TSDF_surface_to_voxels()
        return self.export_TSDF_xyz, self.export_color

    # -- multi-frame ingest ---------------------------------------------------
    def recast_depth_sequence(self, Rs, Ts, depthmaps, textures=None):
        """Fuse a window of depth frames (world poses ``Rs``, ``Ts``) with
        the JAX package's sequence semantics through
        ``ops/sequence.integrate_depth_sequence``: on the card one CUDA
        graph replay per frame and one host read per window. The window
        holds one ray-bin bucket, its stats are its frames' maxima
        (``max_bins_total``, ``max_dropped``, ``max_live_lanes``) and the
        union of their touched blocks, and a capacity miss grows the
        buckets and redoes the whole window from its entry state. The
        frames may be host arrays or tensors on any device. The active
        submap must not change inside the window
        (``SubmapMapping.recast_depth_sequence`` splits at keyframes).
        ``sequence_verdict_async = True`` is accepted and ends in the state
        of the JAX package's async chain (which also replays a window whose
        bucket did not cover its bins); the verdict is settled before this
        returns, so readers of the map see no pending chain."""
        self._recast_window(Rs, Ts, depthmaps, textures)

    def _sequence_cfg(self):
        cfg = self._recast_cfg()
        tb = getattr(self, "_touched_bucket", 0)
        if tb and tb != cfg.max_touched_blocks:
            cfg = dataclasses.replace(cfg, max_touched_blocks=tb)
        return cfg

    def _sequence_inputs(self, Rs, Ts, textures):
        """The window's poses in the active submap's frame (as per-frame
        ``set_pose``, which the last frame's leaves in ``input_R`` /
        ``input_T``), its textures (None when untextured) and the two
        intrinsics."""
        F = len(Rs)
        R_c = np.zeros((F, 3, 3), np.float32)
        T_c = np.zeros((F, 3), np.float32)
        for f in range(F):
            R_c[f], T_c[f] = self.convert_by_base(np.asarray(Rs[f]),
                                                  np.asarray(Ts[f]))
        self.input_R, self.input_T = R_c[-1].copy(), T_c[-1].copy()
        tex = textures if (self.enable_texture and textures is not None) \
            else None
        kc = self.K_cam_color if self.K_cam_color is not None else \
            self.K_cam_dep
        return R_c, T_c, tex, self.K_cam_dep, kc

    def _window_entry(self, esdf):
        """What a redo restores: the map state (DenseESDF adds its ESDF
        arrays when ``esdf``)."""
        return clone_state(self.state)

    def _window_restore(self, entry):
        """Write the entry state back into the live tensors (a captured
        graph writes those)."""
        copy_state_(self.state, entry)

    def _window_pass(self, cfg, inputs, depthmaps, esdf_budget):
        """One pass of the window from the current state; returns its
        stats."""
        R_c, T_c, tex, K, Kc = inputs
        self.state, stats = seq_ops.integrate_depth_sequence(
            cfg, self.state, depthmaps, tex, R_c, T_c, K, Kc,
            self.active_submap_id)
        return stats

    def _recast_window(self, Rs, Ts, depthmaps, textures, esdf_budget=None):
        """The window with its verdict; with ``esdf_budget`` every frame
        also runs DenseESDF's gated block-mode ESDF step at that budget."""
        inputs = self._sequence_inputs(Rs, Ts, textures)
        entry = self._window_entry(esdf_budget is not None)
        for attempt in range(8):
            if attempt:
                self._window_restore(entry)
            stats = self._window_pass(self._sequence_cfg(), inputs,
                                      depthmaps, esdf_budget)
            if not self._sequence_verdict(stats):
                break
        self.last_stats = stats
        self._mark_mesh_dirty(stats["touched_blocks"])

    def _sequence_verdict(self, stats):
        """One host read for the window; grow the buckets on a capacity
        miss. Returns True when the window must be redone. The read also
        carries ``max_esdf_overflow`` when present, into
        ``self._verdict_extra``."""
        keys = ["max_bins_total", "max_dropped"] + [
            k for k in ("max_esdf_overflow",) if k in stats]
        pack = host_read("tsdf.sequence_verdict",
                         torch.stack([stats[k] for k in keys])).tolist()
        bins_total, dropped = pack[:2]
        self._verdict_extra = pack[2:]
        redo = False
        want = min(bin_bucket_for(bins_total), self.cfg.max_bins)
        # the JAX package's async chain also replays a window whose bucket
        # did not cover its bins
        late = getattr(self, "sequence_verdict_async", False) and \
            want > self._bin_bucket
        if dropped > 0 or late:
            # any capacity miss (touched tiles / lanes / alloc): grow the
            # buckets and redo the window from its entry state
            if want > self._bin_bucket:
                self._bin_bucket = want
                redo = True
            tb = getattr(self, "_touched_bucket",
                         self.cfg.max_touched_blocks)
            if tb < self.cfg.max_blocks:
                self._touched_bucket = min(tb * 2, self.cfg.max_blocks)
                redo = True
            if not redo:
                print("[DenseTSDF] sequence capacity miss at max buckets: "
                      f"dropped {dropped}")
        else:
            self._bin_bucket = want
        return redo

    # -- occupancy predicate (raycast, topo graph) ---------------------------
    def is_occupy_fn(self):
        """Predicate xyz (..., 3) -> bool over the active submap: TSDF below
        ``tsdf_surface_thres`` (unallocated voxels read 0, so they count as
        occupied)."""
        from taichislam_tpu_torch.ops.raycast import make_tsdf_occupancy_fn
        return make_tsdf_occupancy_fn(self.cfg, self.state,
                                      self.active_submap_id)

    # -- serialization --------------------------------------------------------
    def count_active(self):
        return int(host_read("tsdf.count_active", exports_ops.count_active(
            self.cfg, self.state, self.active_submap_id)))

    def to_numpy(self):
        cap = exports_ops.pow2_capacity(max(self.count_active(), 1))
        idx, tsdf, w, occ, col, kept, _ = exports_ops.sparse_gather(
            self.cfg, cap, self._export_block_bucket(), self.state,
            self.active_submap_id)
        k = int(host_read("tsdf.to_numpy", kept))

        def rows(t):
            return host_read("tsdf.to_numpy", t[:k]).numpy()
        col_np = rows(col) if self.enable_texture else np.array([])
        return rows(idx), rows(tsdf), rows(w), rows(occ), col_np

    def _submap_dict(self, indices, tsdf, w_tsdf, occupy, color):
        return {
            "indices": indices,
            "TSDF": tsdf,
            "W_TSDF": w_tsdf,
            "color": color if color.size else np.array([]),
            "occupy": occupy,
            "map_scale": [self.map_size_xy, self.map_size_z],
            "voxel_scale": self.voxel_scale,
            "texture_enabled": self.enable_texture,
            "num_voxel_per_blk_axis": self.num_voxel_per_blk_axis,
        }

    def export_submap(self):
        """The active submap's observed voxels as the submap wire dict
        (int16 indices, f16 TSDF / W_TSDF / color, int8 occupy)."""
        with profiling.span("submap.export") as sp:
            obj = self.start_export_submap()()
        print(f"Export submap {self.active_submap_id} to numpy, voxels "
              f"{len(obj['TSDF'])/1024:.1f}k, time: {sp.ms:.1f}ms")
        return obj

    def start_export_submap(self):
        """:meth:`export_submap` without the wait: the active submap's
        gather and its copy into a pinned host block are queued on the
        current stream. The gather is sized by the submap's observed voxels
        and allocated blocks, read first in one read: the submap's own
        blocks, not the whole collection's. Returns a function, callable
        from any thread, that waits for the copy and returns the submap
        dict. Work queued on the stream afterwards may reuse the gather's
        device memory: the copy runs before it."""
        sid = self.active_submap_id
        vox, blocks = (int(x) for x in host_read(
            "tsdf.count_active", torch.stack([
                exports_ops.count_active(self.cfg, self.state, sid),
                exports_ops.count_active_blocks(self.cfg, self.state, sid)])))
        cap = exports_ops.pow2_capacity(max(vox, 1))
        bcap = min(exports_ops.pow2_capacity(blocks + 1, lo=64),
                   self.cfg.max_blocks)
        buf = exports_ops.sparse_gather_packed(self.cfg, cap, bcap,
                                               self.state, sid)
        read = host_read_start("exports.sparse_buffer", buf)

        def finish():
            indices, tsdf, w_tsdf, occupy, color, _, _ = \
                exports_ops.unpack_sparse_delivery(read().numpy(), cap,
                                                   self.enable_texture)
            return self._submap_dict(indices, tsdf, w_tsdf, occupy, color)
        return finish

    def export_submap_async(self, lane_bucket, block_bucket, submap_id=None,
                            state=None):
        """Start the compact (bitmap) gather of a submap on the device and
        return its uint8 buffer without reading it. ``lane_bucket`` and
        ``block_bucket`` bound the submap's observed voxels and blocks; a
        truncation shows in the buffer's header. ``submap_id`` and
        ``state`` re-gather a finished submap. Decode with
        :meth:`finish_export_submap`."""
        sid = self.active_submap_id if submap_id is None else submap_id
        return exports_ops.bitmap_gather_packed(
            self.cfg, lane_bucket, block_bucket,
            self.state if state is None else state, sid)

    def finish_export_submap(self, buf, lane_bucket, block_bucket):
        """Decode an :meth:`export_submap_async` buffer into the submap dict
        of :meth:`export_submap`, plus the header counts
        (``kept_blocks``, ``total_blocks``, ``kept_vox``, ``total_vox``)."""
        indices, tsdf, w_tsdf, occupy, color, kept_b, total_b, kept_v, \
            total_v = exports_ops.unpack_bitmap_packed(
                buf, lane_bucket, block_bucket, self.cfg.grid.V,
                self.enable_texture)
        info = {"kept_blocks": kept_b, "total_blocks": total_b,
                "kept_vox": kept_v, "total_vox": total_v}
        return self._submap_dict(indices, tsdf, w_tsdf, occupy, color), info

    def input_remote_submap(self, submap):
        """Load a peer's submap dict into the next free slot from the top
        (remote submaps take descending slots); returns the slot."""
        self.remote_submap_num += 1
        idx = self.max_submap_num - self.remote_submap_num
        self.load_numpy(idx, submap["indices"], submap["TSDF"],
                        submap["W_TSDF"], submap["occupy"],
                        submap.get("color", np.array([])))
        R, T = submap["pose"]
        self.set_base_pose_submap(idx, R, T)
        return idx

    def load_numpy(self, submap_id, indices, tsdf, w_tsdf, occ, color):
        n = len(tsdf)
        cap = exports_ops.pow2_capacity(max(n, 1))

        def pad(a, tail=()):
            out = np.zeros((cap,) + tail, np.float32)
            if n:
                out[:n] = np.asarray(a, np.float32).reshape((n,) + tail)
            return self._tensor(out)

        idx = np.zeros((cap, 3), np.int32)
        idx[:n] = np.asarray(indices, np.int32)
        col = pad(color, (3,)) if (self.enable_texture and
                                   np.asarray(color).size) else \
            self._tensor(np.zeros((cap, 3), np.float32))
        self.state = exports_ops.sparse_scatter(
            self.cfg, self.state, submap_id, self._tensor(idx), pad(tsdf),
            pad(w_tsdf), pad(occ), col, n)
        self._mark_mesh_dirty_full()

    def saveMap(self, filename):
        np.save(filename, self.export_submap())

    @staticmethod
    def loadMap(filename, device=None):
        obj = np.load(filename, allow_pickle=True).item()
        mapping = DenseTSDF(
            map_scale=obj["map_scale"], voxel_scale=obj["voxel_scale"],
            texture_enabled=obj["texture_enabled"],
            num_voxel_per_blk_axis=obj["num_voxel_per_blk_axis"],
            is_global_map=True, device=device)
        mapping.load_numpy(0, obj["indices"], obj["TSDF"], obj["W_TSDF"],
                           obj["occupy"], obj["color"])
        print(f"[SubmapMapping] Loaded {len(obj['TSDF'])} voxels from "
              f"{filename}")
        return mapping

    # -- submap fusion --------------------------------------------------------
    def _reduce(self, submaps: "DenseTSDF", bcap: int, only_submap, slots,
                cap_limit: int):
        """Reduce until nothing drops: the touched capacity (global side)
        and the source block cap (by :func:`_block_cap`, up to
        ``cap_limit``) grow between attempts. The verdict is one host read
        per attempt, each attempt under the span ``fusion.reduce``;
        ``fusion/retries`` counts the attempts past the first. Returns
        (reduced, global cfg, bcap, attempts, sources dropped)."""
        touched_cap = getattr(self, "_fuse_touched_bucket",
                              self.cfg.max_touched_blocks)
        bases = self._bases()
        attempts = 0
        while True:
            attempts += 1
            red = None   # free the failed attempt's lanes first
            glob_cfg = dataclasses.replace(self.cfg,
                                           max_touched_blocks=touched_cap)
            with profiling.span("fusion.reduce"):
                red = fusion_ops.fuse_reduce(submaps.cfg, glob_cfg, bcap,
                                             submaps.state, *bases,
                                             only_submap, slots)
                tiles_over, src_over = (int(x) for x in host_read(
                    "tsdf.fuse_verdict", torch.stack(
                        [red.stats["fuse_tiles_dropped"],
                         red.stats["fuse_dropped"]])))
            if tiles_over > 0 and touched_cap < self.cfg.max_blocks:
                # target computed once: recomputing it per doubling never
                # terminates ((cap + over) * 1.1 > cap for all cap)
                target = (touched_cap + tiles_over) * 11 // 10
                while touched_cap < target:
                    touched_cap *= 2
                touched_cap = min(touched_cap, self.cfg.max_blocks)
                continue
            if src_over > 0 and bcap < cap_limit:
                bcap = _block_cap(bcap + src_over, cap_limit)
                continue
            break
        profiling.count("fusion/retries", attempts - 1)
        self._fuse_touched_bucket = touched_cap
        return red, glob_cfg, bcap, attempts, src_over

    def _fuse(self, submaps: "DenseTSDF", passes, only_submap, full):
        """Splat the sources of ``submaps`` (every submap, or only
        ``only_submap``) into this map in ``passes``, each a (block slots
        [lo, hi) or None for all, source block cap): a reduction settled
        before anything is written (``_reduce``), then the merge, under the
        span ``fusion.apply`` with the reset (``full``) before the first.
        The weighted merge is associative, so passes equal one pass over
        every slot within K1's summation rounding."""
        V3 = submaps.cfg.grid.voxels_per_block
        fuse = {"bcap": 0, "touched_cap": 0, "attempts": 0, "lanes": 0,
                "passes": len(passes)}
        for k, (slots, cap) in enumerate(passes):
            red, glob_cfg, cap, attempts, src_over = self._reduce(
                submaps, cap, only_submap, slots,
                submaps.cfg.max_blocks if slots is None
                else _FUSE_GROUP_BLOCKS)
            with profiling.span("fusion.apply"):
                if full and k == 0:
                    self.reset()
                self.state = fusion_ops.fuse_apply(glob_cfg, self.state, red)
            fuse["bcap"] = max(fuse["bcap"], cap)
            fuse["touched_cap"] = glob_cfg.max_touched_blocks
            fuse["attempts"] += attempts
            fuse["lanes"] += 7 * cap * V3
            if src_over > 0:
                print(f"[DenseTSDF] fuse sources dropped: {src_over} "
                      f"(block cap)")
        self._mark_mesh_dirty_full()
        self.last_stats = red.stats
        self.last_fuse = fuse

    @staticmethod
    def _refuse_passes(used: int, sub_max: int):
        """The passes of a full refuse over ``used`` allocated block slots:
        one up to ``_FUSE_GROUP_BLOCKS`` of them, else one per that many
        slots, so a pass's scratch is bounded whatever the collection's
        size."""
        G = _FUSE_GROUP_BLOCKS
        if used <= G:
            return [(None, _block_cap(used + 1, sub_max))]
        return [((lo, min(lo + G, used)), _block_cap(min(lo + G, used) - lo,
                                                     G))
                for lo in range(0, used, G)]

    def _collection_blocks(self, submaps: "DenseTSDF") -> int:
        """The allocated block count of ``submaps`` (one host read)."""
        return int(host_read("tsdf.collection_blocks",
                             submaps.state.num_blocks))

    def fuse_submaps(self, submaps: "DenseTSDF"):
        """Reset, then fuse every submap of ``submaps`` into this (global)
        map through THIS map's pose registry (the one PGO updates)."""
        with profiling.span("submap.refuse") as sp:
            used = self._collection_blocks(submaps)
            self._fuse(submaps, self._refuse_passes(
                used, submaps.cfg.max_blocks), None, True)
        print(f"[DenseTSDF] Fuse submaps {sp.ms:.1f}ms, "
              f"active local: {submaps.active_submap_id} "
              f"remote: {submaps.remote_submap_num} blocks: {used} "
              f"(cap {self.last_fuse['bcap']}, "
              f"{self.last_fuse['passes']} pass(es))")

    def fuse_submaps_incremental(self, submaps: "DenseTSDF", submap_id: int,
                                 sub_bcap=None, defer_verdict=False):
        """Splat ONE finished submap into this map without a reset. The
        weighted merge is associative, so fusing each submap once equals
        reset + refuse-all until PGO moves base poses (then the caller
        takes :meth:`fuse_submaps`). ``sub_bcap`` bounds the submap's own
        blocks (default: the first pass's cap of a full refuse of the
        collection). The capacity verdict is settled before this returns,
        also with ``defer_verdict=True``."""
        with profiling.span("submap.refuse") as sp:
            sub_max = submaps.cfg.max_blocks
            bcap = min(int(sub_bcap), sub_max) if sub_bcap is not None \
                else self._refuse_passes(self._collection_blocks(submaps),
                                         sub_max)[0][1]
            self._fuse(submaps, [(None, bcap)], int(submap_id), False)
        print(f"[DenseTSDF] Fuse submap {submap_id} incrementally "
              f"{sp.ms:.1f}ms")

    def resolve_deferred_fuse(self):
        """Nothing to settle: every fuse settles its verdict at once."""

    def reset(self):
        self.state = reset_grid(self.state)
        self._mark_mesh_dirty_full()

    def init_sphere(self):
        self.state = tsdf_ops.init_sphere(self.cfg, self.state,
                                          self.active_submap_id)
        self._mark_mesh_dirty_full()
