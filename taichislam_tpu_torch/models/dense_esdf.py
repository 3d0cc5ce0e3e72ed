"""DenseESDF: TSDF map with a per-frame incremental ESDF.

Counterpart of the JAX package's ``models/dense_esdf.py``. After every
recast the frame's touched blocks are gated by ``esdf_seed_dirty`` and the
ESDF is updated in one of three modes, chosen as the JAX model chooses:

- ``window``: the dirty blocks' bounding box plus a one-block frozen ring,
  swept densely (``esdf_update_dense`` with ``dirty_blocks``); the window
  dims grow from the span stats when dirty blocks do not fit;
- ``dense``: the observed bounding box swept densely, when the window mode
  is off (no dirty set, or the window outgrew ``esdf_dense_max_voxels``)
  and the box fits that budget;
- ``block``: the compacted block working set (``esdf_update``, kernels K3 /
  K2), when neither applies — ``esdf_dense_max_voxels`` is 0, or both the
  window and the observed box have outgrown it.

``esdf_check_interval`` sets how often the host reads the counts, as in
the JAX package. At 1 (the node's default) every frame takes its verdict
at once: a working-set overflow grows the mode's capacity, re-queues the
dirty set and redoes the update. Above 1, with gating on, a depth frame
takes the deferred path: integrate and the block-mode ESDF at a budget of
``min(max_esdf_sweeps, 6)`` through ``ops/sequence.integrate_esdf_sequence``
(one CUDA graph replay on the card), its stats folded on the device by
``accumulate_frame_verdict``, and one host read every interval frames
(``_frame_verdict``), which grows the buckets late and re-queues the
interval's touched blocks; ``esdf_observed`` is then refreshed lazily, by
the exports. ``update_esdf`` itself, when called with an interval above 1,
refreshes the host's mode info every interval, never skips a clean frame
and reads its accumulated counts every interval.

``recast_depth_sequence`` follows the JAX sequence: in the gated
block-incremental mode every frame of the window runs the block-mode ESDF
step at a budget of ``min(max_esdf_sweeps, 6)``, whatever mode the
per-frame path would take; otherwise the window is TSDF only, followed by
one ``update_esdf()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF, bin_bucket_for
from taichislam_tpu_torch.ops import esdf as esdf_ops
from taichislam_tpu_torch.ops import exports as exports_ops
from taichislam_tpu_torch.ops import sequence as seq_ops
from taichislam_tpu_torch.utils import profiling
from taichislam_tpu_torch.utils.profiling import host_read


def grow_cap(cap: int, overflow: int, limit: int) -> int:
    """The block cap doubled until it holds ``overflow`` more rows, at most
    ``limit``."""
    grown = cap
    while grown < cap + overflow:
        grown *= 2
    return min(grown, limit)


class DenseESDF(DenseTSDF):
    def __init__(self, *args, enable_esdf=True, max_esdf_sweeps=64,
                 esdf_block_cap=None, esdf_incremental=True,
                 esdf_raise_slack_voxels=None, esdf_seed_eps_voxels=None,
                 esdf_dense_max_voxels=2 * 1024 * 1024,
                 esdf_check_interval=1, **kwargs):
        super().__init__(*args, **kwargs)
        self.esdf_dense_max_voxels = esdf_dense_max_voxels
        if esdf_raise_slack_voxels is not None:
            self.cfg = dataclasses.replace(
                self.cfg, esdf_raise_slack_voxels=esdf_raise_slack_voxels)
        if esdf_seed_eps_voxels is not None:
            self.cfg = dataclasses.replace(
                self.cfg, esdf_seed_eps_voxels=esdf_seed_eps_voxels)
        self.enable_esdf = enable_esdf
        self.max_esdf_sweeps = max_esdf_sweeps
        self.esdf_block_cap = esdf_block_cap or min(2048, self.cfg.max_blocks)
        self.esdf_incremental = esdf_incremental
        # blocks whose values changed last update: wavefronts that reached
        # the working-set edge continue from here next frame
        self._esdf_pending = None
        self._esdf_cap_bucket = 64
        # host reads: capacity verdicts and mode refreshes every N frames
        # (1: every frame, the exact interactive semantics; above 1 an
        # overflow is found up to N frames late and recovered by
        # re-queueing the interval's dirty union)
        self.esdf_check_interval = max(1, int(esdf_check_interval))
        self._esdf_frame = 0
        self._esdf_host_ready = False
        self._esdf_dims_cached = None
        self._esdf_nblocks_cached = 1
        self._esdf_last_mode = "block"
        self._esdf_last_cap = (64, 64)
        self._esdf_pack = None
        self._esdf_dirty_union = None
        # the deferred per-frame path's interval accumulators
        self._frame_pack = None
        self._frame_union = None
        self._esdf_obs_stale = False
        # dirty-window dims in blocks, grown from the span stats
        self._esdf_win_dims = (4, 4, 4)
        self._esdf_win_ok = True
        spec = self.cfg.grid
        shape = (spec.max_blocks + 1, spec.voxels_per_block)
        dev = self.device
        # updated-voxel gating snapshots (ops/esdf.py esdf_seed_dirty)
        self._esdf_seen_tsdf = torch.zeros(shape, device=dev)
        self._esdf_seen_obs = torch.zeros(shape, dtype=torch.bool, device=dev)
        self.esdf = torch.zeros(shape, device=dev)
        self.esdf_fixed = torch.zeros(shape, dtype=torch.int8, device=dev)
        self.esdf_observed = torch.zeros(shape, dtype=torch.bool, device=dev)
        self.last_esdf_sweeps = 0
        self._esdf_sweeps = None    # the last update's sweeps, on the device
        self.last_esdf_dirty = -1   # -1: gating not engaged yet
        self.num_export_ESDF_particles = 0
        self.export_ESDF = np.zeros((0,), np.float32)
        self.export_ESDF_xyz = np.zeros((0, 3), np.float32)

    def _gated(self):
        return (self.enable_esdf and self.esdf_incremental and
                self.cfg.esdf_seed_eps_voxels >= 0)

    def _trace_scalars(self):
        """DenseTSDF's, the last update's sweeps and the pending blocks
        (device tensors)."""
        out = super()._trace_scalars()
        if self._esdf_sweeps is not None:
            out["esdf_sweeps"] = self._esdf_sweeps
        if self._esdf_pending is not None:
            out["esdf_pending"] = self._esdf_pending.sum()
        return out

    def _pending_or_zeros(self):
        """The pending bitmap, created empty on first use (the sequences
        update it in place)."""
        if self._esdf_pending is None:
            self._esdf_pending = torch.zeros(
                (self.cfg.grid.max_blocks + 1,), dtype=torch.bool,
                device=self.device)
        return self._esdf_pending

    # -- ingestion hooks: update the ESDF after every TSDF update ------------
    def recast_depth_to_map(self, R, T, depthmap, texture):
        if self._gated() and self.esdf_check_interval > 1:
            self._recast_depth_frame_deferred(R, T, depthmap, texture)
            return
        super().recast_depth_to_map(R, T, depthmap, texture)
        if self.enable_esdf:
            self.update_esdf()

    def _recast_depth_frame_deferred(self, R, T, depthmap, texture):
        """One frame of ``recast_depth_to_map`` + gated ``update_esdf`` in
        the deferred mode: the sequence with F = 1 (one graph replay on the
        card), its stats folded into the interval accumulators on the
        device, and ``_frame_verdict`` every ``esdf_check_interval``
        frames. Integrate-side drops are corrected at that check, as
        ``_update_bin_bucket``'s interval corrects them."""
        R_c, T_c, tex, K, Kc = self._sequence_inputs(
            [R], [T], None if texture is None else [texture])
        (self.state, self.esdf, self.esdf_fixed, self._esdf_pending,
         self._esdf_seen_tsdf, self._esdf_seen_obs,
         stats) = seq_ops.integrate_esdf_sequence(
            self._sequence_cfg(), min(self.max_esdf_sweeps, 6),
            self._esdf_cap_bucket, self.state, self.esdf, self.esdf_fixed,
            self._pending_or_zeros(), self._esdf_seen_tsdf,
            self._esdf_seen_obs, [depthmap], tex, R_c, T_c, K, Kc,
            self.active_submap_id)
        self.last_stats = stats
        self._mark_mesh_dirty(stats["touched_blocks"])
        self._esdf_obs_stale = True
        if self._frame_pack is None:
            self._frame_pack = torch.zeros((4,), dtype=torch.int32,
                                           device=self.device)
            self._frame_union = torch.zeros_like(self._esdf_pending)
        self._frame_pack, self._frame_union = \
            seq_ops.accumulate_frame_verdict(self._frame_pack,
                                             self._frame_union, stats)
        self._esdf_frame += 1
        if self._esdf_frame % self.esdf_check_interval == 0:
            self._frame_verdict()

    def _frame_verdict(self):
        """Act on the interval's accumulated maxima (one host read): grow
        the bin, touched and ESDF-cap buckets, and re-queue the interval's
        touched blocks after an ESDF overflow."""
        bins_total, dropped, _live, esdf_ov = host_read(
            "esdf.frame_verdict", self._frame_pack).tolist()
        union = self._frame_union
        self._frame_pack = None
        self._frame_union = None
        if dropped > 0:
            want = min(bin_bucket_for(bins_total), self.cfg.max_bins)
            if want > self._bin_bucket:
                self._bin_bucket = want
            tb = getattr(self, "_touched_bucket",
                         self.cfg.max_touched_blocks)
            if tb < self.cfg.max_blocks:
                self._touched_bucket = min(tb * 2, self.cfg.max_blocks)
        else:
            self._bin_bucket = min(bin_bucket_for(bins_total),
                                   self.cfg.max_bins)
        if esdf_ov > 0:
            self._esdf_cap_bucket = grow_cap(
                self._esdf_cap_bucket, esdf_ov, self.esdf_block_cap)
            # dropped blocks' dirtiness recovers on the next frames
            self._pending_or_zeros().logical_or_(union)

    def _refresh_esdf_observed(self):
        """The exports' observed mask, refreshed lazily after deferred
        frames."""
        if not self._esdf_obs_stale:
            return
        self.esdf_observed.copy_(self._observed_mask())
        self._esdf_obs_stale = False

    def _observed_mask(self):
        st = self.state
        blk = st.block_active & (st.block_coords[:, 0] ==
                                 self.active_submap_id)
        blk[-1] = False
        return (st.channels["TSDF_observed"] > 0) & blk[:, None]

    def recast_pcl_to_map(self, R, T, xyz_array, rgb_array):
        super().recast_pcl_to_map(R, T, xyz_array, rgb_array)
        if self.enable_esdf:
            self.update_esdf()

    # -- multi-frame ingest ---------------------------------------------------
    def recast_depth_sequence(self, Rs, Ts, depthmaps, textures=None):
        """A window of frames with the JAX sequence's ESDF semantics: in
        the gated block-incremental mode ``ops/sequence.
        integrate_esdf_sequence`` (per frame ``esdf_seed_dirty``, the
        pending wavefront, and ``esdf_update`` in block mode at budget
        ``min(max_esdf_sweeps, 6)`` and the block-cap bucket; one graph
        replay per frame on the card), with one capacity verdict for the
        window (an ESDF overflow grows the bucket and redoes the window);
        otherwise the TSDF window and then one ``update_esdf()``."""
        if not self._gated():
            super().recast_depth_sequence(Rs, Ts, depthmaps, textures)
            if self.enable_esdf:
                self.update_esdf()
            return
        self._pending_or_zeros()
        if not self._esdf_host_ready:
            self._esdf_host_refresh()
        self._recast_window(Rs, Ts, depthmaps, textures,
                            esdf_budget=min(self.max_esdf_sweeps, 6))
        self.esdf_observed.copy_(self._observed_mask())
        self._esdf_frame += len(depthmaps)

    def _window_entry(self, esdf):
        entry = super()._window_entry(esdf)
        if not esdf:
            return entry
        return {"grid": entry, "esdf": tuple(t.clone() for t in (
            self.esdf, self.esdf_fixed, self._esdf_pending,
            self._esdf_seen_tsdf, self._esdf_seen_obs))}

    def _window_restore(self, entry):
        if not isinstance(entry, dict):
            return super()._window_restore(entry)
        super()._window_restore(entry["grid"])
        for live, saved in zip((self.esdf, self.esdf_fixed,
                                self._esdf_pending, self._esdf_seen_tsdf,
                                self._esdf_seen_obs), entry["esdf"]):
            live.copy_(saved)

    def _window_pass(self, cfg, inputs, depthmaps, esdf_budget):
        if esdf_budget is None:
            return super()._window_pass(cfg, inputs, depthmaps, None)
        R_c, T_c, tex, K, Kc = inputs
        (self.state, self.esdf, self.esdf_fixed, self._esdf_pending,
         self._esdf_seen_tsdf, self._esdf_seen_obs,
         stats) = seq_ops.integrate_esdf_sequence(
            cfg, esdf_budget, self._esdf_cap_bucket, self.state, self.esdf,
            self.esdf_fixed, self._esdf_pending, self._esdf_seen_tsdf,
            self._esdf_seen_obs, depthmaps, tex, R_c, T_c, K, Kc,
            self.active_submap_id)
        return stats

    def _sequence_verdict(self, stats):
        redo = super()._sequence_verdict(stats)
        if self._verdict_extra and self._verdict_extra[0] > 0:
            ov = self._verdict_extra[0]
            cap = self._esdf_cap_bucket
            grown = grow_cap(cap, ov, self.esdf_block_cap)
            if grown > cap:
                self._esdf_cap_bucket = grown
                redo = True
            else:
                print("[DenseESDF] sequence ESDF working set over "
                      f"esdf_block_cap by {ov}")
        return redo

    # -- mode and capacity info -----------------------------------------------
    def _window_info_dev(self):
        """(8,) int32 on the device: the active submap's block-coordinate
        mins and maxs, an any-active flag and the allocated block count."""
        c4 = self.state.block_coords
        act = self.state.block_active & (c4[:, 0] == self.active_submap_id)
        act[-1] = False
        huge = 1 << 20
        sel = c4[:, 1:4]
        mins = torch.where(act[:, None], sel, huge).amin(dim=0)
        maxs = torch.where(act[:, None], sel, -huge).amax(dim=0)
        return torch.cat([mins, maxs, act.any().to(torch.int32)[None],
                          self.state.num_blocks.to(torch.int32)[None]])

    def _dense_window_dims(self, info):
        """Power-of-two (DBX, DBY, DBZ) block dims of the active submap's
        bounding box, or None when that window exceeds
        ``esdf_dense_max_voxels``."""
        if int(info[6]) == 0:
            return None
        spans = info[3:6] - info[0:3] + 1

        def bucket(n):
            b = 1
            while b < n:
                b *= 2
            return b
        dims = tuple(int(bucket(s)) for s in spans)
        V3 = self.cfg.grid.voxels_per_block
        if dims[0] * dims[1] * dims[2] * V3 > self.esdf_dense_max_voxels:
            return None
        return dims

    @staticmethod
    def _win_bucket(n):
        """Window-dimension bucket in blocks (~1.5x steps)."""
        for b in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64):
            if n <= b:
                return b
        return int(n)

    def _esdf_host_refresh(self):
        """Refresh the host's mode and capacity info (one host read)."""
        info = host_read("esdf.window_info", self._window_info_dev()).numpy()
        self._esdf_dims_cached = self._dense_window_dims(info)
        self._esdf_nblocks_cached = int(info[7]) + 1
        self._esdf_host_ready = True

    # -- the update -----------------------------------------------------------
    def update_esdf(self):
        with profiling.span("node.esdf"):
            self._update_esdf()

    def _update_esdf(self):
        sid = self.active_submap_id
        interactive = self.esdf_check_interval <= 1
        # updated-voxel gating: of the frame's touched blocks only those
        # whose seeds moved materially re-enter the working set; in the
        # interactive mode a frame with nothing dirty (and no pending
        # wavefront) costs no sweep. The deferred mode skips nothing: the
        # skip would need a host read, and a clean set converges in one
        # sweep.
        dirty = None
        if self.esdf_incremental and self.cfg.esdf_seed_eps_voxels >= 0:
            touched = self.last_stats.get("touched_blocks")
            if touched is not None:
                dirty, self._esdf_seen_tsdf, self._esdf_seen_obs = \
                    esdf_ops.esdf_seed_dirty(
                        self.cfg, self.state, self._esdf_seen_tsdf,
                        self._esdf_seen_obs, touched)
                if self._esdf_pending is not None:
                    dirty = dirty | self._esdf_pending
                if interactive:
                    self.last_esdf_dirty = int(host_read("esdf.dirty_count",
                                                         dirty.sum()))
                    if self.last_esdf_dirty == 0:
                        self.last_esdf_sweeps = 0
                        self._esdf_sweeps = None
                        return
        if dirty is None and self.esdf_incremental:
            touched = self.last_stats.get("touched_blocks")
            if touched is not None:
                dirty = touched
                if self._esdf_pending is not None:
                    dirty = dirty | self._esdf_pending

        # the host's mode and capacity info, refreshed every check interval
        # (a stale window overflows, which the verdict catches)
        if not self._esdf_host_ready or \
                self._esdf_frame % self.esdf_check_interval == 0:
            self._esdf_host_refresh()
        dims = self._esdf_dims_cached
        # consume-once snapshot seeds when gating is on
        snap = {}
        if dirty is not None and self.cfg.esdf_seed_eps_voxels >= 0:
            snap = dict(tsdf_src=self._esdf_seen_tsdf,
                        obs_src=self._esdf_seen_obs)

        spans = torch.zeros((3,), dtype=torch.int32, device=self.device)
        if dirty is not None and self._esdf_win_ok and \
                self.esdf_dense_max_voxels:
            self._esdf_last_mode = "window"
            (esdf, fixed, observed, sweeps, changed,
             overflow) = esdf_ops.esdf_update_dense(
                self.cfg, self.max_esdf_sweeps, self._esdf_win_dims,
                self.state, self.esdf, self.esdf_fixed, sid,
                dirty_blocks=dirty, **snap)
            self._write_esdf(esdf, fixed, observed)
            c4 = self.state.block_coords
            anchor = dirty & self.state.block_active & (c4[:, 0] == sid)
            anchor[-1] = False
            huge = 1 << 20
            mins = torch.where(anchor[:, None], c4[:, 1:4], huge).amin(0)
            maxs = torch.where(anchor[:, None], c4[:, 1:4], -huge).amax(0)
            spans = torch.clamp(maxs - mins + 1, min=0)
        elif dims is not None:
            self._esdf_last_mode = "dense"
            (esdf, fixed, observed, sweeps, changed,
             overflow) = esdf_ops.esdf_update_dense(
                self.cfg, self.max_esdf_sweeps, dims, self.state,
                self.esdf, self.esdf_fixed, sid)
            self._write_esdf(esdf, fixed, observed)
        else:
            full_cap = 128
            while full_cap < self._esdf_nblocks_cached:
                full_cap *= 2
            full_cap = min(full_cap, self.esdf_block_cap)
            cap = min(self._esdf_cap_bucket if dirty is not None
                      else full_cap, full_cap)
            self._esdf_last_mode = "block"
            self._esdf_last_cap = (cap, full_cap)
            # esdf and fixed are written in place
            (_, _, observed, sweeps, changed,
             overflow) = esdf_ops.esdf_update(
                self.cfg, self.max_esdf_sweeps, cap, self.state,
                self.esdf, self.esdf_fixed, sid, dirty, **snap)
            self.esdf_observed.copy_(observed)
        # written in place: the deferred sequences' graphs hold the tensor
        self._pending_or_zeros().copy_(changed)
        self._esdf_sweeps = sweeps
        i32 = torch.int32
        pack = torch.cat([torch.stack([
            sweeps.to(i32), overflow.to(i32),
            (dirty.sum(dtype=i32) if dirty is not None
             else torch.full((), -1, dtype=i32, device=self.device))]),
            spans.to(i32)])
        # accumulated over the check interval on the device: overflow and
        # the spans are running maxima, so a mid-interval overflow still
        # reaches the verdict
        self._esdf_pack = pack if self._esdf_pack is None else torch.cat(
            [pack[:1], torch.maximum(self._esdf_pack[1:], pack[1:])])
        # the dirty sets since the last verdict re-queue after a late
        # overflow
        if dirty is not None:
            self._esdf_dirty_union = dirty if self._esdf_dirty_union is None \
                else (self._esdf_dirty_union | dirty)
        self._esdf_frame += 1
        if interactive or self._esdf_frame % self.esdf_check_interval == 0:
            self._esdf_verdict()

    def _write_esdf(self, esdf, fixed, observed):
        """Write a dense update's field, fixed flags and observed mask into
        the model's tensors in place: the graphs of the units that read or
        write them (the deferred sequences' included) are keyed on their
        addresses."""
        self.esdf.copy_(esdf)
        self.esdf_fixed.copy_(fixed)
        self.esdf_observed.copy_(observed)

    def _esdf_verdict(self):
        """One host read of the accumulated counts. On a working-set
        overflow: grow the window (or give it up for block mode), refresh
        the dense window, or grow the block cap; re-queue the dirty union,
        and in the interactive mode redo when the capacity grew."""
        sweeps, overflow, ndirty, sx, sy, sz = host_read(
            "esdf.verdict", self._esdf_pack).tolist()
        self._esdf_pack = None
        self.last_esdf_sweeps = sweeps
        if ndirty >= 0:
            self.last_esdf_dirty = ndirty
        if overflow > 0:
            if self._esdf_last_mode == "window":
                # the observed span plus the ring on each side; past the
                # dense budget the window gives way to block mode
                want = tuple(self._win_bucket(s + 2) for s in (sx, sy, sz))
                V3 = self.cfg.grid.voxels_per_block
                grew = True
                if want[0] * want[1] * want[2] * V3 > \
                        self.esdf_dense_max_voxels:
                    self._esdf_win_ok = False
                elif want != self._esdf_win_dims:
                    self._esdf_win_dims = tuple(
                        max(a, b) for a, b in zip(want, self._esdf_win_dims))
                else:
                    grew = False
            elif self._esdf_last_mode == "dense":
                old = self._esdf_dims_cached
                self._esdf_host_refresh()
                grew = self._esdf_dims_cached != old
            else:
                cap, full_cap = self._esdf_last_cap
                grown = grow_cap(cap, overflow, full_cap)
                grew = grown > cap
                self._esdf_cap_bucket = grown
            if self._esdf_dirty_union is not None:
                self._esdf_pending.logical_or_(self._esdf_dirty_union)
            if self.esdf_check_interval <= 1 and grew:
                self._esdf_dirty_union = None
                self._update_esdf()
                return
        self._esdf_dirty_union = None

    # -- exports --------------------------------------------------------------
    def cvt_ESDF_to_voxels_slice(self, z, dz=0.5):
        self._refresh_esdf_observed()
        buf = esdf_ops.esdf_slice_export_packed(
            self.cfg, self.max_disp_particles, self._export_block_bucket(),
            self.state, self.esdf, self.esdf_observed, *self._bases(),
            self.active_submap_id, z, dz)
        (self.export_ESDF_xyz, self.export_ESDF, self.export_color,
         self.num_export_ESDF_particles) = exports_ops.unpack_export(
            buf, self.max_disp_particles, True, "export.esdf_slice_packed")

    def get_voxels_ESDF_slice(self, z):
        self.cvt_ESDF_to_voxels_slice(z)
        return self.export_ESDF_xyz, self.export_ESDF

    def get_esdf_dict(self):
        """Debug/test helper: dict voxel-tuple -> esdf over observed voxels."""
        self._refresh_esdf_observed()
        from taichislam_tpu_torch.ops.exports import voxel_ijk_all
        ijk = voxel_ijk_all(self.cfg.grid, self.state).reshape(-1, 3)
        mask = self.esdf_observed.reshape(-1)
        ijk = host_read("esdf.dict", ijk[mask]).numpy()
        esdf = host_read("esdf.dict", self.esdf.reshape(-1)[mask]).numpy()
        return {tuple(i): e for i, e in zip(ijk, esdf)}
