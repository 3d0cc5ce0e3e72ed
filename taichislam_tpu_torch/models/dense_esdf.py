"""DenseESDF: TSDF map with a per-frame incremental ESDF (block mode).

The interval-1 block path of ``taichislam_tpu.models.dense_esdf``: after
every recast, the frame's touched blocks are gated by
``esdf_seed_dirty`` and swept by ``esdf_update`` over the dirty blocks plus
the wavefront left pending by the previous update; a working-set overflow
grows the capacity bucket and redoes the update.

Not ported yet (ROADMAP.md, Queue A item 3 and item 4): the dirty-window
and dense-window ESDF modes (callers pass ``esdf_dense_max_voxels=0``) and
the deferred verdicts of ``esdf_check_interval > 1``. Asking for either
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
from taichislam_tpu_torch.ops import esdf as esdf_ops


class DenseESDF(DenseTSDF):
    def __init__(self, *args, enable_esdf=True, max_esdf_sweeps=64,
                 esdf_block_cap=None, esdf_incremental=True,
                 esdf_raise_slack_voxels=None, esdf_seed_eps_voxels=None,
                 esdf_dense_max_voxels=2 * 1024 * 1024,
                 esdf_check_interval=1, **kwargs):
        if esdf_dense_max_voxels:
            raise NotImplementedError(
                "window / dense ESDF modes are not ported yet (ROADMAP.md "
                "Queue A item 3); pass esdf_dense_max_voxels=0")
        if int(esdf_check_interval) > 1:
            raise NotImplementedError(
                "deferred ESDF verdicts (esdf_check_interval > 1) are not "
                "ported (ROADMAP.md Queue A item 4)")
        super().__init__(*args, **kwargs)
        self.esdf_dense_max_voxels = esdf_dense_max_voxels
        self.esdf_check_interval = 1
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
        self.last_esdf_dirty = -1   # -1: gating not engaged yet

    def recast_depth_to_map(self, R, T, depthmap, texture):
        super().recast_depth_to_map(R, T, depthmap, texture)
        if self.enable_esdf:
            self.update_esdf()

    def update_esdf(self):
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
                self.last_esdf_dirty = int(dirty.sum())
                if self.last_esdf_dirty == 0:
                    self.last_esdf_sweeps = 0
                    return
        if dirty is None and self.esdf_incremental:
            touched = self.last_stats.get("touched_blocks")
            if touched is not None:
                dirty = touched
                if self._esdf_pending is not None:
                    dirty = dirty | self._esdf_pending

        snap = {}
        if dirty is not None and self.cfg.esdf_seed_eps_voxels >= 0:
            snap = dict(tsdf_src=self._esdf_seen_tsdf,
                        obs_src=self._esdf_seen_obs)
        # block mode: the cap bucket tracks the allocated block count
        full_cap = 128
        while full_cap < int(self.state.num_blocks) + 1:
            full_cap *= 2
        full_cap = min(full_cap, self.esdf_block_cap)
        cap = min(self._esdf_cap_bucket if dirty is not None else full_cap,
                  full_cap)
        (self.esdf, self.esdf_fixed, self.esdf_observed, sweeps, changed,
         overflow) = esdf_ops.esdf_update(
            self.cfg, self.max_esdf_sweeps, cap, self.state, self.esdf,
            self.esdf_fixed, self.active_submap_id, dirty, **snap)
        self._esdf_pending = changed
        self._esdf_verdict(dirty, sweeps, overflow, cap, full_cap)

    def _esdf_verdict(self, dirty, sweeps, overflow, cap, full_cap):
        """One host read of the update's counts; on a working-set overflow
        grow the cap bucket, re-queue the dirty set and redo."""
        sweeps, overflow = (int(x) for x in torch.stack(
            [sweeps.to(torch.int32), overflow.to(torch.int32)]).cpu())
        self.last_esdf_sweeps = sweeps
        if overflow > 0:
            grown = cap
            while grown < cap + overflow:
                grown *= 2
            grown = min(grown, full_cap)
            self._esdf_cap_bucket = grown
            if dirty is not None:
                self._esdf_pending = self._esdf_pending | dirty
            if grown > cap:
                self.update_esdf()
