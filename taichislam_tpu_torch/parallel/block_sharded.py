"""Block-axis sharding: maps larger than one card's memory.

Counterpart of the JAX package's ``parallel/block_sharded.py``. The
voxel-channel tensors (the dominant memory, ``(max_blocks+1, V^3)``) are
split over the slot axis: rank ``r`` of an ``n``-rank mesh holds rows
``[r·nb/n, (r+1)·nb/n)``, while the block table, coordinates and counters
are replicated on every rank:

- allocation is a deterministic prefix sum over the replicated touched
  bitmap, so every rank assigns the same slots without communication;
- integration computes the (cheap) lane stream on every rank, and each
  rank reduces only the march lanes whose slot falls in its shard, through
  the sorted segmented reduction (K1, ``ops/kernels/seg_accum.py``) with
  f32 values and room for every row of the shard. Every channel updates:
  TSDF / W_TSDF / TSDF_observed (ray march), occupy (bin endpoints), and
  color when textured — the per-lane, last-writer-wins set of the JAX
  function, not the weighted mean of the single-device integrate;
- consumption (exports, meshing) runs on the surface working set:
  :func:`gather_surface_blocks` compacts the blocks that hold surface
  voxels (and their 26-neighbourhood) into a small replicated
  ``GridState`` with one sum over ranks, on which the single-device export
  and marching-cubes functions run unchanged.

Every function updates this rank's tensors in place where the
single-device ops do, and returns them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichislam_tpu_torch.core import geometry
from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            lookup_slots, scatter_max,
                                            voxel_to_block_c)
from taichislam_tpu_torch.core.geometry import fma, inv
from taichislam_tpu_torch.ops import tsdf as tsdf_ops
from taichislam_tpu_torch.ops.kernels.seg_accum import (
    SENTINEL_BLOCK, segmented_block_reduce)
from taichislam_tpu_torch.ops.marching_cubes import dilate_blocks
from taichislam_tpu_torch.ops.occupancy import set_last_lane
from taichislam_tpu_torch.parallel.mesh import Mesh

REPLICATED = "replicated"


def _shard_rows(nb: int, mesh: Mesh) -> int:
    """Slots a rank holds of ``nb``, which must divide the mesh."""
    if nb % mesh.size:
        raise ValueError(f"max_blocks+1 ({nb}) must divide the mesh size "
                         f"{mesh.size}: use max_blocks = k*{mesh.size} - 1")
    return nb // mesh.size


def state_sharding(mesh: Mesh, axis: str = "block") -> GridState:
    """Placement of a GridState's fields: channels split on the slot axis
    (named ``axis``; :func:`shard_state` fills them), bookkeeping
    replicated."""
    return GridState(table=REPLICATED, block_coords=REPLICATED,
                     block_active=REPLICATED, num_blocks=REPLICATED,
                     alloc_overflow=REPLICATED, channels={})


def shard_state(state: GridState, mesh: Mesh, axis: str = "block"
                ) -> GridState:
    """This rank's part of a full GridState, on the mesh's device: the
    bookkeeping copied, the channels' rows of this rank's slot range.
    Requires ``(max_blocks + 1) % mesh.size == 0``."""
    rows = _shard_rows(state.block_coords.shape[0], mesh)
    lo = mesh.rank * rows
    dev = mesh.device
    return GridState(
        table=state.table.to(dev, copy=True),
        block_coords=state.block_coords.to(dev, copy=True),
        block_active=state.block_active.to(dev, copy=True),
        num_blocks=state.num_blocks.to(dev, copy=True),
        alloc_overflow=state.alloc_overflow.to(dev, copy=True),
        channels={k: v[lo:lo + rows].to(dev, copy=True)
                  for k, v in state.channels.items()})


def unshard_state(state: GridState, mesh: Mesh) -> GridState:
    """The full GridState on every rank: the channels gathered over the
    mesh (tests and small maps; the full map has to fit one device)."""
    return state._replace(channels={k: mesh.all_gather(v)
                                    for k, v in state.channels.items()})


def sharded_integrate_depth(cfg: TSDFConfig, mesh: Mesh, axis: str = "block"):
    """The sharded integrate step with the signature of
    ``ops.tsdf.integrate_depth`` (minus stats):
    ``fn(state, depth, texture, R, T, K, Kc, active_submap) ->
    (state, touched)``, where ``state`` is this rank's sharded GridState
    (updated in place) and ``touched`` the replicated (max_blocks+1,) bool
    bitmap of the blocks whose TSDF changed this frame — the dirty set of
    the sharded incremental ESDF."""
    spec = cfg.grid
    nb = spec.max_blocks + 1
    shard_rows = _shard_rows(nb, mesh)
    V3 = spec.voxels_per_block
    rha = geometry.round_half_away
    inv_v = 1.0 / cfg.voxel_scale

    def vox(x):
        return rha(x * inv_v).to(torch.int32)

    def step(state, depth, texture, R, T, K, Kc, active_submap):
        s = int(active_submap)
        lo = mesh.rank * shard_rows
        (px, py, pz), dep, color, valid = tsdf_ops.depth_to_points_c(
            cfg, depth, texture, K, Kc)
        m0, m1, m2 = tsdf_ops._rotate(R, px, py, pz)
        bins = tsdf_ops.bin_points_c(cfg, m0, m1, m2, dep, color, valid)
        (x0, x1, x2), live, ds, wv, (e0, e1, e2), _ = \
            tsdf_ops._march_lattice_c(cfg, bins, T)
        blin_m, intra_m, inb_m = voxel_to_block_c(spec, s, vox(x0), vox(x1),
                                                  vox(x2))
        blin_e, intra_e, inb_e = voxel_to_block_c(spec, s, vox(e0), vox(e1),
                                                  vox(e2))
        mask = (live & inb_m).reshape(-1)
        mask_e = bins.valid & inb_e

        # replicated allocation from the same candidates on every rank
        state = allocate_blocks(spec, state,
                                torch.cat([blin_m.reshape(-1), blin_e]),
                                torch.cat([mask, mask_e]), s)
        slots = lookup_slots(spec, state.table, blin_m.reshape(-1))
        intra_f = intra_m.reshape(-1)
        # this rank's march lanes, keyed by their row in the shard
        mine = mask & (slots >= lo) & (slots < lo + shard_rows)
        zero = torch.zeros((), device=slots.device)
        wf = torch.where(mine, wv.reshape(-1), zero)
        wdf = wf * ds.reshape(-1)
        bkey = torch.where(mine, slots - lo,
                           torch.full_like(slots, SENTINEL_BLOCK))
        touched_rows, acc, n_touched, _ = segmented_block_reduce(
            bkey, torch.where(mine, intra_f, torch.zeros_like(intra_f)),
            (wf, wdf), V3, shard_rows, vals_f16=False, max_bkey=shard_rows,
            site="sharded")
        n_t = int(n_touched)
        rows = touched_rows[:n_t].long()
        w_sum, wd_sum = acc[:n_t, 0], acc[:n_t, 1]

        ch = state.channels
        D = ch["TSDF"][rows].float()
        W = ch["W_TSDF"][rows].float()
        touched_v = w_sum > 0
        ch["TSDF"][rows] = torch.where(
            touched_v, fma(D, W, wd_sum) / (W + w_sum), D).to(cfg.dtype)
        ch["W_TSDF"][rows] = torch.where(
            touched_v, torch.clamp(W + w_sum, max=cfg.w_max), W).to(cfg.dtype)
        ch["TSDF_observed"][rows] = torch.maximum(
            ch["TSDF_observed"][rows], touched_v.to(torch.int8))
        touched_local = torch.zeros((shard_rows,), dtype=torch.bool,
                                    device=slots.device)
        touched_local[rows] = touched_v.any(dim=1)
        touched = mesh.all_gather(touched_local)
        touched[-1] = False

        # endpoint occupancy on this rank's rows; the other lanes take the
        # int8 minimum, which leaves row 0 as it is
        slots_e = lookup_slots(spec, state.table, blin_e)
        mine_e = mask_e & (slots_e >= lo) & (slots_e < lo + shard_rows)
        flat_e = torch.where(mine_e, (slots_e - lo) * V3 + intra_e,
                             torch.zeros_like(slots_e))
        scatter_max(ch["occupy"], flat_e, torch.where(
            mine_e, torch.ones_like(flat_e, dtype=torch.int8),
            torch.full_like(flat_e, -128, dtype=torch.int8)))

        if cfg.texture_enabled:
            # per-lane color set, last lane wins (step-major lattice)
            c = torch.clamp(bins.count, min=1.0)
            bin_rgb = bins.sum_color / c[:, None] * inv(255.0)
            sel = torch.nonzero(mine).squeeze(1)
            b_of = sel % live.shape[1]
            set_last_lane(ch["color"], ((slots - lo) * V3 + intra_f)[sel],
                          torch.ones_like(sel, dtype=torch.bool),
                          [bin_rgb[b_of, a] for a in range(3)])

        # the global garbage row (the last rank's last row) stays clean
        if lo + shard_rows == nb:
            for v in ch.values():
                v[-1] = 0
        return state, touched

    return step


def surface_block_cfg(cfg: TSDFConfig, cap: int) -> TSDFConfig:
    """Config of the replicated surface-working-set mini map (same grid
    geometry and table, ``cap`` slots)."""
    return dataclasses.replace(cfg, max_blocks=cap)


def gather_surface_blocks(cfg: TSDFConfig, mesh: Mesh, cap: int,
                          axis: str = "block", dilate: bool = True):
    """The collective that compacts the blocks holding surface voxels
    (observed, ``|TSDF| < tsdf_surface_thres``) — with their
    26-neighbourhood when ``dilate`` (mesher halos sample neighbour blocks)
    — out of a slot-sharded map into a replicated GridState of capacity
    ``cap``: ``fn(state, active_submap) -> (mini, n_kept, overflow)``.
    The exports and marching cubes run on ``mini`` with
    ``surface_block_cfg(cfg, cap)``. Cost: one sum over ranks of
    ``(cap+1)`` rows per channel."""
    spec = cfg.grid
    nb = spec.max_blocks + 1
    shard_rows = _shard_rows(nb, mesh)
    thres = float(np.float32(cfg.tsdf_surface_thres))
    bps = spec.blocks_per_submap

    def local(state, active_submap):
        s = int(active_submap)
        lo = mesh.rank * shard_rows
        dev = state.table.device
        tsdf_l = state.channels["TSDF"].float()
        obs_l = state.channels["TSDF_observed"] > 0
        act = state.block_active[lo:lo + shard_rows] & \
            (state.block_coords[lo:lo + shard_rows, 0] == s)
        has_l = act & (obs_l & (tsdf_l.abs() < thres)).any(dim=1)
        has = mesh.all_gather(has_l)
        has[-1] = False
        keep = dilate_blocks(cfg, state, s, has) if dilate else has

        # global compaction: kept block -> mini slot (the same prefix sum
        # on every rank)
        pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
        n_kept = torch.clamp(pos[-1] + 1, min=0)
        ok = keep & (pos < cap)
        tgt = torch.where(ok, pos, torch.full_like(pos, cap)).long()

        # mini channels: every rank scatters its rows, one sum over ranks
        tgt_l = torch.where(ok[lo:lo + shard_rows], tgt[lo:lo + shard_rows],
                            cap + 1)
        ch_mini = {}
        for k, v in state.channels.items():
            mini = torch.zeros((cap + 2,) + tuple(v.shape[1:]),
                               dtype=v.dtype, device=dev)
            mini[tgt_l] = v
            ch_mini[k] = mesh.psum(mini[:cap + 1])

        # mini bookkeeping from the replicated originals
        inv_slot = torch.full((cap + 1,), nb - 1, dtype=torch.int32,
                              device=dev)
        inv_slot[tgt[ok]] = torch.nonzero(ok).squeeze(1).to(torch.int32)
        ar = torch.arange(cap + 1, device=dev)
        coords_mini = torch.where((ar < n_kept)[:, None],
                                  state.block_coords[inv_slot.long()], -1)
        active_mini = ar < n_kept
        active_mini[-1] = False
        c4 = state.block_coords
        blin = ((c4[:, 1] * spec.bn_xy + c4[:, 2]) * spec.bn_z + c4[:, 3] +
                c4[:, 0] * bps)
        table_mini = torch.full((spec.table_size + 1,), -1,
                                dtype=torch.int32, device=dev)
        table_mini[torch.where(ok, blin, spec.table_size).long()] = \
            torch.where(ok, pos, -1)
        overflow = torch.clamp(n_kept - cap, min=0)
        mini = GridState(
            table=table_mini[:spec.table_size].contiguous(),
            block_coords=coords_mini.to(torch.int32),
            block_active=active_mini,
            num_blocks=torch.clamp(n_kept, max=cap),
            alloc_overflow=overflow, channels=ch_mini)
        return mini, n_kept, overflow

    return local
