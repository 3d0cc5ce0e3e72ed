"""OctoMap-style hit-count occupancy on the block grid (PyTorch).

Counterpart of the JAX package's ``ops/occupancy.py``. Every endpoint adds 1 to
its voxel's count (the reference clears no free space). A voxel is occupied
when its count exceeds ``min_occupy_thres``. The export at LOD ``level``
keeps the voxels that lie on the stride-``K**level`` lattice. Submap
fusion adds each source voxel's count at the nearest global voxel.

Colors are written as a scatter-set. Where several lanes hit one voxel, the
JAX package's CPU scatter keeps the last lane. :func:`set_last_lane` makes
that rule explicit, so the card and the CPU agree: every lane of a run of
equal targets writes the value of the run's last lane. The arithmetic
follows the JAX functions as XLA compiles them: ``pts @ R.T + T`` is the
contracted chain ``fma(R2, z, fma(R1, y, R0·x)) + T``, and a division by a
constant is a multiply by its f32 reciprocal.

Every function updates the state's tensors IN PLACE and returns the state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from taichislam_tpu_torch.core import geometry
from taichislam_tpu_torch.core.colormap import color_from_colormap
from taichislam_tpu_torch.core.compaction import compact_sort
from taichislam_tpu_torch.core.config import OctomapConfig
from taichislam_tpu_torch.core.geometry import dot3, fma, inv
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            block_origin_voxel,
                                            flat_voxel_index, lookup_slots,
                                            make_grid_state, voxel_to_block_c)
from taichislam_tpu_torch.ops.exports import (_active_voxel_mask,
                                              _compact_blocks,
                                              _gathered_ijk_c,
                                              _gathered_xyz_c, _intra_offsets,
                                              pack_export)


def make_octomap_state(cfg: OctomapConfig, device=None) -> GridState:
    """Channels occupy (f32 counts) and, textured, color (nb, 3, V³); on
    the CUDA card unless ``device`` says otherwise."""
    defs = {"occupy": (torch.float32, ())}
    if cfg.texture_enabled:
        defs["color"] = (torch.float32, (3,))
    return make_grid_state(cfg.grid, defs, device=device)


def set_last_lane(channel: torch.Tensor, voxel: torch.Tensor,
                  ok: torch.Tensor, values) -> None:
    """``channel[slot, a, intra] = values[a][lane]`` for every lane with
    ``ok``, where ``voxel = slot * V³ + intra``; of lanes that share a
    voxel the last one wins. ``channel`` is (nb, 3, V³) and its garbage
    (last) row absorbs the other lanes; the caller zeroes it."""
    nb, C, V3 = channel.shape
    n = voxel.numel()
    dev = voxel.device
    big = torch.iinfo(torch.int64).max
    key, perm = torch.sort(torch.where(ok, voxel.long(),
                                       torch.full_like(voxel, big,
                                                       dtype=torch.int64)),
                           stable=True)
    pos = torch.arange(n, device=dev)
    last = torch.ones((n,), dtype=torch.bool, device=dev)
    last[:-1] = key[1:] != key[:-1]
    # the last position of each run of equal keys, for every position
    end = torch.where(last, pos, torch.full_like(pos, n))
    end = torch.flip(torch.cummin(torch.flip(end, [0]), 0).values, [0])
    src = perm[end]
    live = key != big
    slot = torch.div(key, V3, rounding_mode="floor")
    intra = key - slot * V3
    # dead lanes spread over the garbage row rather than one address
    spare = (nb - 1) * C * V3 + pos % (C * V3)
    flat = channel.view(-1)
    zero = torch.zeros((), dtype=flat.dtype, device=dev)
    for a in range(C):
        tgt = torch.where(live, (slot * C + a) * V3 + intra, spare)
        flat[tgt] = torch.where(live, values[a][src].to(flat.dtype), zero)


def _scatter_hits(cfg: OctomapConfig, state: GridState, pts, colors, valid,
                  active_submap: int) -> GridState:
    """``occupy += 1`` at the voxel of every valid point; ``pts`` are
    (x, y, z) component tensors; ``colors`` (P, 3) BGR in 0-255 or None."""
    spec = cfg.grid
    iv = inv(cfg.voxel_scale)
    ijk = [geometry.round_half_away(p * iv).to(torch.int32) for p in pts]
    s = int(active_submap)
    blin, intra, inb = voxel_to_block_c(spec, s, *ijk)
    ok = valid & inb
    state = allocate_blocks(spec, state, blin, ok, s)
    slots = lookup_slots(spec, state.table, blin)
    voxel = flat_voxel_index(spec, slots, intra)
    garbage = (spec.max_blocks + 1) * spec.voxels_per_block - 1
    ch = state.channels
    ch["occupy"].view(-1).index_add_(
        0, torch.where(ok, voxel, torch.full_like(voxel, garbage)).long(),
        ok.float())
    if cfg.texture_enabled and colors is not None:
        # BGR -> RGB and / 255
        c255 = inv(255.0)
        set_last_lane(ch["color"], voxel, ok,
                      [colors[:, 2 - a].float() * c255 for a in range(3)])
    for v in ch.values():
        v[-1] = 0
    return state


def _transform(R, T, x, y, z):
    """``pts @ R.T + T`` with XLA's contraction of the 3-term dot."""
    return tuple(fma(R[a, 2], z, fma(R[a, 1], y, R[a, 0] * x)) + T[a]
                 for a in range(3))


def integrate_pcl(cfg: OctomapConfig, state: GridState, xyz, rgb, R, T,
                  active_submap: int) -> GridState:
    """Points ``xyz`` (P, 3) moved by (R, T) add one hit each; no range
    gating (as the reference)."""
    xyz = xyz.float()
    pts = _transform(R, T, xyz[:, 0], xyz[:, 1], xyz[:, 2])
    valid = torch.ones(xyz.shape[:1], dtype=torch.bool, device=xyz.device)
    return _scatter_hits(cfg, state, pts, rgb, valid, active_submap)


def integrate_depth(cfg: OctomapConfig, state: GridState, depth_mm, texture,
                    R, T, K_dep, K_color, active_submap: int) -> GridState:
    """Strided unprojection of a depth frame (mm) with the min/max range
    gating, then one hit per endpoint."""
    h, w = depth_mm.shape
    step = cfg.recast_step
    jj, ii = geometry.pixel_grid(h, w, step, device=depth_mm.device)
    jj, ii = jj.reshape(-1), ii.reshape(-1)
    d_mm = geometry.strided_depth_f32(depth_mm, step)
    valid = (d_mm != 0) & (d_mm <= cfg.max_ray_length * 1000.0) & (
        d_mm >= cfg.min_ray_length * 1000.0)
    dep = d_mm * inv(1000.0)
    fx, cx, fy, cy = K_dep[0], K_dep[2], K_dep[4], K_dep[5]
    px = (ii.float() - cx) * dep / fx
    py = (jj.float() - cy) * dep / fy
    pts = _transform(R, T, px, py, dep)
    colors = None
    if cfg.texture_enabled:
        if cfg.color_same_proj:
            colors = texture[:(h // step) * step:step,
                             :(w // step) * step:step, :].reshape(-1, 3)
        else:
            th, tw = texture.shape[0], texture.shape[1]
            cj, ci = geometry.color_ind_from_depth_pt(
                ii.float(), jj.float(), K_dep, K_color, tw, th)
            colors = geometry.texture_at(texture, cj, ci)
        colors = colors.float()
    return _scatter_hits(cfg, state, pts, colors, valid, active_submap)


def occupy_export(cfg: OctomapConfig, capacity: int, level: int,
                  block_cap: int, state: GridState, base_R, base_T,
                  active_submap: int):
    """The active submap's voxels over the threshold at LOD ``level``:
    voxels on the stride-``K**level`` lattice (each coarse cell is
    represented by its corner voxel). Returns (x, y, z, color (capacity,
    3), kept), padded to ``capacity``."""
    spec = cfg.grid
    stride = cfg.K ** level
    nb = spec.max_blocks + 1
    dev = state.table.device
    pre_mask = _active_voxel_mask(spec, state, active_submap) & (
        state.channels["occupy"].reshape(nb, -1) > cfg.min_occupy_thres)
    if stride > 1:
        base = block_origin_voxel(spec, state.block_coords)
        off = _intra_offsets(spec.V, dev)
        for a in range(3):
            pre_mask = pre_mask & (
                (base[:, a:a + 1] + off[None, :, a]) % stride == 0)
    slot_of, bvalid, _, _ = _compact_blocks(spec, pre_mask, block_cap)
    coords, ijk_c = _gathered_ijk_c(spec, state, slot_of)
    x, y, z = _gathered_xyz_c(spec, coords, ijk_c, base_R, base_T,
                              cfg.is_global_map)
    sl = slot_of.long()
    mask = pre_mask[sl] & bvalid[:, None]
    ops = [x.reshape(-1), y.reshape(-1), z.reshape(-1)]
    fills = [-100000.0] * 3
    if cfg.texture_enabled:
        colg = state.channels["color"][sl]
        ops += [colg[:, a, :].reshape(-1) for a in range(3)]
        fills += [0.5, 0.5, 0.5]
    outs, kept, _ = compact_sort(mask.reshape(-1), capacity, ops, fills)
    if cfg.texture_enabled:
        col = torch.stack(outs[3:6], -1)
    else:
        col = color_from_colormap(outs[2], cfg.disp_floor, cfg.disp_ceiling)
        col = torch.where((torch.arange(capacity, device=dev) < kept)[:, None],
                          col, torch.full((), 0.5, device=dev))
    return outs[0], outs[1], outs[2], col, kept


def occupy_export_packed(cfg: OctomapConfig, capacity: int, level: int,
                         block_cap: int, state: GridState, base_R, base_T,
                         active_submap: int):
    """:func:`occupy_export` as one buffer (``exports.pack_export``: xyz,
    color, kept)."""
    x, y, z, col, kept = occupy_export(cfg, capacity, level, block_cap,
                                       state, base_R, base_T, active_submap)
    return pack_export((x, y, z), None, col, kept)


def fuse_submaps(sub_cfg: OctomapConfig, glob_cfg: OctomapConfig,
                 global_state: GridState, sub_state: GridState, base_R,
                 base_T, num_submaps: int,
                 only_submap: Optional[int] = None) -> GridState:
    """Add the count of every submap voxel over the threshold at the
    nearest global voxel, through the submap's base pose; colors are
    overwritten (last source lane wins). ``only_submap`` restricts the
    sources to one submap: counts add, so one splat per finished submap
    equals reset + refuse-all."""
    spec = sub_cfg.grid
    gspec = glob_cfg.grid
    dev = sub_state.table.device
    src_sub = sub_state.block_coords[:, 0]
    src_ok = sub_state.block_active & (src_sub >= 0) & (src_sub < num_submaps)
    if only_submap is not None:
        src_ok = src_ok & (src_sub == int(only_submap))
    src_ok[-1] = False
    # the source blocks in slot order (one host read): the lanes keep the
    # JAX function's order over the whole grid, without its empty rows
    rows = torch.nonzero(src_ok).squeeze(1)
    occ = sub_state.channels["occupy"][rows]            # (n, V³)
    mask = occ > sub_cfg.min_occupy_thres
    src_sub = src_sub[rows]

    base = block_origin_voxel(spec, sub_state.block_coords[rows])
    off = _intra_offsets(spec.V, dev)
    vs = float(np.float32(spec.voxel_scale))
    loc = [(base[:, a:a + 1] + off[None, :, a]).float() * vs
           for a in range(3)]
    s = torch.clamp(src_sub, 0, base_R.shape[0] - 1).long()
    R, T = base_R[s], base_T[s]
    ig = inv(glob_cfg.voxel_scale)
    gc = [geometry.round_half_away(
        (dot3(R[:, a, 0, None], loc[0], R[:, a, 1, None], loc[1],
              R[:, a, 2, None], loc[2]) + T[:, a, None]) * ig
    ).to(torch.int32) for a in range(3)]
    blin, intra, inb = voxel_to_block_c(gspec, 0, *gc)
    ok = (mask & inb).reshape(-1)
    blin, intra = blin.reshape(-1), intra.reshape(-1)
    global_state = allocate_blocks(gspec, global_state, blin, ok, 0)
    slots = lookup_slots(gspec, global_state.table, blin)
    voxel = flat_voxel_index(gspec, slots, intra)
    garbage = (gspec.max_blocks + 1) * gspec.voxels_per_block - 1
    ch = global_state.channels
    zero = torch.zeros((), device=dev)
    ch["occupy"].view(-1).index_add_(
        0, torch.where(ok, voxel, torch.full_like(voxel, garbage)).long(),
        torch.where(ok, occ.reshape(-1), zero))
    if sub_cfg.texture_enabled:
        src = sub_state.channels["color"][rows]
        set_last_lane(ch["color"], voxel, ok,
                      [src[:, a, :].reshape(-1) for a in range(3)])
    for v in ch.values():
        v[-1] = 0
    return global_state
