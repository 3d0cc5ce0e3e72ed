"""Voxblox-style TSDF integration, untextured and textured, on PyTorch tensors.

Counterpart of the JAX package's ``ops/tsdf.py``: bin the frame's points by
sensor-local voxel, march a dense (steps, bins) lattice from the sensor
through each bin's mean point, sum Σw and Σw·d (and, textured, Σw·c per
color component) per voxel with the sorted segmented reduction (K1,
``ops/kernels/seg_accum.py``), and combine with the weighted-average rule.
The arithmetic follows the JAX functions op by op, so voxel rounding agrees
(see ``core/geometry.py`` for the rounding rules).

Kept on purpose: ``w_x_p`` receives the unsigned distance (the reference's
quirk); march values are rounded to f16 in pairs before accumulation (the
JAX path's ``vals_f16``; an odd last value stays f32), because both change
results; and the texture combines as the per-frame weighted mean of the
JAX package's kernel path, not the last-writer scatter of its XLA path.

``integrate``, ``integrate_depth``, ``integrate_pcl`` and ``init_sphere``
update the state's tensors IN PLACE and return the state (and stats). On
the card ``integrate_depth`` and ``integrate_pcl`` are units of
``ops/graphs.py``: one CUDA graph replay per call (the JAX package's jitted
functions); their ``*_ref`` twins are the eager bodies, which CPU tensors
take.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from taichislam_tpu_torch.core import geometry
from taichislam_tpu_torch.core.colormap import color_from_colormap
from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.geometry import dot3, fma, inv, sqrt_rn
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            comp_flat_index,
                                            flat_voxel_index, lookup_slots,
                                            make_grid_state, scatter_max,
                                            voxel_to_block_c)
from taichislam_tpu_torch.ops import graphs
from taichislam_tpu_torch.ops.kernels.seg_accum import (
    SENTINEL_BLOCK, segmented_block_reduce)


TSDF_CHANNELS = ("TSDF", "W_TSDF", "TSDF_observed", "occupy")


def make_tsdf_state(cfg: TSDFConfig, device=None) -> GridState:
    """Channels TSDF, W_TSDF, TSDF_observed, occupy and, textured, a
    (nb, 3, V³) color channel; on the CUDA card unless ``device`` says
    otherwise."""
    dt = cfg.dtype
    defs = {"TSDF": (dt, ()), "W_TSDF": (dt, ()),
            "TSDF_observed": (torch.int8, ()), "occupy": (torch.int8, ())}
    if cfg.texture_enabled:
        defs["color"] = (dt, (3,))
    return make_grid_state(cfg.grid, defs, device=device)


def w_x_p(cfg: TSDFConfig, d, z):
    """Voxblox linear-drop-off weight: ``1/z²`` for d > -ε, a linear ramp
    on (-θ, -ε], 0 behind (ε = voxel, θ = 4·voxel). Called with the
    unsigned distance, so only the first branch is live."""
    epi = cfg.voxel_scale
    theta = cfg.voxel_scale * 4.0
    inv_z2 = 1.0 / (z * z)
    ramp = (d + theta) * inv_z2 * inv(theta - epi)
    zero = torch.zeros_like(inv_z2)
    return torch.where(d > -epi, inv_z2,
                       torch.where(d > -theta, ramp, zero))


def depth_to_points_c(cfg: TSDFConfig, depth_mm: torch.Tensor,
                      texture: Optional[torch.Tensor], K_dep: torch.Tensor,
                      K_color: Optional[torch.Tensor]):
    """Strided unprojection with the reference's gating. Returns
    ((x, y, z_cam), z, color (P, 3) f32 or None, valid), vectors (P,)."""
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
    color = None
    if cfg.texture_enabled:
        if cfg.color_same_proj:
            color = texture[:(h // step) * step:step,
                            :(w // step) * step:step, :].reshape(
                -1, 3).float()
        else:
            th, tw = texture.shape[0], texture.shape[1]
            cj, ci = geometry.color_ind_from_depth_pt(
                ii.float(), jj.float(), K_dep, K_color, tw, th)
            color = geometry.texture_at(texture, cj, ci)
    return (px, py, dep), dep, color, valid


def depth_to_points(cfg: TSDFConfig, depth_mm, texture, K_dep, K_color):
    """Stacked-points form of :func:`depth_to_points_c`: (pts_cam (P, 3),
    z (P,), color (P, 3) or None, valid (P,))."""
    (px, py, pz), dep, color, valid = depth_to_points_c(
        cfg, depth_mm, texture, K_dep, K_color)
    return torch.stack([px, py, pz], dim=-1), dep, color, valid


def pcl_to_points(cfg: TSDFConfig, xyz_array: torch.Tensor,
                  rgb_array: torch.Tensor):
    """Point-cloud input: f32 points, and f32 colors when textured."""
    return xyz_array.float(), (rgb_array.float() if cfg.texture_enabled
                               else None)


class Bins(NamedTuple):
    count: torch.Tensor      # (max_bins,) f32
    sum_pos: torch.Tensor    # (max_bins, 3) f32, sensor-centric positions
    sum_z: torch.Tensor      # (max_bins,) f32
    sum_color: torch.Tensor  # (max_bins, 3) f32 (zeros when untextured)
    valid: torch.Tensor      # (max_bins,) bool
    dropped: torch.Tensor    # 0-d int32, bins beyond max_bins


def bin_points_c(cfg: TSDFConfig, px, py, pz, z, color, valid) -> Bins:
    """Deduplicate rays by sensor-local voxel: a stable sort by bin id,
    then per-bin sums through K1 (one "block" of V³ = max_bins, intra =
    bin rank, presorted): count, position, depth and, textured, the three
    color sums (8 values)."""
    r = int(math.ceil(cfg.max_ray_length / cfg.voxel_scale)) + 1
    G = 2 * r + 1
    iv = inv(cfg.voxel_scale)
    rha = geometry.round_half_away
    vi = rha(px * iv).to(torch.int32)
    vj = rha(py * iv).to(torch.int32)
    vk = rha(pz * iv).to(torch.int32)
    inb = (vi.abs() <= r) & (vj.abs() <= r) & (vk.abs() <= r) & valid
    bin_id = ((vi + r) * G + (vj + r)) * G + (vk + r)
    bin_id = torch.where(inb, bin_id, torch.full_like(bin_id, G * G * G))

    bid, perm = torch.sort(bin_id, stable=True)
    ok = bid < G * G * G
    head = ok & torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=bid.device),
                           bid[1:] != bid[:-1]])
    rank = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    total_bins = torch.clamp(rank[-1] + 1, min=0)

    B = cfg.max_bins
    lane_ok = ok & (rank < B)
    bkeyz = torch.where(lane_ok, torch.zeros_like(rank),
                        torch.full_like(rank, SENTINEL_BLOCK))
    intra = torch.where(lane_ok, rank, torch.zeros_like(rank))
    textured = cfg.texture_enabled and color is not None
    vals = (ok.float(), px[perm], py[perm], pz[perm], z[perm])
    if textured:
        col = color[perm]
        vals = vals + (col[:, 0], col[:, 1], col[:, 2])
    _, acc, _, _ = segmented_block_reduce(bkeyz, intra, vals, B, 1,
                                          presorted=True, site="bins")
    count = acc[0, 0]
    sum_color = (torch.stack([acc[0, 5], acc[0, 6], acc[0, 7]], -1)
                 if textured else torch.zeros((B, 3), device=acc.device))
    return Bins(count=count,
                sum_pos=torch.stack([acc[0, 1], acc[0, 2], acc[0, 3]], -1),
                sum_z=acc[0, 4], sum_color=sum_color, valid=count > 0,
                dropped=torch.clamp(total_bins - B, min=0))


def bin_points(cfg: TSDFConfig, pts_map, z, color, valid) -> Bins:
    """Stacked-points form of :func:`bin_points_c` (``pts_map`` (P, 3))."""
    return bin_points_c(cfg, pts_map[:, 0], pts_map[:, 1], pts_map[:, 2],
                        z, color, valid)


def _march_lattice_c(cfg: TSDFConfig, bins: Bins, T: torch.Tensor):
    """Sample points, live mask, signed distances and weights of every
    (step, bin) pair, step-major (S, B). Step j covers distance
    (j+1)·voxel along the bin's mean direction."""
    S = cfg.max_ray_steps
    dev = bins.count.device
    c = torch.clamp(bins.count, min=1.0)
    p0 = bins.sum_pos[:, 0] / c
    p1 = bins.sum_pos[:, 1] / c
    p2 = bins.sum_pos[:, 2] / c
    length = sqrt_rn(dot3(p0, p0, p1, p1, p2, p2))
    inv_len = 1.0 / torch.clamp(length, min=1e-12)
    d0, d1, d2 = p0 * inv_len, p1 * inv_len, p2 * inv_len
    e0, e1, e2 = p0 + T[0], p1 + T[1], p2 + T[2]
    z = bins.sum_z / c

    n_steps = torch.floor(torch.clamp(
        fma(length, torch.full_like(length, inv(cfg.voxel_scale)),
            torch.full_like(length, float(cfg.internal_voxels))),
        max=cfg.max_ray_length / cfg.voxel_scale)).to(torch.int32)

    step_dist = (torch.arange(S, dtype=torch.float32, device=dev) + 1.0) * \
        cfg.voxel_scale
    x0 = fma(d0[None, :], step_dist[:, None], T[0])
    x1 = fma(d1[None, :], step_dist[:, None], T[1])
    x2 = fma(d2[None, :], step_dist[:, None], T[2])
    live = (torch.arange(S, device=dev)[:, None] < n_steps[None, :]) & \
        bins.valid[None, :]

    v0 = e0[None, :] - x0
    v1 = e1[None, :] - x1
    v2 = e2[None, :] - x2
    d_x_p = sqrt_rn(dot3(v0, v0, v1, v1, v2, v2))
    dot = dot3(v0, p0[None, :], v1, p1[None, :], v2, p2[None, :])
    d_signed = d_x_p * geometry.sign(dot)
    w = w_x_p(cfg, d_x_p, z[None, :])  # unsigned distance: reference quirk
    w = torch.where(live, w, torch.zeros_like(w))
    return (x0, x1, x2), live, d_signed, w, (e0, e1, e2), z


def integrate(cfg: TSDFConfig, state: GridState, bins_pts, z, color, valid,
              T: torch.Tensor, active_submap: int):
    """Fuse one frame of (already rotated, sensor-centric) points; ``T`` is
    the sensor position in the submap frame; ``color`` (P, 3) f32 in 0-255
    or None. In place; returns (state, stats)."""
    bins = bin_points_c(cfg, bins_pts[0], bins_pts[1], bins_pts[2], z,
                        color, valid)
    (x0, x1, x2), live, d_signed, w, (e0, e1, e2), _ = \
        _march_lattice_c(cfg, bins, T)
    spec = cfg.grid
    V3 = spec.voxels_per_block
    dev = z.device
    s = int(active_submap)

    rha = geometry.round_half_away
    inv_v = 1.0 / cfg.voxel_scale

    def vox(x):
        return rha(x * inv_v).to(torch.int32)

    blin_m, intra_m, inb_m = voxel_to_block_c(spec, s, vox(x0), vox(x1),
                                              vox(x2))
    blin_e, intra_e, inb_e = voxel_to_block_c(spec, s, vox(e0), vox(e1),
                                              vox(e2))
    # marched blocks are allocated from K1's compact touched list below;
    # only the (bins-sized) endpoint set is allocated here
    state = allocate_blocks(spec, state, blin_e, bins.valid & inb_e, s)

    mask_m = (live & inb_m).reshape(-1)
    zero = torch.zeros((), device=dev)
    wf_raw = torch.where(mask_m, w.reshape(-1), zero)
    wdf_raw = wf_raw * d_signed.reshape(-1)
    ch = state.channels

    lo = s * spec.blocks_per_submap
    rel = blin_m.reshape(-1) - lo
    lane_ok = mask_m & (rel >= 0) & (rel < spec.blocks_per_submap)
    bkey = torch.where(lane_ok, rel, torch.full_like(rel, SENTINEL_BLOCK))
    intra_k = torch.where(lane_ok, intra_m.reshape(-1),
                          torch.zeros_like(rel))
    vals = (wf_raw, wdf_raw)
    if cfg.texture_enabled:
        # the bin's mean color in [0, 1], broadcast over its steps, as 3
        # extra reduction values Σw·c
        c = torch.clamp(bins.count, min=1.0)
        bin_rgb = bins.sum_color / c[:, None] * inv(255.0)
        vals = vals + tuple(
            wf_raw * torch.where(mask_m, bin_rgb[None, :, a].expand(
                live.shape).reshape(-1), zero) for a in range(3))
    touched_rel, acc, n_touched, lanes_dropped = segmented_block_reduce(
        bkey, intra_k, vals, V3, cfg.max_touched_blocks,
        lane_cap=(cfg.max_march_lanes or None), vals_f16=True,
        max_bkey=spec.blocks_per_submap, site="march")
    live_lanes = lane_ok.sum(dtype=torch.int32)
    touched_dropped = torch.clamp(n_touched - cfg.max_touched_blocks, min=0)

    row_ok = touched_rel >= 0
    cand_blin = torch.where(row_ok, lo + touched_rel,
                            torch.full_like(touched_rel, -1))
    state = allocate_blocks(spec, state, cand_blin, row_ok, s)
    slots = lookup_slots(spec, state.table, cand_blin)

    w_sum_t = torch.where(row_ok[:, None], acc[:, 0, :], zero)
    wd_sum_t = torch.where(row_ok[:, None], acc[:, 1, :], zero)
    tgt = torch.where(row_ok, slots,
                      torch.full_like(slots, spec.max_blocks)).long()
    D_rows = ch["TSDF"][tgt].float()
    W_rows = ch["W_TSDF"][tgt].float()
    touched_v = w_sum_t > 0
    new_D = torch.where(touched_v,
                        fma(D_rows, W_rows, wd_sum_t) / (W_rows + w_sum_t),
                        D_rows)
    new_W = torch.where(touched_v,
                        torch.clamp(W_rows + w_sum_t, max=cfg.w_max), W_rows)
    ch["TSDF"][tgt] = new_D.to(cfg.dtype)
    ch["W_TSDF"][tgt] = new_W.to(cfg.dtype)
    obs_rows = ch["TSDF_observed"][tgt]
    ch["TSDF_observed"][tgt] = torch.maximum(obs_rows,
                                             touched_v.to(torch.int8))
    if cfg.texture_enabled:
        # weighted mean of the frame's colors per touched voxel
        w_den = torch.clamp(w_sum_t, min=1e-20)
        C_rows = ch["color"][tgt].float()                 # (T, 3, V3)
        wc = torch.where(row_ok[:, None, None], acc[:, 2:5, :], zero)
        new_C = torch.where(touched_v[:, None, :], wc / w_den[:, None, :],
                            C_rows)
        ch["color"][tgt] = new_C.to(cfg.dtype)
    touched_blocks = torch.zeros((spec.max_blocks + 1,), dtype=torch.bool,
                                 device=dev)
    touched_blocks[tgt] = touched_v.any(dim=1)
    touched_blocks[-1].fill_(False)

    # endpoint occupancy
    garbage = (spec.max_blocks + 1) * V3 - 1
    slots_e = lookup_slots(spec, state.table, blin_e)
    flat_e = flat_voxel_index(spec, slots_e, intra_e)
    flat_e = torch.where(bins.valid & inb_e, flat_e,
                         torch.full_like(flat_e, garbage))
    scatter_max(ch["occupy"], flat_e, torch.ones_like(flat_e,
                                                      dtype=torch.int8))

    # keep the garbage row clean so exports never see absorbed writes
    for v in ch.values():
        v[-1].zero_()

    stats = {"bins_dropped": bins.dropped,
             "num_bins": bins.valid.sum(dtype=torch.int32),
             "alloc_overflow": state.alloc_overflow.clone(),
             "touched_dropped": touched_dropped,
             "lanes_dropped": lanes_dropped,
             "live_lanes": live_lanes,
             "touched_blocks": touched_blocks}
    return state, stats


def _rotate(R, px, py, pz):
    return tuple(dot3(R[a, 0], px, R[a, 1], py, R[a, 2], pz)
                 for a in range(3))


def integrate_depth_ref(cfg: TSDFConfig, state: GridState, depth_mm,
                        texture, R, T, K_dep, K_color, active_submap: int):
    """The eager body of :func:`integrate_depth` (every device). Inputs
    not on the state's device are moved there."""
    dev = state.table.device
    depth_mm = graphs.to_device(depth_mm, dev, np.int32)
    if cfg.texture_enabled:
        texture = graphs.to_device(texture, dev, np.uint8)
    R, T, K_dep, K_color = (graphs.to_device(x, dev, np.float32)
                            for x in (R, T, K_dep, K_color))
    (px, py, pz), dep, color, valid = depth_to_points_c(
        cfg, depth_mm, texture, K_dep, K_color)
    return integrate(cfg, state, _rotate(R, px, py, pz), dep, color, valid,
                     T, active_submap)


INTEGRATE_DEPTH = graphs.UnitCache("integrate_depth", size=4)
INTEGRATE_PCL = graphs.UnitCache("integrate_pcl", size=4)


def integrate_depth(cfg: TSDFConfig, state: GridState, depth_mm, texture,
                    R, T, K_dep, K_color, active_submap: int):
    """One depth frame (uint16 mm, or any integer tensor) with its (h, w, 3)
    texture (ignored when untextured) fused at sensor pose (R, T) in the
    submap frame; ``R``, ``T``, ``K_dep``, ``K_color`` are f32. In place;
    returns (state, stats). CPU state: :func:`integrate_depth_ref`. State
    on the card: one replay of the unit's CUDA graph (``ops/graphs.py``),
    the frame, texture, pose and intrinsics staged into its slots (host
    arrays through pinned memory, tensors on the card device to device)."""
    if graphs.eager(state.table):
        return integrate_depth_ref(cfg, state, depth_mm, texture, R, T,
                                   K_dep, K_color, active_submap)
    dev = state.table.device
    inputs = {"depth": (depth_mm, torch.int32),
              "par": (graphs.params((R, T, K_dep, K_color), dev),
                      torch.float32)}
    if cfg.texture_enabled:
        inputs["tex"] = (texture, torch.uint8)
    active = int(active_submap)

    def body(w, s):
        par = s["par"]
        return integrate_depth_ref(
            cfg, w[0], s["depth"], s.get("tex"), par[0:9].view(3, 3),
            par[9:12], par[12:21], par[21:30], active)
    return INTEGRATE_DEPTH.call(("integrate_depth", cfg, active), body,
                                written=(state,), inputs=inputs)


def integrate_pcl_ref(cfg: TSDFConfig, state: GridState, xyz, rgb, R, T,
                      active_submap: int):
    """The eager body of :func:`integrate_pcl` (every device). Inputs not
    on the state's device are moved there."""
    dev = state.table.device
    xyz, rgb, R, T = (graphs.to_device(x, dev, np.float32)
                      for x in (xyz, rgb, R, T))
    pts, color = pcl_to_points(cfg, xyz, rgb)
    m = _rotate(R, pts[:, 0], pts[:, 1], pts[:, 2])
    z = sqrt_rn(dot3(m[0], m[0], m[1], m[1], m[2], m[2]))
    return integrate(cfg, state, m, z, color, z < cfg.max_ray_length, T,
                     active_submap)


def integrate_pcl(cfg: TSDFConfig, state: GridState, xyz, rgb, R, T,
                  active_submap: int):
    """Point-cloud frame: points are rotated (not translated), gated on
    ``|R @ p| < max_ray_length``, and z := |R @ p|. In place; returns
    (state, stats). CPU state: :func:`integrate_pcl_ref`; state on the
    card: one graph replay per cloud size, as :func:`integrate_depth`."""
    if graphs.eager(state.table):
        return integrate_pcl_ref(cfg, state, xyz, rgb, R, T, active_submap)
    dev = state.table.device
    inputs = {"xyz": (xyz, torch.float32),
              "par": (graphs.params((R, T), dev), torch.float32)}
    if cfg.texture_enabled:
        inputs["rgb"] = (rgb, torch.float32)
    active = int(active_submap)

    def body(w, s):
        par = s["par"]
        return integrate_pcl_ref(cfg, w[0], s["xyz"], s.get("rgb", s["xyz"]),
                                 par[0:9].view(3, 3), par[9:12], active)
    return INTEGRATE_PCL.call(("integrate_pcl", cfg, active), body,
                              written=(state,), inputs=inputs)


def init_sphere(cfg: TSDFConfig, state: GridState, active_submap: int = 0,
                voxels: int = 30, radius: float = None) -> GridState:
    """Analytic sphere fixture: ``TSDF = |p| - radius`` (3 voxels by
    default) over a ``voxels³`` cube centred at the origin, observed, with
    jet colors by height when textured. In place; returns the state."""
    if radius is None:
        radius = cfg.voxel_scale * 3
    dev = state.table.device
    half = voxels // 2
    r = torch.arange(-half, half, dtype=torch.int32, device=dev)
    ii, jj, kk = torch.meshgrid(r, r, r, indexing="ij")
    ijk = torch.stack([ii, jj, kk], -1).reshape(-1, 3)
    p = geometry.ijk_to_xyz(ijk, cfg.voxel_scale)
    tsdf = sqrt_rn(dot3(p[:, 0], p[:, 0], p[:, 1], p[:, 1], p[:, 2],
                        p[:, 2])) - radius

    spec = cfg.grid
    s = int(active_submap)
    blin, intra, inb = voxel_to_block_c(spec, s, ijk[:, 0], ijk[:, 1],
                                        ijk[:, 2])
    state = allocate_blocks(spec, state, blin, inb, s)
    slots = lookup_slots(spec, state.table, blin)
    flat = flat_voxel_index(spec, slots, intra).long()
    ch = state.channels
    ch["TSDF"].view(-1)[flat] = tsdf.to(cfg.dtype)
    ch["TSDF_observed"].view(-1)[flat] = 1
    if cfg.texture_enabled:
        col = color_from_colormap(p[:, 2], -radius, radius, reciprocal=False)
        colf = ch["color"].view(-1)
        for a in range(3):
            colf[comp_flat_index(spec, slots, intra, a).long()] = \
                col[:, a].to(cfg.dtype)
    for v in ch.values():
        v[-1] = 0
    return state
