"""Voxblox-style TSDF integration (untextured), on PyTorch tensors.

Counterpart of ``taichislam_tpu.ops.tsdf``: bin the frame's points by
sensor-local voxel, march a dense (steps, bins) lattice from the sensor
through each bin's mean point, sum Σw and Σw·d per voxel with the sorted
segmented reduction (K1, ``ops/kernels/seg_accum.py``), and combine with
the weighted-average rule. The arithmetic follows the JAX functions op by
op, so voxel rounding agrees.

Kept on purpose: ``w_x_p`` receives the unsigned distance (the reference's
quirk), and march values are rounded to f16 before accumulation (the JAX
path's ``vals_f16``), because both change results.

Rounding follows the JAX package as XLA compiles it on the CPU. Division
by a constant is a multiply by its f32 reciprocal, as XLA
rewrites it in the JAX package (and as PyTorch's CUDA division by a Python
scalar also does): ``x / c`` is written ``x * _inv(c)`` so that the CPU and
the card round alike and agree with the JAX reference; and the
multiply-adds that XLA contracts into FMAs are computed with one rounding
(``_fma``), so voxel indices agree exactly.

``integrate`` and ``integrate_depth`` update the state's tensors IN PLACE
and return (state, stats).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from taichislam_tpu_torch.core import geometry
from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            flat_voxel_index, lookup_slots,
                                            make_grid_state, scatter_max,
                                            voxel_to_block_c)
from taichislam_tpu_torch.ops.kernels.seg_accum import (
    SENTINEL_BLOCK, segmented_block_reduce)


def _inv(c: float) -> float:
    """f32 reciprocal of a constant divisor (exactly representable)."""
    return float(np.float32(1.0) / np.float32(c))


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as the fused multiply-add XLA's CPU
    backend contracts these expressions into: the f64 product is exact and
    the f64 sum is rounded to f32 (a double rounding that differs from a
    true FMA only on exact f32 ties)."""
    return (a.double() * b.double() + c.double()).float()


def _sqrt(x):
    """Correctly rounded f32 square root (taken in f64): PyTorch's
    vectorized CPU sqrt is not, and voxel indices hang on this rounding."""
    return torch.sqrt(x.double()).float()


def _dot3(a0, b0, a1, b1, a2, b2):
    """``a0*b0 + a1*b1 + a2*b2`` with the contraction XLA applies:
    fma(a2, b2, fma(a0, b0, a1*b1))."""
    return _fma(a2, b2, _fma(a0, b0, a1 * b1))


def make_tsdf_state(cfg: TSDFConfig, device=None) -> GridState:
    if cfg.texture_enabled:
        raise NotImplementedError(
            "textured integration is not ported yet (ROADMAP Queue A)")
    dt = cfg.dtype
    defs = {"TSDF": (dt, ()), "W_TSDF": (dt, ()),
            "TSDF_observed": (torch.int8, ()), "occupy": (torch.int8, ())}
    return make_grid_state(cfg.grid, defs, device=device)


def w_x_p(cfg: TSDFConfig, d, z):
    """Voxblox linear-drop-off weight: ``1/z²`` for d > -ε, a linear ramp
    on (-θ, -ε], 0 behind (ε = voxel, θ = 4·voxel). Called with the
    unsigned distance, so only the first branch is live."""
    epi = cfg.voxel_scale
    theta = cfg.voxel_scale * 4.0
    inv_z2 = 1.0 / (z * z)
    ramp = (d + theta) * inv_z2 * _inv(theta - epi)
    zero = torch.zeros_like(inv_z2)
    return torch.where(d > -epi, inv_z2,
                       torch.where(d > -theta, ramp, zero))


def depth_to_points_c(cfg: TSDFConfig, depth_mm: torch.Tensor,
                      K_dep: torch.Tensor):
    """Strided unprojection with the reference's gating. Returns
    ((x, y, z_cam), z, valid), each (P,)."""
    h, w = depth_mm.shape
    step = cfg.recast_step
    jj, ii = geometry.pixel_grid(h, w, step, device=depth_mm.device)
    jj, ii = jj.reshape(-1), ii.reshape(-1)
    d_mm = geometry.strided_depth_f32(depth_mm, step)
    valid = (d_mm != 0) & (d_mm <= cfg.max_ray_length * 1000.0) & (
        d_mm >= cfg.min_ray_length * 1000.0)
    dep = d_mm * _inv(1000.0)
    fx, cx, fy, cy = K_dep[0], K_dep[2], K_dep[4], K_dep[5]
    px = (ii.float() - cx) * dep / fx
    py = (jj.float() - cy) * dep / fy
    return (px, py, dep), dep, valid


class Bins(NamedTuple):
    count: torch.Tensor    # (max_bins,) f32
    sum_pos: torch.Tensor  # (max_bins, 3) f32, sensor-centric positions
    sum_z: torch.Tensor    # (max_bins,) f32
    valid: torch.Tensor    # (max_bins,) bool
    dropped: torch.Tensor  # 0-d int32, bins beyond max_bins


def bin_points_c(cfg: TSDFConfig, px, py, pz, z, valid) -> Bins:
    """Deduplicate rays by sensor-local voxel: a stable sort by bin id,
    then per-bin sums through K1 (one "block" of V³ = max_bins, intra =
    bin rank, presorted)."""
    r = int(math.ceil(cfg.max_ray_length / cfg.voxel_scale)) + 1
    G = 2 * r + 1
    iv = _inv(cfg.voxel_scale)
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
    vals = (ok.float(), px[perm], py[perm], pz[perm], z[perm])
    _, acc, _, _ = segmented_block_reduce(bkeyz, intra, vals, B, 1,
                                          presorted=True)
    count = acc[0, 0]
    return Bins(count=count,
                sum_pos=torch.stack([acc[0, 1], acc[0, 2], acc[0, 3]], -1),
                sum_z=acc[0, 4], valid=count > 0,
                dropped=torch.clamp(total_bins - B, min=0))


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
    length = _sqrt(_dot3(p0, p0, p1, p1, p2, p2))
    inv_len = 1.0 / torch.clamp(length, min=1e-12)
    d0, d1, d2 = p0 * inv_len, p1 * inv_len, p2 * inv_len
    e0, e1, e2 = p0 + T[0], p1 + T[1], p2 + T[2]
    z = bins.sum_z / c

    n_steps = torch.floor(torch.clamp(
        _fma(length, torch.full_like(length, _inv(cfg.voxel_scale)),
             torch.full_like(length, float(cfg.internal_voxels))),
        max=cfg.max_ray_length / cfg.voxel_scale)).to(torch.int32)

    step_dist = (torch.arange(S, dtype=torch.float32, device=dev) + 1.0) * \
        cfg.voxel_scale
    x0 = _fma(d0[None, :], step_dist[:, None], T[0])
    x1 = _fma(d1[None, :], step_dist[:, None], T[1])
    x2 = _fma(d2[None, :], step_dist[:, None], T[2])
    live = (torch.arange(S, device=dev)[:, None] < n_steps[None, :]) & \
        bins.valid[None, :]

    v0 = e0[None, :] - x0
    v1 = e1[None, :] - x1
    v2 = e2[None, :] - x2
    d_x_p = _sqrt(_dot3(v0, v0, v1, v1, v2, v2))
    dot = _dot3(v0, p0[None, :], v1, p1[None, :], v2, p2[None, :])
    d_signed = d_x_p * geometry.sign(dot)
    w = w_x_p(cfg, d_x_p, z[None, :])  # unsigned distance: reference quirk
    w = torch.where(live, w, torch.zeros_like(w))
    return (x0, x1, x2), live, d_signed, w, (e0, e1, e2), z


def integrate(cfg: TSDFConfig, state: GridState, bins_pts, z, valid,
              T: torch.Tensor, active_submap: int):
    """Fuse one frame of (already rotated, sensor-centric) points; ``T`` is
    the sensor position in the submap frame. In place; returns
    (state, stats)."""
    if cfg.texture_enabled:
        raise NotImplementedError(
            "textured integration is not ported yet (ROADMAP Queue A)")
    bins = bin_points_c(cfg, bins_pts[0], bins_pts[1], bins_pts[2], z, valid)
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
    wf_raw = torch.where(mask_m, w.reshape(-1), torch.zeros((), device=dev))
    wdf_raw = wf_raw * d_signed.reshape(-1)
    ch = state.channels

    lo = s * spec.blocks_per_submap
    rel = blin_m.reshape(-1) - lo
    lane_ok = mask_m & (rel >= 0) & (rel < spec.blocks_per_submap)
    bkey = torch.where(lane_ok, rel, torch.full_like(rel, SENTINEL_BLOCK))
    intra_k = torch.where(lane_ok, intra_m.reshape(-1),
                          torch.zeros_like(rel))
    touched_rel, acc, n_touched, lanes_dropped = segmented_block_reduce(
        bkey, intra_k, (wf_raw, wdf_raw), V3, cfg.max_touched_blocks,
        lane_cap=(cfg.max_march_lanes or None), vals_f16=True)
    live_lanes = lane_ok.sum(dtype=torch.int32)
    touched_dropped = torch.clamp(n_touched - cfg.max_touched_blocks, min=0)

    row_ok = touched_rel >= 0
    cand_blin = torch.where(row_ok, lo + touched_rel,
                            torch.full_like(touched_rel, -1))
    state = allocate_blocks(spec, state, cand_blin, row_ok, s)
    slots = lookup_slots(spec, state.table, cand_blin)

    zero = torch.zeros((), device=dev)
    w_sum_t = torch.where(row_ok[:, None], acc[:, 0, :], zero)
    wd_sum_t = torch.where(row_ok[:, None], acc[:, 1, :], zero)
    tgt = torch.where(row_ok, slots,
                      torch.full_like(slots, spec.max_blocks)).long()
    D_rows = ch["TSDF"][tgt].float()
    W_rows = ch["W_TSDF"][tgt].float()
    touched_v = w_sum_t > 0
    new_D = torch.where(touched_v,
                        _fma(D_rows, W_rows, wd_sum_t) / (W_rows + w_sum_t),
                        D_rows)
    new_W = torch.where(touched_v,
                        torch.clamp(W_rows + w_sum_t, max=cfg.w_max), W_rows)
    ch["TSDF"][tgt] = new_D.to(cfg.dtype)
    ch["W_TSDF"][tgt] = new_W.to(cfg.dtype)
    obs_rows = ch["TSDF_observed"][tgt]
    ch["TSDF_observed"][tgt] = torch.maximum(obs_rows,
                                             touched_v.to(torch.int8))
    touched_blocks = torch.zeros((spec.max_blocks + 1,), dtype=torch.bool,
                                 device=dev)
    touched_blocks[tgt] = touched_v.any(dim=1)
    touched_blocks[-1] = False

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
        v[-1] = 0

    stats = {"bins_dropped": bins.dropped,
             "num_bins": bins.valid.sum(dtype=torch.int32),
             "alloc_overflow": state.alloc_overflow,
             "touched_dropped": touched_dropped,
             "lanes_dropped": lanes_dropped,
             "live_lanes": live_lanes,
             "touched_blocks": touched_blocks}
    return state, stats


def integrate_depth(cfg: TSDFConfig, state: GridState, depth_mm, R, T,
                    K_dep, active_submap: int):
    """One depth frame (uint16 mm, or any integer tensor) fused at sensor
    pose (R, T) in the submap frame; ``R``, ``T``, ``K_dep`` are f32
    tensors on the state's device. In place; returns (state, stats)."""
    (px, py, pz), dep, valid = depth_to_points_c(cfg, depth_mm, K_dep)
    m0, m1, m2 = (_dot3(R[a, 0], px, R[a, 1], py, R[a, 2], pz)
                  for a in range(3))
    return integrate(cfg, state, (m0, m1, m2), dep, valid, T, active_submap)
