"""Voxgraph-style submap -> global map TSDF fusion (PyTorch).

Counterpart of the JAX package's ``ops/fusion.py``. Every observed submap voxel
is moved through its submap's base pose and splatted into the surrounding
global voxels with trilinear weights. Like the reference, the (0,0,0)
corner is skipped, so 7 corners carry weight. Sources are compacted at
block granularity first (``max_fuse_blocks`` observed blocks, every voxel
a masked lane), so the splat has ``7 × max_fuse_blocks × V³`` lanes.

The per-voxel sums (Σw, Σw·tsdf, Σocc and, textured, Σw·color) always
go through the sorted segmented reduction (K1,
``ops/kernels/seg_accum.py``): 3 values, or 6 when textured. The JAX
package takes XLA scatters instead when ``V³ % 128 != 0``. The merge is
closed form: ``(D·W + Σw·d) / (W + Σw)``, with no Wmax clamp, as in the
reference.

The grid state is changed in place, so the fusion is split in two:
:func:`fuse_reduce` (splat + K1) reads only the submap grid and returns
the touched list and its counts, and :func:`fuse_apply` writes the global
map. A caller that finds ``fuse_tiles_dropped > 0`` grows the touched
capacity and reduces again before anything is written. Weighted fusion is
not idempotent, so a retry must never re-apply on top of a failed attempt.

:func:`fuse_reduce` puts K1's call under the span ``fusion.k1``; K1's
wrapper counts its work there under ``fusion/k1/*`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.geometry import dot3, fma
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            block_origin_voxel, lookup_slots,
                                            voxel_to_block_c)
from taichislam_tpu_torch.ops.exports import _compact_blocks, _intra_offsets
from taichislam_tpu_torch.ops.kernels.seg_accum import (
    SENTINEL_BLOCK, segmented_block_reduce)
from taichislam_tpu_torch.utils import profiling


class SplatContribs(NamedTuple):
    """Lane count L = 7 × max_fuse_blocks × V³, corner-major; every voxel
    of the compacted observed source blocks is a source, and ``ok`` masks
    the unobserved ones."""
    blin: torch.Tensor     # (L,) int32 target linear block ids, -1 outside
    ok: torch.Tensor       # (L,) bool
    intra: torch.Tensor    # (L,) int32 intra-block voxel index
    w: torch.Tensor        # (L,) f32 splat weight (w_tsdf × trilinear)
    wd: torch.Tensor       # (L,) f32 w × tsdf
    occ: torch.Tensor      # (L,) int32 occupancy counts
    wc: torch.Tensor       # (3, L) f32 w × color (zeros when untextured)
    kept: torch.Tensor     # 0-d int32 sources used
    dropped: torch.Tensor  # 0-d int32 sources in blocks past the cap


def splat_contributions(sub_cfg: TSDFConfig, glob_cfg: TSDFConfig,
                        max_fuse_blocks: int, sub_state: GridState,
                        base_R, base_T,
                        only_submap: Optional[int] = None,
                        slots: Optional[Tuple[int, int]] = None
                        ) -> SplatContribs:
    """The 7-corner trilinear splat of the submap grid's observed voxels
    (all submaps, or only ``only_submap``; all block slots, or only those
    in ``slots`` = [lo, hi)) through the base poses ``base_R`` (S, 3, 3),
    ``base_T`` (S, 3) f32 into the global grid."""
    spec = sub_cfg.grid
    gspec = glob_cfg.grid
    ch = sub_state.channels
    dev = sub_state.table.device
    V3 = spec.voxels_per_block
    bcap = max(1, min(spec.max_blocks, max_fuse_blocks))
    C = bcap * V3

    obs_full = ch["TSDF_observed"] > 0                  # (nb, V³)
    blk_ok = sub_state.block_active.clone()
    blk_ok[-1] = False
    if only_submap is not None and only_submap >= 0:
        # incremental mode: the sources of ONE submap (the weighted merge
        # is associative, so one splat per finished submap into a global
        # map that is not reset equals reset + refuse-all)
        blk_ok &= sub_state.block_coords[:, 0] == int(only_submap)
    if slots is not None:
        # one pass of a refuse in passes: the blocks in these slots
        blk_ok[:slots[0]] = False
        blk_ok[slots[1]:] = False
    src_mask = obs_full & blk_ok[:, None]
    total = src_mask.sum(dtype=torch.int32)
    slot_of, bvalid, _, _ = _compact_blocks(spec, src_mask, bcap)
    sl = slot_of.long()

    src_valid = (obs_full[sl] & bvalid[:, None]).reshape(-1)
    src_tsdf = ch["TSDF"][sl].float().reshape(-1)
    src_w = ch["W_TSDF"][sl].float().reshape(-1)
    src_occ = ch["occupy"][sl].to(torch.int32).reshape(-1)
    kept = src_valid.sum(dtype=torch.int32)

    # submap-local voxel centre -> world -> global voxel units, per
    # component: R·l + T contracted as XLA contracts it, then × 1/voxel
    coords = sub_state.block_coords[sl]                 # (bcap, 4)
    base = block_origin_voxel(spec, coords)             # (bcap, 3)
    off = _intra_offsets(spec.V, dev)
    vs = float(np.float32(spec.voxel_scale))
    loc = [((base[:, a:a + 1] + off[None, :, a]).float() * vs).reshape(-1)
           for a in range(3)]
    s = torch.clamp(coords[:, 0], 0, base_R.shape[0] - 1).long()
    s = s.repeat_interleave(V3)
    R, T = base_R[s], base_T[s]
    inv_gv = float(np.float32(1.0 / glob_cfg.voxel_scale))
    gf = [(dot3(R[:, a, 0], loc[0], R[:, a, 1], loc[1], R[:, a, 2],
                loc[2]) + T[:, a]) * inv_gv for a in range(3)]
    del R, T, loc, s
    low = [torch.floor(g).to(torch.int32) for g in gf]
    fr = [g - lo.float() for g, lo in zip(gf, low)]
    del gf

    L = 7 * C
    i32 = dict(dtype=torch.int32, device=dev)
    out_blin = torch.empty((L,), **i32)
    out_intra = torch.empty((L,), **i32)
    out_ok = torch.empty((L,), dtype=torch.bool, device=dev)
    out_w = torch.empty((L,), dtype=torch.float32, device=dev)
    out_wd = torch.empty((L,), dtype=torch.float32, device=dev)
    out_occ = torch.empty((L,), **i32)
    zero = torch.zeros((), device=dev)
    corner = 0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                if di + dj + dk == 0:
                    continue   # the reference's skipped corner
                wgt = ((fr[0] if di else 1.0 - fr[0]) *
                       (fr[1] if dj else 1.0 - fr[1]) *
                       (fr[2] if dk else 1.0 - fr[2]))
                wgt = torch.where(src_valid, wgt, zero)
                blin, intra, inb = voxel_to_block_c(
                    gspec, 0, low[0] + di, low[1] + dj, low[2] + dk)
                ok = src_valid & inb & (wgt > 0)
                w = torch.where(ok, wgt * src_w, zero)
                lanes = slice(corner * C, (corner + 1) * C)
                out_blin[lanes] = blin
                out_intra[lanes] = intra
                out_ok[lanes] = ok
                out_w[lanes] = w
                out_wd[lanes] = w * src_tsdf
                out_occ[lanes] = torch.where(ok, src_occ,
                                             torch.zeros_like(src_occ))
                corner += 1
    if sub_cfg.texture_enabled:
        colg = ch["color"][sl].float()                  # (bcap, 3, V³)
        wc = torch.stack([out_w * colg[:, a, :].reshape(-1).repeat(7)
                          for a in range(3)])
    else:
        wc = torch.zeros((3, L), dtype=torch.float32, device=dev)
    return SplatContribs(blin=out_blin, ok=out_ok, intra=out_intra, w=out_w,
                         wd=out_wd, occ=out_occ, wc=wc, kept=kept,
                         dropped=total - kept)


class FuseReduced(NamedTuple):
    """What :func:`fuse_reduce` hands to :func:`fuse_apply`."""
    touched: torch.Tensor   # (max_touched,) int32 global block ids, -1 pad
    acc: torch.Tensor       # (max_touched, 3 or 6, V³) f32 sums
    stats: dict             # fuse_sources, fuse_dropped, fuse_tiles_dropped


def reduce_lanes(glob_cfg: TSDFConfig, c: SplatContribs):
    """K1's inputs at the fusion site: (bkey, intra, values) with the
    masked lanes on the sentinel key; values Σw, Σw·d, Σocc and, textured,
    the three Σw·c."""
    bkey = torch.where(c.ok, c.blin, torch.full_like(c.blin, SENTINEL_BLOCK))
    intra = torch.where(c.ok, c.intra, torch.zeros_like(c.intra))
    vals = [c.w, c.wd, c.occ.float()]
    if glob_cfg.texture_enabled:
        vals += [c.wc[0], c.wc[1], c.wc[2]]
    return bkey, intra, vals


def fuse_reduce(sub_cfg: TSDFConfig, glob_cfg: TSDFConfig,
                max_fuse_blocks: int, sub_state: GridState, base_R, base_T,
                only_submap: Optional[int] = None,
                slots: Optional[Tuple[int, int]] = None) -> FuseReduced:
    """The splat (of ``slots`` only, when given) and its per-block sums
    through K1, at most ``glob_cfg.max_touched_blocks`` touched global
    blocks. Reads only the submap grid; ``stats["fuse_tiles_dropped"] > 0``
    means the touched capacity was too small."""
    gspec = glob_cfg.grid
    V3 = gspec.voxels_per_block
    c = splat_contributions(sub_cfg, glob_cfg, max_fuse_blocks, sub_state,
                            base_R, base_T, only_submap, slots)
    stats = {"fuse_sources": c.kept, "fuse_dropped": c.dropped}
    lanes = reduce_lanes(glob_cfg, c)
    del c
    cap = glob_cfg.max_touched_blocks
    with profiling.span("fusion.k1"):
        touched, acc, n_touched, _ = segmented_block_reduce(
            *lanes, V3, cap,
            max_bkey=gspec.num_submaps * gspec.blocks_per_submap,
            site="fusion")
    stats["fuse_tiles_dropped"] = torch.clamp(n_touched - cap, min=0)
    return FuseReduced(touched, acc, stats)


def fuse_apply(glob_cfg: TSDFConfig, global_state: GridState,
               red: FuseReduced) -> GridState:
    """Allocate the touched blocks and merge the sums into the global map:
    ``D' = (D·W + Σw·d) / (W + Σw)``, ``W' = W + Σw`` (no Wmax clamp), the
    observed flag, ``occupy += Σocc`` (int8) and the color
    ``(c·W + Σw·c) / W'``. In place; returns the state."""
    gspec = glob_cfg.grid
    touched, acc = red.touched, red.acc
    row_ok = touched >= 0
    cand = torch.where(row_ok, touched, torch.full_like(touched, -1))
    global_state = allocate_blocks(gspec, global_state, cand, row_ok, 0)
    slots = lookup_slots(gspec, global_state.table, cand)
    tgt = torch.where(row_ok, slots,
                      torch.full_like(slots, gspec.max_blocks)).long()
    zero = torch.zeros((), device=acc.device)
    w_sum = torch.where(row_ok[:, None], acc[:, 0, :], zero)
    wd_sum = torch.where(row_ok[:, None], acc[:, 1, :], zero)
    occ_sum = torch.where(row_ok[:, None], acc[:, 2, :], zero)
    _merge(global_state.channels, tgt, w_sum, wd_sum, occ_sum,
           (lambda: torch.where(row_ok[:, None, None], acc[:, 3:6, :],
                                zero)) if glob_cfg.texture_enabled else None)
    return global_state


def _merge(ch, rows, w_sum, wd_sum, occ_sum, wc):
    """The closed-form weighted merge of the sums into the channels ``ch``
    (no Wmax clamp): ``D' = (D·W + Σw·d) / (W + Σw)``, ``W' = W + Σw``,
    the observed flag, ``occupy += Σocc`` and, when ``wc()`` gives Σw·c
    (None untextured), the color ``(c·W + Σw·c) / W'``. At the slots
    ``rows`` (gathered, merged and written back), or over every slot when
    ``rows`` is None; then the garbage row is cleared."""
    def read(k):
        return ch[k] if rows is None else ch[k][rows]

    def write(k, v):
        if rows is None:
            ch[k].copy_(v)
        else:
            ch[k][rows] = v.to(ch[k].dtype)
    D = read("TSDF").float()
    W = read("W_TSDF").float()
    touched_v = w_sum > 0
    new_W = W + w_sum
    write("TSDF", torch.where(touched_v, fma(D, W, wd_sum) / new_W, D))
    write("W_TSDF", new_W)
    write("TSDF_observed", torch.maximum(read("TSDF_observed"),
                                         touched_v.to(torch.int8)))
    write("occupy", read("occupy").to(torch.int32) +
          occ_sum.to(torch.int32))
    if wc is not None:
        den = torch.clamp(new_W, min=1e-20)
        col = read("color").float()                     # (T, 3, V³)
        write("color", torch.where(touched_v[:, None, :],
                                   fma(col, W[:, None, :], wc()) /
                                   den[:, None, :], col))
    for v in ch.values():
        v[-1] = 0


# ---------------------------------------------------------------------------
# dense accumulators: what the multi-drone fusion sums over ranks
# ---------------------------------------------------------------------------

def accumulate_dense(glob_cfg: TSDFConfig, global_state: GridState,
                     c: SplatContribs) -> torch.Tensor:
    """The (table_size,) bool bitmap of the global blocks the splat
    touches. The caller ORs it over ranks, allocates from it
    (``allocate_from_touched``) and then calls
    :func:`scatter_accumulators`."""
    gspec = glob_cfg.grid
    touched = torch.zeros((gspec.table_size + 1,), dtype=torch.bool,
                          device=c.blin.device)
    touched[torch.where(c.ok, c.blin, gspec.table_size).long()] = True
    return touched[:gspec.table_size]


def scatter_accumulators(glob_cfg: TSDFConfig, global_state: GridState,
                         c: SplatContribs):
    """Dense per-voxel sums ``(Σw, Σw·d, Σocc, Σw·c)`` of the splat over
    the global grid: (nvox,) f32, (nvox,) f32, (nvox,) int32 and (3, nvox)
    f32 (zeros when untextured), nvox = (max_blocks + 1)·V³. The lanes are
    reduced per block by K1, with room for every global slot so no block
    drops, and the block sums land at the slots the blocks hold (missing
    blocks in the garbage row)."""
    gspec = glob_cfg.grid
    V3 = gspec.voxels_per_block
    nb = gspec.max_blocks + 1
    touched, acc, _, _ = segmented_block_reduce(
        *reduce_lanes(glob_cfg, c), V3, nb,
        max_bkey=gspec.num_submaps * gspec.blocks_per_submap, site="fusion")
    row_ok = touched >= 0
    slots = lookup_slots(gspec, global_state.table,
                         torch.where(row_ok, touched,
                                     torch.full_like(touched, -1))).long()
    n_vals = acc.shape[1]
    dense = torch.zeros((nb, n_vals, V3), dtype=torch.float32,
                        device=acc.device)
    # pad rows (zero sums) and blocks without a slot land in the garbage
    # row, which the combine clears
    dense.index_add_(0, slots, acc)
    w_sum = dense[:, 0].reshape(-1)
    wd_sum = dense[:, 1].reshape(-1)
    occ_sum = dense[:, 2].reshape(-1).to(torch.int32)
    if glob_cfg.texture_enabled:
        wc_sum = dense[:, 3:6].permute(1, 0, 2).reshape(3, -1)
    else:
        wc_sum = torch.zeros((3, nb * V3), dtype=torch.float32,
                             device=acc.device)
    return w_sum, wd_sum, occ_sum, wc_sum


def combine_accumulators(glob_cfg: TSDFConfig, global_state: GridState,
                         w_sum, wd_sum, occ_sum, wc_sum) -> GridState:
    """Closed-form weighted merge of dense sums into the global map, as
    :func:`fuse_apply` merges (no Wmax clamp), over every slot. In place;
    returns the state."""
    gspec = glob_cfg.grid
    nb = gspec.max_blocks + 1
    V3 = gspec.voxels_per_block
    _merge(global_state.channels, None, w_sum.reshape(nb, V3),
           wd_sum.reshape(nb, V3), occ_sum.reshape(nb, V3),
           (lambda: wc_sum.reshape(3, nb, V3).permute(1, 0, 2))
           if glob_cfg.texture_enabled else None)
    return global_state


def fuse_submaps(sub_cfg: TSDFConfig, glob_cfg: TSDFConfig,
                 max_fuse_blocks: int, global_state: GridState,
                 sub_state: GridState, base_R, base_T,
                 only_submap: Optional[int] = None):
    """Fuse the submaps (or only ``only_submap``) into ``global_state``
    as the JAX function does: one reduce and one apply, whatever the
    touched count. In place; returns (global_state, stats)."""
    red = fuse_reduce(sub_cfg, glob_cfg, max_fuse_blocks, sub_state, base_R,
                      base_T, only_submap)
    return fuse_apply(glob_cfg, global_state, red), red.stats
