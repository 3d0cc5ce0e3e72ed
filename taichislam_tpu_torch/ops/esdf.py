"""Incremental ESDF by masked Jacobi sweeps (PyTorch).

Counterpart of the JAX package's ``ops/esdf.py``:

- ``esdf_seed_dirty``: updated-voxel gating of the frame's touched blocks;
- ``esdf_update``, block mode: a compacted working set (the dirty blocks
  plus a frozen rim, Morton-ordered rows), swept in the lane-fused layout
  ``(rows, W, W*W)`` = ``[j | i*W + k]``, W = V + 2, by the loop kernel K3
  whenever ``max_sweeps >= 2`` and ``esdf_force_sweeps`` is off, by the
  per-sweep kernel K2 otherwise (the XLA sweep body is not ported);
- ``esdf_update_dense``, the dense-window and dirty-window modes: the
  observed (or dirty) bounding box swept as one dense grid with full-length
  axis scans. The JAX package computes these in XLA, outside any Pallas
  kernel, and so do these plain PyTorch functions;
- ``esdf_slice_export``: the ESDF z-slice as jet-colored particles (its
  ``*_packed`` variant in one buffer, ``exports.pack_export``);
- ``neighbor_table`` and ``neighborhood_extrema``: the JAX module's public
  helpers for tests and debugging (no sweep runs through them).

See the JAX module for the algorithms. ``esdf_seed_dirty`` updates
``seen_tsdf`` / ``seen_obs`` in place; ``esdf_update`` updates
``prev_esdf`` / ``prev_fixed`` in place and returns them;
``esdf_update_dense`` returns new tensors.

``esdf_seed_dirty``, ``esdf_update``, ``esdf_update_dense`` and
``esdf_slice_export`` (with ``esdf_slice_export_packed``) are units of
``ops/graphs.py``: on the card each call is one CUDA graph replay (the
dense update three: set-up, a chunk of ``_SWEEP_CHECK`` sweeps replayed
until the device's flag reads false, and finish), the counterpart of the
JAX package's jitted functions; their ``*_ref`` twins are the eager
bodies, which CPU tensors take.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from taichislam_tpu_torch.core.compaction import compact_mask, compact_sort
from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.device import resolve_device
from taichislam_tpu_torch.core.geometry import inv, sign
from taichislam_tpu_torch.core.grid import block_origin_voxel, lookup_slots
from taichislam_tpu_torch.ops import graphs
from taichislam_tpu_torch.utils.profiling import host_read
from taichislam_tpu_torch.ops.kernels.esdf_sweep import (ENC_BIG,
                                                         esdf_sweep,
                                                         esdf_sweep_loop)

BIG = 1e9  # the JAX package's jnp.float32(1e9); exact in float32

# face-neighbour column ids in the (27, n) table: c = ((di+1)*3+(dj+1))*3+dk+1
_C_IM, _C_IP = 4, 22
_C_JM, _C_JP = 10, 16
_C_KM, _C_KP = 12, 14


def neighbor_table(device=None):
    """The 26 neighbour directions, (26, 3) int32 in (di, dj, dk) order
    with (0, 0, 0) left out, and their lengths, (26,) f32; on the CUDA card
    unless ``device`` says otherwise."""
    d = np.asarray([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)], np.int32)
    dist = np.linalg.norm(d, axis=-1).astype(np.float32)
    device = resolve_device(device)
    return torch.from_numpy(d).to(device), torch.from_numpy(dist).to(device)


def _axpair(h, axis, op):
    """op of the -1 and +1 shifts of ``h`` along ``axis`` (of the trailing
    three), cropped by one voxel on each side of that axis."""
    n = h.shape[axis + 1]
    return op(h.narrow(axis + 1, 0, n - 2), h.narrow(axis + 1, 2, n - 2))


def _center_crop(h, axis):
    return h.narrow(axis + 1, 1, h.shape[axis + 1] - 2)


def neighborhood_extrema(halo, op):
    """Class-wise 26-neighbourhood extrema of an (nb, V+2, V+2, V+2) halo:
    (faces, edges, corners), each (nb, V, V, V), ``op`` (``torch.minimum``
    or ``torch.maximum``) over the 6 face, 12 edge and 8 corner neighbours,
    built from separable two-shift axis extrema as the JAX function builds
    them."""
    ax = _axpair(halo, 0, op)           # (nb, V,   V+2, V+2)
    ay = _axpair(halo, 1, op)           # (nb, V+2, V,   V+2)
    az = _axpair(halo, 2, op)
    faces = op(op(_center_crop(_center_crop(ax, 1), 2),
                  _center_crop(_center_crop(ay, 0), 2)),
               _center_crop(_center_crop(az, 0), 1))
    exy = _axpair(ax, 1, op)            # x±1, y±1
    exz = _axpair(ax, 2, op)
    eyz = _axpair(ay, 2, op)
    edges = op(op(_center_crop(exy, 2), _center_crop(exz, 1)),
               _center_crop(eyz, 0))
    corners = _axpair(exy, 2, op)       # x±1, y±1, z±1
    return faces, edges, corners


def neighbor_slot_cols(spec, state, active_submap, rows=None):
    """(27, n) storage slot of each block's 26 neighbours (+ itself),
    column c = ((di+1)*3 + (dj+1))*3 + (dk+1); missing neighbours map to
    the garbage slot. ``rows=None`` covers all ``max_blocks + 1`` storage
    slots; a (k,) row-index tensor probes only those rows.
    ``active_submap`` is unused, as in the JAX package."""
    bc = state.block_coords
    if rows is not None:
        bc = bc[rows.long()]
    s, bi, bj, bk = bc[:, 0], bc[:, 1], bc[:, 2], bc[:, 3]
    base = s * spec.blocks_per_submap
    cols = []
    for di in (-1, 0, 1):
        ni = bi + di
        ok_i = (s >= 0) & (ni >= 0) & (ni < spec.bn_xy)
        for dj in (-1, 0, 1):
            nj = bj + dj
            ok_j = ok_i & (nj >= 0) & (nj < spec.bn_xy)
            for dk in (-1, 0, 1):
                nk = bk + dk
                ok = ok_j & (nk >= 0) & (nk < spec.bn_z)
                blin = (ni * spec.bn_xy + nj) * spec.bn_z + nk + base
                cols.append(torch.where(ok, blin, torch.full_like(blin, -1)))
    return lookup_slots(spec, state.table, torch.stack(cols, dim=0))


def neighbor_slot_table(spec, state, active_submap, rows=None):
    """(n, 3, 3, 3) view of :func:`neighbor_slot_cols`."""
    cols = neighbor_slot_cols(spec, state, active_submap, rows=rows)
    return cols.t().reshape(-1, 3, 3, 3)


def assemble_halo(tiles, nslots, V, fill, center=None):
    """(n, V+2, V+2, V+2) halos of ``n`` blocks: the interiors are
    ``center`` (n, V, V, V), the 26 boundary slabs are gathered from the
    full-size ``tiles`` (nb, V, V, V) through the (n, 3, 3, 3) neighbour
    slot table ``nslots`` (the garbage row of ``tiles`` holds ``fill``).
    With ``center=None`` the interiors are ``tiles`` itself (n == nb)."""
    if center is None:
        center = tiles
    n = center.shape[0]
    halo = torch.full((n, V + 2, V + 2, V + 2), fill, dtype=tiles.dtype,
                      device=tiles.device)
    halo[:, 1:V + 1, 1:V + 1, 1:V + 1] = center
    src = {1: slice(0, 1), -1: slice(V - 1, V), 0: slice(0, V)}
    dst = {1: slice(V + 1, V + 2), -1: slice(0, 1), 0: slice(1, V + 1)}
    nl = nslots.long()
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if di == 0 and dj == 0 and dk == 0:
                    continue
                slab = tiles[:, src[di], src[dj], src[dk]]
                halo[:, dst[di], dst[dj], dst[dk]] = \
                    slab[nl[:, di + 1, dj + 1, dk + 1]]
    return halo


def _part1by2(x):
    """Spread the low 10 bits of x to every third bit (Morton helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order_rows(slot_of, bvalid, n_upd, block_coords):
    """Permute the compact row list into Morton order within each group
    (updatable prefix / frozen rim / invalid). Exact: the Jacobi sweep is
    order-independent across rows; only the slab gates see the order."""
    cap = slot_of.shape[0]
    c = block_coords[slot_of.long()].long()
    key = (_part1by2(c[:, 1]) | (_part1by2(c[:, 2]) << 1)
           | (_part1by2(c[:, 3]) << 2))
    cpos = torch.arange(cap, device=slot_of.device)
    grp = torch.where(cpos < n_upd, 0, 1)
    grp = torch.where(bvalid, grp, 2)
    key = torch.where(bvalid, key, 0)
    _, perm = torch.sort(grp * (1 << 31) + key, stable=True)
    return slot_of[perm]


def _to_sweep_layout(tiles, V, fill):
    """(n, V^3) flat [i,j,k] tiles -> (n, V+2, (V+2)**2) [j | i*(V+2)+k]
    with ``fill`` in the halo positions."""
    n, W = tiles.shape[0], V + 2
    out = torch.full((n, W, W, W), fill, dtype=tiles.dtype,
                     device=tiles.device)
    out[:, 1:V + 1, 1:V + 1, 1:V + 1] = tiles.reshape(n, V, V, V).permute(
        0, 2, 1, 3)
    return out.reshape(n, W, W * W)


def _from_sweep_layout(H, V):
    n, W = H.shape[0], V + 2
    t = H.reshape(n, W, W, W)[:, 1:V + 1, 1:V + 1, 1:V + 1]
    return t.permute(0, 2, 1, 3).reshape(n, V * V * V)


def _assemble_sweep(H, nsl, V):
    """Fill the halo shells of sweep-layout ``H`` from neighbour rows, IN
    PLACE. ``nsl`` is the (27, n) compact neighbour table (garbage row for
    missing neighbours, whose values must already be the fill). Axis passes
    run i -> j -> k, so each pass reads shells the earlier passes filled and
    all diagonals arrive through face exchanges."""
    n, W = H.shape[0], V + 2
    H4 = H.view(n, W, W, W)  # (row, j, i, k)
    nl = nsl.long()
    H4[:, :, 0, :] = H4[:, :, V, :][nl[_C_IM]]
    H4[:, :, V + 1, :] = H4[:, :, 1, :][nl[_C_IP]]
    H4[:, 0, :, :] = H4[:, V, :, :][nl[_C_JM]]
    H4[:, V + 1, :, :] = H4[:, 1, :, :][nl[_C_JP]]
    H4[:, :, :, 0] = H4[:, :, :, V][nl[_C_KM]]
    H4[:, :, :, V + 1] = H4[:, :, :, 1][nl[_C_KP]]
    return H


@functools.lru_cache(maxsize=8)
def _shell_mask(V, device):
    """(V^3,) bool: voxels on a block's 1-voxel boundary shell (cached on
    the device, so the update copies nothing from the host)."""
    i, j, k = np.meshgrid(*([np.arange(V)] * 3), indexing="ij")
    edge = (i == 0) | (i == V - 1) | (j == 0) | (j == V - 1) | \
        (k == 0) | (k == V - 1)
    return torch.from_numpy(edge.reshape(-1)).to(device)


def _compact_rows(mask, cap, nb):
    """Row list of the first ``cap`` set entries of ``mask`` (garbage slot
    nb-1 after them), plus kept / total counts."""
    pos, kept, total = compact_mask(mask, cap)
    rows = torch.full((cap + 1,), nb - 1, dtype=torch.int32,
                      device=mask.device)
    rows[pos.long()] = torch.arange(mask.shape[0], dtype=torch.int32,
                                    device=mask.device)
    return rows, kept, total


SEED_DIRTY = graphs.UnitCache("esdf_seed_dirty", size=4)
ESDF_UPDATE = graphs.UnitCache("esdf_update", size=6)
ESDF_DENSE = graphs.UnitCache("esdf_update_dense", size=4)
SLICE_EXPORT = graphs.UnitCache("esdf_slice_export", size=2)


def esdf_seed_dirty(cfg: TSDFConfig, state, seen_tsdf, seen_obs, touched,
                    touched_cap: int = 512):
    """Updated-voxel gating: of the frame-``touched`` blocks, those where
    some voxel's TSDF moved more than ``esdf_seed_eps_voxels`` voxels (or an
    observed flag flipped) since the ESDF last consumed them are dirty;
    dirty rows refresh the snapshots. Rows above ``touched_cap`` are dirty
    uncompared. Returns (dirty, seen_tsdf, seen_obs); the snapshots are
    updated in place. CPU state: :func:`esdf_seed_dirty_ref`; on the card
    one graph replay (``ops/graphs.py``), ``touched`` staged."""
    if graphs.eager(seen_tsdf):
        return esdf_seed_dirty_ref(cfg, state, seen_tsdf, seen_obs, touched,
                                   touched_cap)

    def body(w, s):
        return esdf_seed_dirty_ref(cfg, state, w[0], w[1], s["touched"],
                                   touched_cap)
    return SEED_DIRTY.call(
        ("esdf_seed_dirty", cfg, int(touched_cap)), body,
        written=(seen_tsdf, seen_obs), bound=graphs.leaves((state,)),
        inputs={"touched": (touched, torch.bool)})


def esdf_seed_dirty_ref(cfg: TSDFConfig, state, seen_tsdf, seen_obs,
                        touched, touched_cap: int = 512):
    """The eager body of :func:`esdf_seed_dirty` (every device)."""
    nb = cfg.grid.max_blocks + 1
    eps = float(np.float32(max(cfg.esdf_seed_eps_voxels, 0.0) *
                           cfg.voxel_scale))
    touched = touched.clone()
    touched[-1].fill_(False)
    rows, kept, _ = _compact_rows(touched, touched_cap, nb)
    rows = rows[:touched_cap].long()
    valid = torch.arange(touched_cap, device=touched.device) < kept

    tsdf_r = state.channels["TSDF"][rows].float()
    obs_r = state.channels["TSDF_observed"][rows] > 0
    seen_t_r = seen_tsdf[rows]
    seen_o_r = seen_obs[rows]
    diff_r = (((tsdf_r - seen_t_r).abs() > eps) |
              (obs_r != seen_o_r)).any(dim=1) & valid

    tgt = torch.where(diff_r, rows, nb - 1)
    dirty = torch.zeros((nb,), dtype=torch.bool, device=touched.device)
    dirty.index_fill_(0, tgt, True)
    covered = torch.zeros_like(dirty)
    covered[rows] = valid
    dirty = dirty | (touched & ~covered)
    dirty[-1].fill_(False)
    seen_tsdf[tgt] = torch.where(diff_r[:, None], tsdf_r, seen_t_r)
    seen_tsdf[nb - 1].zero_()
    seen_obs[tgt] = torch.where(diff_r[:, None], obs_r, seen_o_r)
    seen_obs[nb - 1].fill_(False)
    return dirty, seen_tsdf, seen_obs


class WorkingSet(NamedTuple):
    """The compacted rows of a block-mode ESDF update (see
    :func:`working_set`)."""
    blk: torch.Tensor          # (nb,) active-submap blocks
    work_blk: torch.Tensor     # (nb,) blocks the update may change
    slot_of: torch.Tensor      # (cap,) int32 storage slot per compact row
    bvalid: torch.Tensor       # (cap,) bool
    n_upd: torch.Tensor        # 0-d: updatable rows (a Morton-ordered prefix)
    overflow: torch.Tensor     # 0-d int32: rows past the cap
    inv: torch.Tensor          # (nb,) int32 compact row of a slot, cap if none
    nslots: torch.Tensor       # (27, NROWS) int32 compact neighbour rows
    updatable: torch.Tensor    # (NROWS,) bool
    ns_flat: Optional[torch.Tensor]   # (27, cap) neighbour slots of dirty rows
    rows_d: Optional[torch.Tensor]    # (cap,) int32 dirty rows
    validD: Optional[torch.Tensor]    # (cap,) bool


def working_set(spec, state, active_submap: int, block_cap: int, NROWS: int,
                dirty_blocks=None) -> WorkingSet:
    """The rows of an update: without ``dirty_blocks`` every active block;
    with it the dirty blocks (updatable) and then their 26-ring as a frozen
    rim, Morton-ordered within each group, plus the compact neighbour table
    padded to ``NROWS`` rows. Depends on the replicated bookkeeping only."""
    nb = spec.max_blocks + 1
    dev = state.table.device
    cap = block_cap
    blk = state.block_active & (state.block_coords[:, 0] == int(active_submap))
    blk[-1].fill_(False)
    ar_cap = torch.arange(cap, device=dev)
    if dirty_blocks is None:
        work_blk = blk
        slot_of, bkept, btotal = _compact_rows(blk, cap, nb)
        slot_of = slot_of[:cap]
        bvalid = ar_cap < bkept
        n_upd = bkept
        overflow_in = torch.clamp(btotal - cap, min=0)
        ns_flat = rows_d = validD = None
    else:
        # the dirty blocks themselves are updatable; their 26-ring is a
        # frozen rim. Rows are ordered dirty-first so rim slabs skip compute.
        dirty = dirty_blocks.clone()
        dirty[-1].fill_(False)
        work_blk = blk & dirty
        rows_d, keptD, totalD = _compact_rows(work_blk, cap, nb)
        rows_d = rows_d[:cap]
        validD = ar_cap < keptD
        ns_d = neighbor_slot_cols(spec, state, active_submap, rows=rows_d)
        ns_flat = torch.where(validD[None, :], ns_d, nb - 1)   # (27, cap)
        srt, _ = torch.sort(ns_flat.reshape(-1))
        head = (srt < nb - 1) & torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev), srt[1:] != srt[:-1]])
        head &= ~work_blk[srt.long()]
        posR, keptR, totalR = compact_mask(head, cap)
        posR = torch.where(posR < cap, posR + keptD, cap)
        slot_of = torch.full((cap + 1,), nb - 1, dtype=torch.int32,
                             device=dev)
        slot_of[:cap] = rows_d
        slot_of[torch.clamp(posR, max=cap).long()] = torch.where(
            head, srt, nb - 1).to(torch.int32)
        slot_of = slot_of[:cap]
        keptS = torch.clamp(keptD + keptR, max=cap)
        bvalid = ar_cap < keptS
        n_upd = keptD
        overflow_in = torch.clamp(torch.maximum(totalD, totalD + totalR) -
                                  cap, min=0)

    slot_of = morton_order_rows(slot_of, bvalid, n_upd, state.block_coords)
    slot_l = slot_of.long()

    # global slot -> compact index (garbage rows -> cap)
    inv = torch.full((nb,), cap, dtype=torch.int32, device=dev)
    inv[slot_l] = torch.where(bvalid, ar_cap.to(torch.int32), cap)

    nslots = inv[neighbor_slot_cols(spec, state, active_submap,
                                    rows=slot_of).long()]
    nslots = torch.where(bvalid[None, :], nslots, cap)
    nslots = torch.cat([nslots, torch.full((27, NROWS - cap), cap,
                                           dtype=torch.int32, device=dev)],
                       dim=1).contiguous()                  # (27, NROWS)

    updatable = work_blk[slot_l] & bvalid
    updatable = torch.cat([updatable, torch.zeros((NROWS - cap,),
                                                  dtype=torch.bool,
                                                  device=dev)])
    return WorkingSet(blk, work_blk, slot_of, bvalid, n_upd, overflow_in,
                      inv, nslots, updatable, ns_flat, rows_d, validD)


def seed_field(cfg: TSDFConfig, tsdf, participate, prev_e, prev_f):
    """(fixed, esdf0) of the compact rows: the near-surface band is fixed
    at its TSDF; other participating voxels warm-start from the previous
    field where its sign agrees, else from +-max_ray."""
    max_ray = cfg.max_ray_length
    fixed = participate & (tsdf.abs() < float(np.float32(cfg.voxel_scale)))
    sgn = (tsdf > 0).float() - (tsdf < 0).float()
    seed = torch.where(fixed, tsdf, sgn * max_ray)
    prev_ok = (torch.sign(prev_e) == torch.sign(seed)) & participate & \
        (prev_e != 0) & ~((prev_f > 0) & ~fixed)
    esdf0 = torch.where(fixed, seed,
                        torch.where(prev_ok,
                                    torch.clamp(prev_e, -max_ray, max_ray),
                                    seed))
    return fixed, torch.where(participate, esdf0, 0.0)


def sweep_kw(cfg: TSDFConfig):
    """The constants K2 and K3 take."""
    eps = max(cfg.esdf_raise_slack_voxels * cfg.voxel_scale, 1e-4)
    return dict(V=cfg.grid.V, v1=cfg.voxel_scale, gamma=cfg.voxel_scale,
                eps=eps, max_ray=cfg.max_ray_length)


def scan_this_sweep(cfg: TSDFConfig, s: int) -> bool:
    """Whether sweep ``s`` runs the multi-hop axis scans."""
    return cfg.esdf_scan_sweeps < 0 or s < cfg.esdf_scan_sweeps or (
        cfg.esdf_scan_period > 0 and s % cfg.esdf_scan_period == 0)


def update_sides(ws: WorkingSet, V, tsdf, participate, fixed):
    """The interior-only int8 update side (+1 / -1 / 0) in sweep layout."""
    upd = ws.updatable[:, None]
    pos_side = participate & ~fixed & (tsdf >= 0) & upd
    neg_side = participate & ~fixed & (tsdf < 0) & upd
    return (_to_sweep_layout(pos_side, V, False).to(torch.int8) -
            _to_sweep_layout(neg_side, V, False).to(torch.int8))


def requeue(cfg: TSDFConfig, ws: WorkingSet, esdf_c, prev_e, fixed, prev_f,
            incremental: bool):
    """The (nb,) re-queue bitmap: the updatable blocks whose rows changed
    and, incrementally, the 26 neighbours of a dirty block whose boundary
    shell changed."""
    spec = cfg.grid
    nb = spec.max_blocks + 1
    cap = ws.slot_of.shape[0]
    NROWS = ws.updatable.shape[0]
    dev = esdf_c.device
    diff = ((esdf_c - prev_e).abs() > float(np.float32(
        cfg.esdf_converge_eps))) | (fixed != (prev_f > 0))
    row_changed = diff.any(dim=1)
    tgt = torch.where(ws.updatable[:cap], ws.slot_of.long(), nb)
    changed_blocks = torch.zeros((nb + 1,), dtype=torch.bool, device=dev)
    changed_blocks[tgt] = row_changed[:cap]
    changed_blocks = changed_blocks[:nb]
    changed_blocks[-1].fill_(False)
    if incremental:
        shell = _shell_mask(spec.V, dev)
        shell_changed = (diff & shell[None, :]).any(dim=1)
        tgtD = torch.where(ws.validD, ws.inv[ws.rows_d.long()], cap)
        shell_d = shell_changed[torch.clamp(tgtD, max=NROWS - 1).long()] & \
            ws.validD
        tgt27 = torch.where(shell_d[None, :], ws.ns_flat, nb - 1)
        shell_blocks = torch.zeros((nb,), dtype=torch.bool, device=dev)
        shell_blocks.index_fill_(0, tgt27.reshape(-1).long(), True)
        changed_blocks = changed_blocks | (ws.blk & shell_blocks)
        changed_blocks[-1].fill_(False)
    return changed_blocks


def slab_rows(block_cap: int, n: int = 1) -> int:
    """Compact rows of an update: ``block_cap + 1`` padded to a multiple of
    8·n (the 8-row slab, and ``n`` equal chunks of a sharded update)."""
    return -(-(block_cap + 1) // (8 * n)) * (8 * n)


def esdf_update(cfg: TSDFConfig, max_sweeps: int, block_cap: int, state,
                prev_esdf, prev_fixed, active_submap: int, dirty_blocks=None,
                _ablate: str = "", tsdf_src=None, obs_src=None):
    """ESDF over the active submap's observed voxels, block mode: see
    :func:`esdf_update_ref`, which CPU tensors take. On the card one graph
    replay (``ops/graphs.py``) with K3's cooperative launch (or K2's
    per-sweep launches) inside; ``dirty_blocks`` is staged, the state,
    ``prev_esdf`` / ``prev_fixed`` and the seed sources are read and
    written in place."""
    if _ablate:
        raise ValueError(f"no ablation {_ablate!r} in the port")
    if graphs.eager(prev_esdf):
        return esdf_update_ref(cfg, max_sweeps, block_cap, state, prev_esdf,
                               prev_fixed, active_submap, dirty_blocks,
                               tsdf_src=tsdf_src, obs_src=obs_src)
    active = int(active_submap)
    inputs = {} if dirty_blocks is None else {
        "dirty": (dirty_blocks, torch.bool)}

    def body(w, s):
        return esdf_update_ref(cfg, max_sweeps, block_cap, state, w[0], w[1],
                               active, s.get("dirty"), tsdf_src=tsdf_src,
                               obs_src=obs_src)
    static = ("esdf_update", cfg, int(max_sweeps), int(block_cap), active,
              dirty_blocks is None, tsdf_src is None, obs_src is None)
    return ESDF_UPDATE.call(static, body, written=(prev_esdf, prev_fixed),
                            bound=graphs.leaves((state, tsdf_src, obs_src)),
                            inputs=inputs)


def esdf_update_ref(cfg: TSDFConfig, max_sweeps: int, block_cap: int, state,
                    prev_esdf, prev_fixed, active_submap: int,
                    dirty_blocks=None, _ablate: str = "", tsdf_src=None,
                    obs_src=None):
    """ESDF over the active submap's observed voxels, block mode.

    Without ``dirty_blocks`` the working set is every active block; with it,
    the dirty blocks plus their 26-ring as a frozen (Dirichlet) rim.
    ``tsdf_src`` / ``obs_src`` replace the live channels as the seed source
    (the consume-once snapshots of ``esdf_seed_dirty``). ``_ablate`` holds
    the JAX signature's place; the JAX package's ablations skip work for
    TPU profiling, the port has none, and any value but ``""`` raises.

    Returns (esdf, fixed, observed_mask, sweeps_run, changed_blocks,
    block_cap_overflow); ``esdf`` and ``fixed`` are ``prev_esdf`` and
    ``prev_fixed`` updated in place. Counts are 0-d int32 tensors.
    """
    if _ablate:
        raise ValueError(f"no ablation {_ablate!r} in the port")
    spec = cfg.grid
    V = spec.V
    nb = spec.max_blocks + 1
    dev = prev_esdf.device
    cap = block_cap
    NROWS = slab_rows(cap)
    ws = working_set(spec, state, active_submap, cap, NROWS, dirty_blocks)

    tsdf_full = state.channels["TSDF"] if tsdf_src is None else tsdf_src
    obs_full = (state.channels["TSDF_observed"] > 0 if obs_src is None
                else obs_src)
    participate_full = obs_full & ws.blk[:, None]
    slot_l = ws.slot_of.long()

    def gcomp(arr, fill):
        out = torch.where(ws.bvalid[:, None], arr[slot_l],
                          torch.full((), fill, dtype=arr.dtype, device=dev))
        pad = torch.full((NROWS - cap,) + tuple(out.shape[1:]), fill,
                         dtype=arr.dtype, device=dev)
        return torch.cat([out, pad], dim=0)

    tsdf = gcomp(tsdf_full, 0).float()
    participate = gcomp(participate_full, False)
    prev_e = gcomp(prev_esdf, 0.0)
    prev_f = gcomp(prev_fixed, 0)
    fixed, esdf0 = seed_field(cfg, tsdf, participate, prev_e, prev_f)
    nslots, updatable = ws.nslots, ws.updatable

    esdf0_h = _to_sweep_layout(esdf0, V, 0.0)
    enc_hh = _assemble_sweep(_to_sweep_layout(
        torch.where(participate, tsdf, ENC_BIG), V, ENC_BIG), nslots, V)
    kw = sweep_kw(cfg)

    if max_sweeps >= 2 and not cfg.esdf_force_sweeps:
        ss = max_sweeps if cfg.esdf_scan_sweeps < 0 else cfg.esdf_scan_sweeps
        esdf_h, lstats = esdf_sweep_loop(
            esdf0_h, enc_hh, nslots, updatable.to(torch.int32),
            eps_conv=cfg.esdf_converge_eps, max_sweeps=max_sweeps,
            scan_sweeps=ss, scan_period=cfg.esdf_scan_period, **kw)
        sweeps = lstats[0]
    else:
        # per-sweep path: the sweep counter advances only while the field
        # still changes; converged sweeps pass through (all slabs idle)
        side_hh = update_sides(ws, V, tsdf, participate, fixed)
        upd_prefix = torch.arange(NROWS, device=dev) < ws.n_upd
        esdf_h = esdf0_h
        changed = torch.ones((), dtype=torch.bool, device=dev)
        sweeps = torch.zeros((), dtype=torch.int32, device=dev)
        act = torch.ones((NROWS,), dtype=torch.bool, device=dev)
        nsl_l = nslots.long()
        for s in range(max_sweeps):
            eh = _assemble_sweep(esdf_h, nslots, V)
            slab_act = (act & upd_prefix).view(-1, 8).any(dim=1).to(
                torch.int32)
            new = esdf_sweep(eh, enc_hh, side_hh, slab_act,
                             with_scans=scan_this_sweep(cfg, s), **kw)
            diff_rows = ((new - eh).abs() >
                         float(np.float32(cfg.esdf_converge_eps))
                         ).any(dim=2).any(dim=1)
            act_next = diff_rows | diff_rows[nsl_l].any(dim=0)
            changed_next = diff_rows.any()
            if cfg.esdf_force_sweeps:
                changed_next = torch.ones_like(changed_next)
                act_next = torch.ones_like(act_next)
            sweeps = sweeps + changed.to(torch.int32)
            esdf_h, changed, act = new, changed_next, act_next
    esdf_c = _from_sweep_layout(esdf_h, V)

    # scatter back; rows outside the working set keep their previous
    # values. Non-updatable rows aim at the garbage row, restored after.
    g = nb - 1
    tgt = torch.where(updatable[:cap], slot_l, g)
    keep_e, keep_f = prev_esdf[g].clone(), prev_fixed[g].clone()
    prev_esdf[tgt] = torch.where(participate[:cap], esdf_c[:cap], 0.0)
    prev_fixed[tgt] = (participate[:cap] & fixed[:cap]).to(prev_fixed.dtype)
    prev_esdf[g] = keep_e
    prev_fixed[g] = keep_f

    # re-queue: changed rows re-enter; a changed boundary shell also
    # re-queues the block's 26 neighbours
    changed_blocks = requeue(cfg, ws, esdf_c, prev_e, fixed, prev_f,
                             dirty_blocks is not None)
    return (prev_esdf, prev_fixed, participate_full, sweeps, changed_blocks,
            ws.overflow)


# ---------------------------------------------------------------------------
# z-slice export
# ---------------------------------------------------------------------------

def _slice_unit(name, ref, cfg, capacity, block_cap, state, esdf,
                participate, base_R, base_T, active_submap, z, dz):
    """``ref(...)`` on CPU state, else one replay of the slice export's
    unit under the key ``name``."""
    if graphs.eager(esdf):
        return ref(cfg, capacity, block_cap, state, esdf, participate, base_R,
                   base_T, active_submap, z, dz)
    active = int(active_submap)

    def body(w, s):
        return ref(cfg, capacity, block_cap, state, esdf, participate,
                   s["base_R"], s["base_T"], active, z, dz)
    static = (name, cfg, int(capacity), int(block_cap), active, float(z),
              float(dz))
    return SLICE_EXPORT.call(
        static, body, bound=graphs.leaves((state, esdf, participate)),
        inputs={"base_R": (base_R, torch.float32),
                "base_T": (base_T, torch.float32)})


def esdf_slice_export(cfg: TSDFConfig, capacity: int, block_cap: int, state,
                      esdf, participate, base_R, base_T, active_submap: int,
                      z: float, dz: float):
    """Observed ESDF voxels whose signed z-index k lies in
    ``(int(z/voxel) - dz, int(z/voxel) + dz)``, compacted in linear-index
    order, colored by jet over [-max_ray/4, max_ray/4]. Returns (x, y, z,
    esdf, color (capacity, 3), kept), each padded to ``capacity``. CPU
    state: :func:`esdf_slice_export_ref`; on the card one graph replay
    (``ops/graphs.py``), the base poses (host arrays or tensors) staged."""
    return _slice_unit("esdf_slice_export", esdf_slice_export_ref, cfg,
                       capacity, block_cap, state, esdf, participate, base_R,
                       base_T, active_submap, z, dz)


def esdf_slice_export_packed(cfg: TSDFConfig, capacity: int, block_cap: int,
                             state, esdf, participate, base_R, base_T,
                             active_submap: int, z: float, dz: float):
    """:func:`esdf_slice_export` as one buffer (``exports.pack_export``:
    xyz, esdf, color, kept), from the same unit. CPU state:
    :func:`esdf_slice_export_packed_ref`."""
    return _slice_unit("esdf_slice_export_packed",
                       esdf_slice_export_packed_ref, cfg, capacity,
                       block_cap, state, esdf, participate, base_R, base_T,
                       active_submap, z, dz)


def esdf_slice_export_packed_ref(cfg: TSDFConfig, capacity: int,
                                 block_cap: int, state, esdf, participate,
                                 base_R, base_T, active_submap: int,
                                 z: float, dz: float):
    """The eager body of :func:`esdf_slice_export_packed`."""
    from taichislam_tpu_torch.ops.exports import pack_export
    x, y, zc, e, col, kept = esdf_slice_export_ref(
        cfg, capacity, block_cap, state, esdf, participate, base_R, base_T,
        active_submap, z, dz)
    return pack_export((x, y, zc), e, col, kept)


def esdf_slice_export_ref(cfg: TSDFConfig, capacity: int, block_cap: int,
                          state, esdf, participate, base_R, base_T,
                          active_submap: int, z: float, dz: float):
    """The eager body of :func:`esdf_slice_export` (every device); base
    poses not on the state's device are moved there."""
    from taichislam_tpu_torch.core.colormap import color_from_colormap
    from taichislam_tpu_torch.ops.exports import (_compact_blocks,
                                                  _gathered_ijk_c,
                                                  _gathered_xyz_c,
                                                  _intra_offsets)
    spec = cfg.grid
    nb = spec.max_blocks + 1
    V3 = spec.voxels_per_block
    dev = esdf.device
    base_R = graphs.to_device(base_R, dev, np.float32)
    base_T = graphs.to_device(base_T, dev, np.float32)
    base = block_origin_voxel(spec, state.block_coords)        # (nb, 3)
    kidx = (base[:, 2:3] + _intra_offsets(spec.V, dev)[None, :, 2]).float()
    lo, hi = _slice_bounds(cfg, z, dz)
    pre_mask = participate.reshape(nb, V3) & (kidx > lo) & (kidx < hi)

    slot_of, bvalid, _, _ = _compact_blocks(spec, pre_mask, block_cap)
    coords, ijk_c = _gathered_ijk_c(spec, state, slot_of)
    x, y, zc = _gathered_xyz_c(spec, coords, ijk_c, base_R, base_T,
                               cfg.is_global_map)
    sl = slot_of.long()
    mask = pre_mask[sl] & bvalid[:, None]
    esdf_g = esdf.reshape(nb, V3)[sl]
    outs, kept, _ = compact_sort(
        mask.reshape(-1), capacity,
        [x.reshape(-1), y.reshape(-1), zc.reshape(-1), esdf_g.reshape(-1)],
        [-100000.0, -100000.0, -100000.0, 0.0])
    rng = cfg.max_ray_length / 4.0
    col = color_from_colormap(outs[3], -rng, rng)
    col = torch.where((torch.arange(capacity, device=dev) < kept)[:, None],
                      col, torch.full((), 0.5, device=dev))
    return outs[0], outs[1], outs[2], outs[3], col, kept


def _slice_bounds(cfg: TSDFConfig, z: float, dz: float):
    """The z-index window of a slice in f32, as the jitted JAX exports
    compute it: ``trunc(z / voxel)`` with the reciprocal multiply."""
    f32 = np.float32
    zindex = np.trunc(f32(z) * f32(inv(cfg.voxel_scale)))
    return float(zindex - f32(dz)), float(zindex + f32(dz))


# ---------------------------------------------------------------------------
# dense-window sweep mode
# ---------------------------------------------------------------------------

_SWEEP_CHECK = 2   # sweeps between host reads of the loop's active flag


def _dshift(x, s, axis, fill):
    """Shift a dense 3-D grid by ``s`` along ``axis``, filling vacated
    cells with ``fill``."""
    W_ = x.shape[axis]
    out = torch.full_like(x, fill)
    if s > 0:
        out.narrow(axis, s, W_ - s).copy_(x.narrow(axis, 0, W_ - s))
    else:
        out.narrow(axis, 0, W_ + s).copy_(x.narrow(axis, -s, W_ + s))
    return out


def _dense_extrema(h, op, fill):
    """Class-wise 26-neighbourhood extrema (faces, edges, corners)."""
    ax = op(_dshift(h, 1, 0, fill), _dshift(h, -1, 0, fill))
    ay = op(_dshift(h, 1, 1, fill), _dshift(h, -1, 1, fill))
    az = op(_dshift(h, 1, 2, fill), _dshift(h, -1, 2, fill))
    faces = op(op(ax, ay), az)
    exy = op(_dshift(ax, 1, 1, fill), _dshift(ax, -1, 1, fill))
    exz = op(_dshift(ax, 1, 2, fill), _dshift(ax, -1, 2, fill))
    eyz = op(_dshift(ay, 1, 2, fill), _dshift(ay, -1, 2, fill))
    edges = op(op(exy, exz), eyz)
    corners = op(_dshift(exy, 1, 2, fill), _dshift(exy, -1, 2, fill))
    return faces, edges, corners


def _dbl_seg_scan(w, brk, shift_fn, n_steps, big):
    """Inclusive segmented min by Hillis-Steele doubling: a flagged
    position contributes its own value but blocks everything behind it."""
    m, b = w, brk
    s = 1
    for _ in range(n_steps):
        m = torch.minimum(m, torch.where(b, big, shift_fn(m, s, big)))
        b = b | shift_fn(b, s, True)
        s *= 2
    return m


def _dense_scan_candidates(h, brk, v1, big):
    """Full-window multi-hop axis min-plus candidates (self-excluded) on a
    dense (X, Y, Z) grid. The products ``pos·v1`` are rounded on their own:
    XLA does not contract them into the adds here."""
    out = torch.full_like(h, big)
    for axis in range(3):
        W_ = h.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = W_
        pos = torch.arange(W_, dtype=h.dtype, device=h.device).reshape(shape)
        pv = pos * v1
        n_steps = max(1, int(np.ceil(np.log2(W_))))

        def sh_f(x, s, fill, axis=axis):
            return _dshift(x, s, axis, fill)

        def sh_b(x, s, fill, axis=axis):
            return _dshift(x, -s, axis, fill)

        incl_f = _dbl_seg_scan(h - pv, brk, sh_f, n_steps, big) + pv
        incl_b = _dbl_seg_scan(h + pv, brk, sh_b, n_steps, big) - pv
        out = torch.minimum(out, torch.minimum(sh_f(incl_f, 1, big) + v1,
                                               sh_b(incl_b, 1, big) + v1))
    return out


def _dense_consts(cfg: TSDFConfig):
    """The dense sweep's f32 constants: v1, v2, v3, eps, max_ray, gamma,
    eps_conv."""
    f32 = np.float32
    gamma = float(f32(cfg.voxel_scale))
    return dict(
        v1=gamma, v2=float(f32(np.sqrt(2.0) * cfg.voxel_scale)),
        v3=float(f32(np.sqrt(3.0) * cfg.voxel_scale)),
        eps=float(f32(max(cfg.esdf_raise_slack_voxels * cfg.voxel_scale,
                          1e-4))),
        max_ray=float(f32(cfg.max_ray_length)), gamma=gamma,
        eps_conv=float(f32(cfg.esdf_converge_eps)))


def _dense_setup(cfg: TSDFConfig, dims_blocks, state, prev_esdf, prev_fixed,
                 active_submap: int, dirty_blocks, tsdf_src, obs_src):
    """Everything before the sweep loop of :func:`esdf_update_dense`: the
    window, the dense seeds, sides and sources, and the loop's carry
    (``esdf``, the ``active`` flag and the ``sweeps`` count), which
    :func:`_dense_sweeps` updates in place. Returns a dict of tensors."""
    spec = cfg.grid
    V = spec.V
    V3 = spec.voxels_per_block
    DBX, DBY, DBZ = dims_blocks
    NBD = DBX * DBY * DBZ
    dev = prev_esdf.device
    k = _dense_consts(cfg)
    gamma, max_ray = k["gamma"], k["max_ray"]

    c4 = state.block_coords
    blk = state.block_active & (c4[:, 0] == int(active_submap))
    blk[-1].fill_(False)
    if dirty_blocks is None:
        anchor = blk
        ring = 0
    else:
        anchor = blk & dirty_blocks
        anchor[-1].fill_(False)
        ring = 1
    huge = 1 << 20
    org = torch.where(anchor[:, None], c4[:, 1:4],
                      torch.full_like(c4[:, 1:4], huge)).amin(dim=0) - ring
    dbi, dbj, dbk = (c4[:, 1 + a] - org[a] for a in range(3))
    in_win = blk & (dbi >= 0) & (dbi < DBX) & (dbj >= 0) & (dbj < DBY) & \
        (dbk >= 0) & (dbk < DBZ)
    in_core = (dbi >= ring) & (dbi < DBX - ring) & (dbj >= ring) & \
        (dbj < DBY - ring) & (dbk >= ring) & (dbk < DBZ - ring)
    overflow = (anchor & ~in_core).sum(dtype=torch.int32)
    dlin = torch.where(in_win, (dbi * DBY + dbj) * DBZ + dbk,
                       torch.full_like(dbi, NBD)).long()
    X, Y, Z = DBX * V, DBY * V, DBZ * V

    def to_dense(rows, fill):
        d = torch.full((NBD + 1, V3), fill, dtype=rows.dtype, device=dev)
        d[dlin] = rows
        d = d[:NBD].reshape(DBX, DBY, DBZ, V, V, V).permute(0, 3, 1, 4, 2, 5)
        return d.reshape(X, Y, Z)

    tsdf_full_src = state.channels["TSDF"] if tsdf_src is None else tsdf_src
    obs_full_src = (state.channels["TSDF_observed"] > 0 if obs_src is None
                    else obs_src)
    tsdf = to_dense(tsdf_full_src, 0).float()
    obs = to_dense(obs_full_src & in_win[:, None], False)
    prev_e = to_dense(prev_esdf, 0.0)
    prev_f = to_dense(prev_fixed, 0)

    participate = obs
    fixed = participate & (tsdf.abs() < gamma)
    seed = torch.where(fixed, tsdf, sign(tsdf) * max_ray)
    prev_ok = (torch.sign(prev_e) == torch.sign(seed)) & participate & \
        (prev_e != 0) & ~((prev_f > 0) & ~fixed)
    esdf0 = torch.where(fixed, seed,
                        torch.where(prev_ok,
                                    torch.clamp(prev_e, -max_ray, max_ray),
                                    seed))
    esdf0 = torch.where(participate, esdf0, 0.0)

    pos_side = participate & ~fixed & (tsdf >= 0)
    neg_side = participate & ~fixed & (tsdf < 0)
    pos_src = participate & (fixed | (tsdf >= gamma))
    neg_src = participate & (fixed | (tsdf <= -gamma))
    if dirty_blocks is not None:
        # freeze the in-window non-dirty blocks (Dirichlet rim)
        wb = torch.zeros((NBD + 1,), dtype=torch.bool, device=dev)
        wb[dlin] = anchor
        upd = wb[:NBD].reshape(DBX, 1, DBY, 1, DBZ, 1).expand(
            DBX, V, DBY, V, DBZ, V).reshape(X, Y, Z)
        pos_side &= upd
        neg_side &= upd
    return dict(
        blk=blk, anchor=anchor, in_win=in_win, dlin=dlin, overflow=overflow,
        participate_full=obs_full_src & blk[:, None], fixed=fixed,
        participate=participate,
        pos_side=pos_side, neg_side=neg_side, pos_src=pos_src,
        neg_src=neg_src, brk_lo=~pos_src | fixed, brk_hi=~neg_src | fixed,
        esdf=esdf0, active=torch.ones((), dtype=torch.bool, device=dev),
        sweeps=torch.zeros((), dtype=torch.int32, device=dev))


def _dense_sweeps(cfg: TSDFConfig, d, n: int):
    """``n`` sweeps of the JAX while-loop's body on the carry of
    :func:`_dense_setup`, IN PLACE: a sweep changes the field and counts
    only while ``active`` (the previous sweep changed the field)."""
    k = _dense_consts(cfg)
    v1, v2, v3c, eps = k["v1"], k["v2"], k["v3"], k["eps"]
    max_ray = k["max_ray"]
    pos_src, neg_src = d["pos_src"], d["neg_src"]
    for _ in range(n):
        esdf = d["esdf"]
        lo = torch.where(pos_src, esdf, BIG)
        hi = torch.where(neg_src, esdf, -BIG)
        fl, el, cl = _dense_extrema(lo, torch.minimum, BIG)
        fh, eh, ch = _dense_extrema(hi, torch.maximum, -BIG)
        cand_lo = torch.minimum(torch.minimum(fl + v1, el + v2), cl + v3c)
        cand_hi = torch.maximum(torch.maximum(fh - v1, eh - v2), ch - v3c)
        cand_lo = torch.minimum(cand_lo, _dense_scan_candidates(
            lo, d["brk_lo"], v1, BIG))
        cand_hi = torch.maximum(cand_hi, -_dense_scan_candidates(
            -hi, d["brk_hi"], v1, BIG))
        new = torch.where(cand_lo <= esdf + eps, torch.minimum(esdf, cand_lo),
                          torch.clamp(cand_lo, max=max_ray))
        new = torch.where(d["pos_side"], new, esdf)
        new_n = torch.where(cand_hi >= esdf - eps,
                            torch.maximum(esdf, cand_hi),
                            torch.clamp(cand_hi, min=-max_ray))
        new = torch.where(d["neg_side"], new_n, new)
        changed = ((new - esdf).abs() > k["eps_conv"]).any()
        active = d["active"]
        esdf.copy_(torch.where(active, new, esdf))
        d["sweeps"].add_(active.to(torch.int32))
        active.logical_and_(changed)


def _dense_finish(cfg: TSDFConfig, dims_blocks, d, prev_esdf, prev_fixed,
                  incremental: bool):
    """Everything after the sweep loop of :func:`esdf_update_dense`: the
    field back to rows, the kept rows merged over the previous field, and
    the changed (and, incrementally, woken) blocks. Returns its six
    outputs."""
    spec = cfg.grid
    V = spec.V
    V3 = spec.voxels_per_block
    DBX, DBY, DBZ = dims_blocks
    NBD = DBX * DBY * DBZ
    dev = prev_esdf.device
    eps_conv = _dense_consts(cfg)["eps_conv"]
    dlin, in_win, blk, anchor = d["dlin"], d["in_win"], d["blk"], d["anchor"]

    def from_dense(x):
        rows = x.reshape(DBX, V, DBY, V, DBZ, V).permute(
            0, 2, 4, 1, 3, 5).reshape(NBD, V3)
        rows = torch.cat([rows, torch.zeros((1, V3), dtype=x.dtype,
                                            device=dev)])
        return rows[dlin]

    esdf_rows = from_dense(d["esdf"])
    fixed_rows = from_dense(d["fixed"].to(torch.int8))
    part_rows = from_dense(d["participate"])

    participate_full = d["participate_full"]
    keep = in_win[:, None] & part_rows
    if incremental:
        keep &= anchor[:, None]          # frozen rim rows pass through
    esdf_out = torch.where(keep, esdf_rows,
                           torch.where(participate_full, prev_esdf, 0.0))
    fixed_out = torch.where(keep, fixed_rows,
                            torch.where(participate_full, prev_fixed,
                                        0).to(torch.int8))
    rowdiff = keep & (((esdf_rows - prev_esdf).abs() > eps_conv) |
                      (fixed_rows != prev_fixed))
    changed_blocks = rowdiff.any(dim=1)
    changed_blocks[-1].fill_(False)
    if incremental:
        # a dirty block whose boundary shell changed wakes its
        # 26-neighbourhood next frame (dilation on the window-block grid)
        shell_row = (rowdiff & _shell_mask(V, dev)[None, :]).any(dim=1)
        wchg = torch.zeros((NBD + 1,), dtype=torch.bool, device=dev)
        wchg[dlin] = shell_row
        wchg = wchg[:NBD].reshape(DBX, DBY, DBZ)
        for ax in range(3):
            wchg = wchg | _dshift(wchg, -1, ax, False) | \
                _dshift(wchg, 1, ax, False)
        wake = wchg.reshape(-1)[torch.clamp(dlin, max=NBD - 1)] & in_win
        changed_blocks = changed_blocks | (blk & wake)
        changed_blocks[-1].fill_(False)
    return esdf_out, fixed_out, participate_full, d["sweeps"], \
        changed_blocks, d["overflow"]


def _dense_loop(max_sweeps: int, d, run_chunk):
    """The JAX while-loop on the host's schedule: chunks of
    ``_SWEEP_CHECK`` masked sweeps (``run_chunk(n)``), and before every
    chunk but the first one host read of the device's ``active`` flag, so
    the sweep count equals the while-loop's."""
    for s0 in range(0, max_sweeps, _SWEEP_CHECK):
        if s0 > 0 and not bool(host_read("esdf.dense_active", d["active"])):
            break
        run_chunk(min(_SWEEP_CHECK, max_sweeps - s0))


def esdf_update_dense_ref(cfg: TSDFConfig, max_sweeps: int, dims_blocks,
                          state, prev_esdf, prev_fixed, active_submap: int,
                          dirty_blocks=None, tsdf_src=None, obs_src=None):
    """The eager body of :func:`esdf_update_dense` (every device)."""
    d = _dense_setup(cfg, dims_blocks, state, prev_esdf, prev_fixed,
                     active_submap, dirty_blocks, tsdf_src, obs_src)
    _dense_loop(max_sweeps, d, lambda n: _dense_sweeps(cfg, d, n))
    return _dense_finish(cfg, dims_blocks, d, prev_esdf, prev_fixed,
                         dirty_blocks is not None)


def esdf_update_dense(cfg: TSDFConfig, max_sweeps: int, dims_blocks, state,
                      prev_esdf, prev_fixed, active_submap: int,
                      dirty_blocks=None, tsdf_src=None, obs_src=None):
    """Dense-window variant of :func:`esdf_update` (same returns, same
    optional consume-once seed source).

    ``dims_blocks`` is the (DBX, DBY, DBZ) window in blocks; its origin is
    the minimum coordinate of the participating blocks (with
    ``dirty_blocks``: of the dirty blocks, less a one-block ring, and the
    in-window non-dirty blocks are frozen Dirichlet sources). Participating
    (dirty) blocks that do not fit are counted in the overflow. The sweep
    loop runs on the device with an ``active`` flag, so the sweep count
    equals the JAX while-loop's; the host reads the flag every
    ``_SWEEP_CHECK`` sweeps to stop early. Returns new tensors.

    CPU state: :func:`esdf_update_dense_ref`. On the card three graphs of
    ``ops/graphs.py`` per key: the set-up, one chunk of ``_SWEEP_CHECK``
    sweeps (a shorter last chunk its own graph), replayed until the flag
    reads false, and the finish; ``dirty_blocks`` is staged."""
    if graphs.eager(prev_esdf):
        return esdf_update_dense_ref(cfg, max_sweeps, dims_blocks, state,
                                     prev_esdf, prev_fixed, active_submap,
                                     dirty_blocks, tsdf_src, obs_src)
    dims = tuple(int(x) for x in dims_blocks)
    active = int(active_submap)
    incremental = dirty_blocks is not None
    inputs = {"dirty": (dirty_blocks, torch.bool)} if incremental else {}
    tensors = graphs.leaves((state, prev_esdf, prev_fixed, tsdf_src,
                             obs_src))
    static = ("esdf_update_dense", cfg, int(max_sweeps), dims, active,
              incremental, tsdf_src is None, obs_src is None)
    unit = ESDF_DENSE
    with unit.lock:
        e, first = unit.enter(static, tensors, inputs)
        if first:
            with graphs.bodies():
                return esdf_update_dense_ref(
                    cfg, max_sweeps, dims, state, prev_esdf, prev_fixed,
                    active, e.slots.get("dirty"), tsdf_src, obs_src)
        d = unit.run(e, "setup", lambda: _dense_setup(
            cfg, dims, state, prev_esdf, prev_fixed, active,
            e.slots.get("dirty"), tsdf_src, obs_src), tensors)
        _dense_loop(max_sweeps, d, lambda n: unit.run(
            e, f"sweeps{n}", lambda: _dense_sweeps(cfg, d, n), tensors))
        out = unit.run(e, "finish", lambda: _dense_finish(
            cfg, dims, d, prev_esdf, prev_fixed, incremental), tensors)
        return graphs.detach(out, tensors)
