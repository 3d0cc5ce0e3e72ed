"""Export and serialization ops: surface voxels, slices, sparse gather and
scatter (PyTorch).

Counterpart of the JAX package's ``ops/exports.py``. Every export is two-level:
the blocks holding a candidate voxel are compacted first (a prefix sum
over the block list), then the voxels of those ``block_cap × V³`` lanes
are compacted in linear-index order, so the output arrays equal the JAX
package's element for element. The world position sum
``R0·l0 + R1·l1 + R2·l2 + T`` is contracted as XLA contracts it (``dot3``).

On the card ``tsdf_surface_export`` is a unit of ``ops/graphs.py``: one
CUDA graph replay per call; its ``*_ref`` twin is the eager body, which
CPU tensors take. Each export has a ``*_packed`` variant, the one the
models call: its outputs in one buffer in the host layout
(:func:`pack_export`), which the host reads in one copy
(:func:`unpack_export`).

The byte layouts of ``sparse_gather_packed``, ``bitmap_gather_packed``
and the numpy decoders are those of the JAX package, so a map or submap
exported by one package loads in the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from taichislam_tpu_torch.core.colormap import color_from_colormap
from taichislam_tpu_torch.core.compaction import compact_mask, compact_sort
from taichislam_tpu_torch.core.config import GridSpec, TSDFConfig
from taichislam_tpu_torch.core.geometry import dot3
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            block_origin_voxel,
                                            comp_flat_index,
                                            flat_voxel_index, lookup_slots,
                                            voxel_to_block_c)
from taichislam_tpu_torch.ops import graphs
from taichislam_tpu_torch.utils.profiling import host_read


@functools.lru_cache(maxsize=8)
def _intra_offsets_np(V: int) -> np.ndarray:
    r = np.arange(V)
    ii, jj, kk = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([ii, jj, kk], -1).reshape(-1, 3).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _intra_offsets(V: int, device) -> torch.Tensor:
    """(V³, 3) int32 (i, j, k) of every voxel of a block, on ``device``."""
    return torch.from_numpy(_intra_offsets_np(V)).to(device)


def voxel_ijk_all(spec: GridSpec, state: GridState) -> torch.Tensor:
    """Signed voxel index of every (slot, voxel): (nb, V³, 3) int32."""
    base = block_origin_voxel(spec, state.block_coords)
    return base[:, None, :] + _intra_offsets(spec.V, base.device)[None]


def voxel_xyz_all(spec: GridSpec, state: GridState, base_R, base_T,
                  is_global: bool) -> torch.Tensor:
    """World position of every voxel centre, (nb, V³, 3): the submap-local
    centre through the submap's base pose (identity for the global map)."""
    ijk = voxel_ijk_all(spec, state)
    loc = [ijk[..., a].float() * spec.voxel_scale for a in range(3)]
    if is_global:
        return torch.stack(loc, -1)
    s = torch.clamp(state.block_coords[:, 0], 0, base_R.shape[0] - 1).long()
    return torch.stack(_pose_xyz(base_R, base_T, s, loc), -1)


def _pose_xyz(base_R, base_T, s, loc):
    R, T = base_R[s], base_T[s]
    return [dot3(R[:, a, 0, None], loc[0], R[:, a, 1, None], loc[1],
                 R[:, a, 2, None], loc[2]) + T[:, a, None]
            for a in range(3)]


def _active_voxel_mask(spec: GridSpec, state: GridState, active_submap: int,
                       require_submap: bool = True) -> torch.Tensor:
    blk = state.block_active.clone()
    if require_submap:
        blk &= state.block_coords[:, 0] == int(active_submap)
    blk[-1].fill_(False)
    return blk[:, None].expand(blk.shape[0], spec.voxels_per_block)


def _compact_blocks(spec: GridSpec, vox_mask, block_cap: int):
    """Compact the blocks holding any set voxel of ``vox_mask`` (nb, V³).
    Returns (slot_of (cap,) int32 storage slot per compacted row, garbage
    slot past the kept ones; bvalid (cap,); kept; dropped)."""
    nb = vox_mask.shape[0]
    bpos, bkept, btotal = compact_mask(vox_mask.any(dim=1), block_cap)
    slot_of = torch.full((block_cap + 1,), nb - 1, dtype=torch.int32,
                         device=vox_mask.device)
    slot_of[bpos.long()] = torch.arange(nb, dtype=torch.int32,
                                        device=vox_mask.device)
    slot_of = slot_of[:block_cap]
    bvalid = torch.arange(block_cap, device=vox_mask.device) < bkept
    return slot_of, bvalid, bkept, torch.clamp(btotal - block_cap, min=0)


def _gathered_ijk_c(spec: GridSpec, state: GridState, slot_of):
    """(coords (cap, 4), [i, j, k] each (cap, V³) int32) of the compacted
    blocks' voxels."""
    coords = state.block_coords[slot_of.long()]
    origin = block_origin_voxel(spec, coords)
    off = _intra_offsets(spec.V, coords.device)
    return coords, [origin[:, a:a + 1] + off[None, :, a] for a in range(3)]


def _gathered_xyz_c(spec: GridSpec, coords, ijk_c, base_R, base_T,
                    is_global: bool):
    """World xyz components of the compacted voxels."""
    loc = [c.float() * spec.voxel_scale for c in ijk_c]
    if is_global:
        return loc
    s = torch.clamp(coords[:, 0], 0, base_R.shape[0] - 1).long()
    return _pose_xyz(base_R, base_T, s, loc)


SURFACE_EXPORT = graphs.UnitCache("tsdf_surface_export", size=2)


def pack_export(xyz, values, color, kept):
    """An export's outputs in one f32 buffer, in the host layout: the
    ``xyz`` columns as (capacity, 3) row-major, ``values`` (capacity,)
    unless None, ``color`` (capacity, 3), then ``kept``'s int32 bits.
    Read it with :func:`unpack_export`."""
    parts = [torch.stack(xyz, -1).reshape(-1).float()]
    if values is not None:
        parts.append(values.float())
    parts += [color.reshape(-1).float(),
              kept.reshape(1).to(torch.int32).view(torch.float32)]
    return torch.cat(parts)


def unpack_export(buf, capacity: int, with_values: bool, site: str):
    """Host-side inverse of :func:`pack_export`: (xyz (capacity, 3), values
    (capacity,) or None, color (capacity, 3), kept), numpy views of the
    buffer, read once under ``site`` (from the card into pinned memory,
    ``host_read(pinned=True)``): the views keep that block from the
    allocator while any of them lives."""
    buf = host_read(site, buf, pinned=True).numpy()
    c = capacity
    xyz = buf[:3 * c].reshape(c, 3)
    o = 3 * c
    values = None
    if with_values:
        values = buf[o:o + c]
        o += c
    color = buf[o:o + 3 * c].reshape(c, 3)
    return xyz, values, color, int(buf[o + 3 * c:].view(np.int32)[0])


def _surface_unit(name, ref, cfg, capacity, block_cap, state, base_R, base_T,
                  active_submap):
    """``ref(...)`` on CPU state, else one replay of the surface export's
    unit under the key ``name``."""
    if graphs.eager(state.table):
        return ref(cfg, capacity, block_cap, state, base_R, base_T,
                   active_submap)
    active = int(active_submap)

    def body(w, s):
        return ref(cfg, capacity, block_cap, state, s["base_R"], s["base_T"],
                   active)
    return SURFACE_EXPORT.call(
        (name, cfg, int(capacity), int(block_cap), active),
        body, bound=graphs.leaves((state,)),
        inputs={"base_R": (base_R, torch.float32),
                "base_T": (base_T, torch.float32)})


def tsdf_surface_export(cfg: TSDFConfig, capacity: int, block_cap: int,
                        state: GridState, base_R, base_T,
                        active_submap: int):
    """Observed voxels of the active submap with ``|TSDF| <
    tsdf_surface_thres`` and world z within [disp_floor, disp_ceiling].
    Returns (x, y, z, color (capacity, 3), tsdf, kept), padded to
    ``capacity``; colors are the texture, or jet by height. CPU state:
    :func:`tsdf_surface_export_ref`; on the card one graph replay
    (``ops/graphs.py``), the base poses (host arrays or tensors) staged."""
    return _surface_unit("tsdf_surface_export", tsdf_surface_export_ref,
                         cfg, capacity, block_cap, state, base_R, base_T,
                         active_submap)


def tsdf_surface_export_packed(cfg: TSDFConfig, capacity: int,
                               block_cap: int, state: GridState, base_R,
                               base_T, active_submap: int):
    """:func:`tsdf_surface_export` as one buffer (:func:`pack_export`:
    xyz, tsdf, color, kept), from the same unit. CPU state:
    :func:`tsdf_surface_export_packed_ref`."""
    return _surface_unit("tsdf_surface_export_packed",
                         tsdf_surface_export_packed_ref, cfg, capacity,
                         block_cap, state, base_R, base_T, active_submap)


def tsdf_surface_export_packed_ref(cfg: TSDFConfig, capacity: int,
                                   block_cap: int, state: GridState, base_R,
                                   base_T, active_submap: int):
    """The eager body of :func:`tsdf_surface_export_packed`."""
    x, y, z, col, tsdf, kept = tsdf_surface_export_ref(
        cfg, capacity, block_cap, state, base_R, base_T, active_submap)
    return pack_export((x, y, z), tsdf, col, kept)


def tsdf_surface_export_ref(cfg: TSDFConfig, capacity: int, block_cap: int,
                            state: GridState, base_R, base_T,
                            active_submap: int):
    """The eager body of :func:`tsdf_surface_export` (every device); base
    poses not on the state's device are moved there."""
    spec = cfg.grid
    ch = state.channels
    nb = spec.max_blocks + 1
    V3 = spec.voxels_per_block
    dev = state.table.device
    base_R = graphs.to_device(base_R, dev, np.float32)
    base_T = graphs.to_device(base_T, dev, np.float32)
    obs = ch["TSDF_observed"].reshape(nb, V3) == 1
    tsdf_full = ch["TSDF"].reshape(nb, V3).float()
    pre_mask = _active_voxel_mask(spec, state, active_submap) & obs & \
        (tsdf_full.abs() < float(np.float32(cfg.tsdf_surface_thres)))

    slot_of, bvalid, _, _ = _compact_blocks(spec, pre_mask, block_cap)
    coords, ijk_c = _gathered_ijk_c(spec, state, slot_of)
    x, y, z = _gathered_xyz_c(spec, coords, ijk_c, base_R, base_T,
                              cfg.is_global_map)
    sl = slot_of.long()
    mask = pre_mask[sl] & bvalid[:, None]
    mask &= (z <= float(np.float32(cfg.disp_ceiling))) & \
        (z >= float(np.float32(cfg.disp_floor)))
    ops = [x.reshape(-1), y.reshape(-1), z.reshape(-1),
           tsdf_full[sl].reshape(-1)]
    fills = [-100000.0, -100000.0, -100000.0, 0.0]
    if cfg.texture_enabled:
        colg = ch["color"][sl]
        ops += [colg[:, a, :].reshape(-1).float() for a in range(3)]
        fills += [0.5, 0.5, 0.5]
    outs, kept, _ = compact_sort(mask.reshape(-1), capacity, ops, fills)
    if cfg.texture_enabled:
        col = torch.stack(outs[4:7], -1)
    else:
        col = color_from_colormap(outs[2], cfg.disp_floor, cfg.disp_ceiling)
        col = torch.where((torch.arange(capacity, device=dev) < kept)[:, None],
                          col, torch.full((), 0.5, device=dev))
    return outs[0], outs[1], outs[2], col, outs[3], kept


def tsdf_slice_export(cfg: TSDFConfig, capacity: int, block_cap: int,
                      state: GridState, base_R, base_T, active_submap: int,
                      z: float, dz: float):
    """Observed voxels whose signed z-index k lies in
    ``(int(z/voxel) - dz, int(z/voxel) + dz)``, colored by jet over TSDF in
    [-0.5, 0.5]. Returns (x, y, z, tsdf, color, kept)."""
    from taichislam_tpu_torch.ops.esdf import _slice_bounds
    spec = cfg.grid
    ch = state.channels
    nb = spec.max_blocks + 1
    V3 = spec.voxels_per_block
    dev = state.table.device
    obs = ch["TSDF_observed"].reshape(nb, V3) > 0
    base = block_origin_voxel(spec, state.block_coords)
    kidx = (base[:, 2:3] + _intra_offsets(spec.V, dev)[None, :, 2]).float()
    lo, hi = _slice_bounds(cfg, z, dz)
    pre_mask = _active_voxel_mask(spec, state, active_submap) & obs & \
        (kidx > lo) & (kidx < hi)

    slot_of, bvalid, _, _ = _compact_blocks(spec, pre_mask, block_cap)
    coords, ijk_c = _gathered_ijk_c(spec, state, slot_of)
    x, y, zc = _gathered_xyz_c(spec, coords, ijk_c, base_R, base_T,
                               cfg.is_global_map)
    sl = slot_of.long()
    mask = pre_mask[sl] & bvalid[:, None]
    tsdf = ch["TSDF"].reshape(nb, V3)[sl].float()
    outs, kept, _ = compact_sort(
        mask.reshape(-1), capacity,
        [x.reshape(-1), y.reshape(-1), zc.reshape(-1), tsdf.reshape(-1)],
        [-100000.0, -100000.0, -100000.0, 0.0])
    col = color_from_colormap(outs[3], -0.5, 0.5)
    col = torch.where((torch.arange(capacity, device=dev) < kept)[:, None],
                      col, torch.full((), 0.5, device=dev))
    return outs[0], outs[1], outs[2], outs[3], col, kept


def tsdf_slice_export_packed(cfg: TSDFConfig, capacity: int, block_cap: int,
                             state: GridState, base_R, base_T,
                             active_submap: int, z: float, dz: float):
    """:func:`tsdf_slice_export` as one buffer (:func:`pack_export`: xyz,
    tsdf, color, kept)."""
    x, y, zc, tsdf, col, kept = tsdf_slice_export(
        cfg, capacity, block_cap, state, base_R, base_T, active_submap, z,
        dz)
    return pack_export((x, y, zc), tsdf, col, kept)


def count_active(cfg: TSDFConfig, state: GridState, active_submap: int):
    """Observed voxels of the active submap (0-d int32)."""
    nb = cfg.grid.max_blocks + 1
    obs = state.channels["TSDF_observed"].reshape(nb, -1) > 0
    return (_active_voxel_mask(cfg.grid, state, active_submap) &
            obs).sum(dtype=torch.int32)


def count_active_blocks(cfg: TSDFConfig, state: GridState,
                        active_submap: int):
    """Allocated blocks of the active submap (0-d int32): a ``block_cap``
    of :func:`sparse_gather` above it covers the submap."""
    return _active_voxel_mask(cfg.grid, state, active_submap)[:, 0].sum(
        dtype=torch.int32)


def sparse_gather(cfg: TSDFConfig, capacity: int, block_cap: int,
                  state: GridState, active_submap: int):
    """The active submap's observed voxels as (indices (capacity, 3) int32,
    TSDF f32, W_TSDF f32, occupy int8, color (capacity, 3) f32 or (0, 3),
    kept, total) in linear-index order. ``block_cap`` must cover the active
    submap's allocated blocks."""
    spec = cfg.grid
    ch = state.channels
    nb = spec.max_blocks + 1
    V3 = spec.voxels_per_block
    obs = ch["TSDF_observed"].reshape(nb, V3) > 0
    pre_mask = _active_voxel_mask(spec, state, active_submap) & obs
    slot_of, bvalid, _, _ = _compact_blocks(spec, pre_mask, block_cap)
    _, ijk_c = _gathered_ijk_c(spec, state, slot_of)
    sl = slot_of.long()
    mask = pre_mask[sl] & bvalid[:, None]

    def g(name):
        return ch[name].reshape(nb, V3)[sl].reshape(-1)

    ops = [c.reshape(-1) for c in ijk_c] + [
        g("TSDF").float(), g("W_TSDF").float(), g("occupy")]
    fills = [0, 0, 0, 0.0, 0.0, 0]
    if cfg.texture_enabled:
        colg = ch["color"][sl]
        ops += [colg[:, a, :].reshape(-1).float() for a in range(3)]
        fills += [0.0, 0.0, 0.0]
    outs, kept, total = compact_sort(mask.reshape(-1), capacity, ops, fills)
    out_col = (torch.stack(outs[6:9], -1) if cfg.texture_enabled else
               torch.zeros((0, 3), device=state.table.device))
    return (torch.stack(outs[0:3], -1), outs[3], outs[4],
            outs[5].to(torch.int8), out_col, kept, total)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes (native little-endian) as a flat uint8 tensor."""
    return t.contiguous().view(torch.uint8).reshape(-1)


def sparse_gather_packed(cfg: TSDFConfig, capacity: int, block_cap: int,
                         state: GridState, active_submap: int):
    """:func:`sparse_gather` packed into one uint8 buffer at the submap wire
    dtypes: [kept, total int32 | capacity×3 int16 indices | capacity f16
    TSDF | capacity f16 W_TSDF | capacity int8 occupy | capacity×3 f16 color
    if textured], little-endian. Decode with :func:`unpack_sparse_delivery`.
    """
    idx, tsdf, w, occ, col, kept, total = sparse_gather(
        cfg, capacity, block_cap, state, active_submap)
    b = _bytes
    parts = [b(torch.stack([kept, total]).to(torch.int32)),
             b(torch.clamp(idx, -32767, 32767).to(torch.int16)),
             b(tsdf.half()), b(w.half()), b(occ)]
    if cfg.texture_enabled:
        parts.append(b(col.half()))
    return torch.cat(parts)


def bitmap_gather_packed(cfg: TSDFConfig, lane_cap: int, block_cap: int,
                         state: GridState, active_submap: int):
    """The active submap's observed voxels in the compact submap wire
    schema, one uint8 buffer (about 5.1 B per voxel): block origins, a
    per-block observed bitmap, and value planes of the observed voxels
    only, in bitmap order (block-major, voxel-linear). Layout,
    little-endian:

    ``[16 B: kept_blocks, total_blocks, kept_vox, total_vox int32]
    [block_cap × 6: block origin voxel int16 × 3]
    [block_cap × V³/8: observed bitmap uint8, voxel-linear, LSB first]
    [lane_cap × 4: (TSDF f16, W_TSDF f16) pairs] [lane_cap: occupy int8]
    [lane_cap × 6 if textured: (color0 f16, color1 f16) pairs, then
    color2 f16]``

    A ``total_*`` above its cap means the gather was truncated. Decode with
    :func:`unpack_bitmap_packed`."""
    spec = cfg.grid
    nb = spec.max_blocks + 1
    V3 = spec.voxels_per_block
    ch = state.channels
    dev = state.table.device
    obs = ch["TSDF_observed"].reshape(nb, V3) > 0
    pre_mask = _active_voxel_mask(spec, state, active_submap) & obs
    slot_of, bvalid, bkept, bdropped = _compact_blocks(spec, pre_mask,
                                                       block_cap)
    sl = slot_of.long()
    origin = torch.where(bvalid[:, None],
                         block_origin_voxel(spec, state.block_coords[sl]),
                         torch.zeros((), dtype=torch.int32, device=dev))
    mask = pre_mask[sl] & bvalid[:, None]
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=dev)
    bitmap = (mask.reshape(block_cap, V3 // 8, 8).to(torch.int32) *
              weights).sum(-1).to(torch.uint8)

    def plane(name):
        return ch[name].reshape(nb, V3)[sl].reshape(-1)

    ops = [plane("TSDF").half(), plane("W_TSDF").half(), plane("occupy")]
    fills = [0.0, 0.0, 0]
    if cfg.texture_enabled:
        colg = ch["color"][sl].half()                   # (cap, 3, V³)
        ops += [colg[:, a, :].reshape(-1) for a in range(3)]
        fills += [0.0, 0.0, 0.0]
    outs, vkept, vtotal = compact_sort(mask.reshape(-1), lane_cap, ops,
                                       fills)
    b = _bytes
    parts = [b(torch.stack([bkept, bkept + bdropped, vkept, vtotal])
               .to(torch.int32)),
             b(torch.clamp(origin, -32767, 32767).to(torch.int16)),
             bitmap.reshape(-1),
             b(torch.stack(outs[0:2], -1)), b(outs[2].to(torch.int8))]
    if cfg.texture_enabled:
        parts += [b(torch.stack(outs[3:5], -1)), b(outs[5])]
    return torch.cat(parts)


def unpack_bitmap_packed(buf, lane_cap: int, block_cap: int, V: int,
                         with_color: bool):
    """Host-side inverse of :func:`bitmap_gather_packed` (numpy views):
    (indices int16 (n, 3), tsdf f16, w f16, occ int8, color f16 (n, 3) or
    empty, kept_blocks, total_blocks, kept_vox, total_vox)."""
    if isinstance(buf, torch.Tensor):
        buf = host_read("exports.bitmap_buffer", buf).numpy()
    buf = np.asarray(buf)
    V3 = V * V * V
    kept_b, total_b, kept_v, total_v = (int(x)
                                        for x in buf[:16].view(np.int32))
    kb = min(kept_b, block_cap)
    kv = min(kept_v, lane_cap)
    o = 16
    origin = buf[o:o + block_cap * 6].view(np.int16).reshape(
        block_cap, 3)[:kb]
    o += block_cap * 6
    bits = np.unpackbits(
        buf[o:o + block_cap * (V3 // 8)].reshape(block_cap, V3 // 8)[:kb],
        axis=1, bitorder="little").astype(bool)            # (kb, V³)
    o += block_cap * (V3 // 8)
    tw = buf[o:o + lane_cap * 4].view(np.float16).reshape(lane_cap, 2)[:kv]
    o += lane_cap * 4
    occ = buf[o:o + lane_cap].view(np.int8)[:kv]
    o += lane_cap
    idx = (origin[:, None, :].astype(np.int32) +
           _intra_offsets_np(V)[None]).reshape(-1, 3)[bits.reshape(-1)][:kv]
    if with_color:
        c01 = buf[o:o + lane_cap * 4].view(np.float16).reshape(lane_cap,
                                                               2)[:kv]
        o += lane_cap * 4
        c2 = buf[o:o + lane_cap * 2].view(np.float16)[:kv]
        col = np.stack([c01[:, 0], c01[:, 1], c2], axis=-1)
    else:
        col = np.array([])
    return (np.clip(idx, -32767, 32767).astype(np.int16), tw[:, 0].copy(),
            tw[:, 1].copy(), occ, col, kept_b, total_b, kept_v, total_v)


def unpack_sparse_delivery(buf, capacity: int, with_color: bool):
    """Host-side inverse of :func:`sparse_gather_packed` (numpy views).
    Returns (indices int16 (k, 3), tsdf f16 (k,), w f16 (k,), occ int8 (k,),
    color f16 (k, 3) or empty, kept, total)."""
    if isinstance(buf, torch.Tensor):
        buf = host_read("exports.sparse_buffer", buf).numpy()
    buf = np.asarray(buf)
    kept, total = (int(x) for x in buf[:8].view(np.int32))
    k = min(kept, capacity)
    o = 8
    idx = buf[o:o + capacity * 6].view(np.int16).reshape(capacity, 3)[:k]
    o += capacity * 6
    tsdf = buf[o:o + capacity * 2].view(np.float16)[:k]
    o += capacity * 2
    w = buf[o:o + capacity * 2].view(np.float16)[:k]
    o += capacity * 2
    occ = buf[o:o + capacity].view(np.int8)[:k]
    o += capacity
    if with_color:
        col = buf[o:o + capacity * 6].view(np.float16).reshape(capacity,
                                                               3)[:k]
    else:
        col = np.array([])
    return idx, tsdf, w, occ, col, kept, total


def sparse_scatter(cfg: TSDFConfig, state: GridState, submap_id: int,
                   indices, tsdf, w_tsdf, occ, color, n_valid: int
                   ) -> GridState:
    """Scatter (indices (n, 3) signed voxel coords, TSDF, W_TSDF, occupy[,
    color (n, 3)]) into submap ``submap_id`` and mark them observed; only
    the first ``n_valid`` rows count. In place; returns the state."""
    spec = cfg.grid
    n = indices.shape[0]
    dev = state.table.device
    valid = torch.arange(n, device=dev) < int(n_valid)
    s = int(submap_id)
    ind = indices.to(torch.int32)
    blin, intra, inb = voxel_to_block_c(spec, s, ind[:, 0], ind[:, 1],
                                        ind[:, 2])
    ok = valid & inb
    state = allocate_blocks(spec, state, blin, ok, s)
    slots = lookup_slots(spec, state.table, blin)
    nvox = (spec.max_blocks + 1) * spec.voxels_per_block
    flat = torch.where(ok, flat_voxel_index(spec, slots, intra),
                       torch.full_like(slots, nvox - 1)).long()
    ch = state.channels
    ch["TSDF"].view(-1)[flat] = tsdf.to(cfg.dtype)
    ch["W_TSDF"].view(-1)[flat] = w_tsdf.to(cfg.dtype)
    ch["occupy"].view(-1)[flat] = occ.to(torch.int8)
    ch["TSDF_observed"].view(-1)[flat] = ok.to(torch.int8)
    if cfg.texture_enabled:
        colf = ch["color"].view(-1)
        for a in range(3):
            idx = torch.where(ok, comp_flat_index(spec, slots, intra, a),
                              torch.full_like(slots, colf.shape[0] - 1))
            colf[idx.long()] = color[:, a].to(cfg.dtype)
    for v in ch.values():
        v[-1] = 0
    return state


def pow2_capacity(n: int, lo: int = 1024) -> int:
    """Smallest power-of-two multiple of ``lo`` that holds ``n``."""
    c = lo
    while c < n:
        c *= 2
    return c
