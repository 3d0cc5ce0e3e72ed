"""Isosurface extraction over the block TSDF (marching tetrahedra), PyTorch.

Counterpart of the JAX package's ``ops/marching_cubes.py``. The triangulation
is generated at import from a 6-tetrahedra decomposition of the cube around its
V0-V6 diagonal (at most 2 triangles per tet, winding oriented toward positive
SDF). Extraction is three-phase:

0. compact the blocks holding a surface cell (``observed`` and ``TSDF <
   surface_thres``), optionally restricted to a per-slot ``block_mask``;
A. count each (cell, tet)'s triangles from the 8 corners, read from
   (V+2)³ halos assembled for the compacted blocks;
B. build the first ``max_triangles`` triangles in cell-major order: a
   prefix sum gives each cell its output base (a binary search of it, the
   owning cell of each triangle), vertices interpolate along
   the tet edges, normals are the central-difference TSDF gradient at the
   rounded vertex, colors interpolate the corner colors.

On the card ``dilate_blocks`` and ``extract_mesh`` are units of
``ops/graphs.py``, one CUDA graph replay per call (the JAX package's jitted
functions); their ``*_ref`` twins are the eager bodies, which CPU tensors
take.

Cells with an unobserved corner are skipped; vertices are in map-local
metres (no base pose). The interpolation ``p0 + mu·(p1 - p0)`` is
contracted as XLA contracts it, and normal lengths take a correctly
rounded sqrt.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from taichislam_tpu_torch.core.compaction import compact_mask
from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.geometry import fma, sqrt_rn
from taichislam_tpu_torch.core.grid import (block_origin_voxel,
                                            flat_voxel_index, gather_channel,
                                            lookup_slots, voxel_to_block_c)
from taichislam_tpu_torch.ops import graphs
from taichislam_tpu_torch.ops.esdf import (assemble_halo,
                                           neighbor_slot_cols,
                                           neighbor_slot_table)
from taichislam_tpu_torch.ops.exports import _intra_offsets
from taichislam_tpu_torch.utils.profiling import host_read

EPS = 1e-6

# Bourke corner layout: V0..V7
CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# 6-tet partition of the cube around the V0-V6 diagonal
TETS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int32)

_NORMAL_OFFS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], np.int32)


def _generate_tet_tables():
    """(ntri (6, 16) int32, edges (6, 16, 2, 3, 2) int32): triangles per
    (tet, inside-mask) case and the cube-corner pair of each triangle
    vertex (-1 padded), wound so cross(v1-v0, v2-v0) points to positive
    SDF."""
    ntri = np.zeros((6, 16), np.int32)
    edges = np.full((6, 16, 2, 3, 2), -1, np.int32)
    P = CUBE_CORNERS.astype(np.float64)
    for t in range(6):
        tet = TETS[t]
        pos = P[tet]
        for case in range(16):
            inside = [s for s in range(4) if case & (1 << s)]
            outside = [s for s in range(4) if not case & (1 << s)]
            tris = []
            if len(inside) == 1:
                a = inside[0]
                tris = [[(a, outside[0]), (a, outside[1]), (a, outside[2])]]
            elif len(inside) == 3:
                d = outside[0]
                tris = [[(d, inside[0]), (d, inside[1]), (d, inside[2])]]
            elif len(inside) == 2:
                a, b = inside
                c, d = outside
                tris = [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]
            if not tris:
                continue
            out_dir = pos[outside].mean(axis=0) - pos[inside].mean(axis=0)
            fixed = []
            for tri in tris:
                v = [0.5 * (pos[e0] + pos[e1]) for e0, e1 in tri]
                if np.dot(np.cross(v[1] - v[0], v[2] - v[0]), out_dir) < 0:
                    tri = [tri[0], tri[2], tri[1]]
                fixed.append(tri)
            ntri[t, case] = len(fixed)
            for k, tri in enumerate(fixed):
                for vv, (e0, e1) in enumerate(tri):
                    edges[t, case, k, vv] = (tet[e0], tet[e1])
    return ntri, edges


_NTRI, _EDGES = _generate_tet_tables()


def tet_tri_tables(device=None):
    """(ntri, edges) of the generated triangulation as int32 tensors."""
    return (torch.from_numpy(_NTRI).to(device),
            torch.from_numpy(_EDGES).to(device))


@functools.lru_cache(maxsize=8)
def _tables(device):
    """The extraction's constant tensors on ``device``, made once (a
    captured graph may then read them: it holds no host-to-device copy):
    ntri, edges, the tets (int64), the cube corners, the normal probe
    offsets and the case bit weights."""
    ntri, edges = tet_tri_tables(device)
    return dict(ntri=ntri, edges=edges,
                tets=torch.from_numpy(TETS).long().to(device),
                corners=torch.from_numpy(CUBE_CORNERS).to(device),
                offs=torch.from_numpy(_NORMAL_OFFS).to(device),
                pow2=torch.tensor([1, 2, 4, 8], dtype=torch.int32,
                                  device=device))


def _lookup(spec, state, channel, s: int, ijk):
    blin, intra, _ = voxel_to_block_c(spec, s, ijk[..., 0], ijk[..., 1],
                                      ijk[..., 2])
    slots = lookup_slots(spec, state.table, blin)
    return gather_channel(state.channels[channel],
                          flat_voxel_index(spec, slots, intra))


def _vertex_interp(p0, p1, v0, v1):
    """Zero crossing on the edge p0-p1 with EPS snapping to the ends."""
    den = v1 - v0
    mu = (0.0 - v0) / torch.where(den.abs() < 1e-30,
                                  torch.full_like(den, 1e-30), den)
    p = fma(mu[..., None], p1 - p0, p0)
    p = torch.where((v1.abs() < EPS)[..., None], p1, p)
    p = torch.where((v0.abs() < EPS)[..., None], p0, p)
    mu = torch.where(v0.abs() < EPS, torch.zeros_like(mu),
                     torch.where(v1.abs() < EPS, torch.ones_like(mu), mu))
    return p, mu


def _corner_values_halo(halo, V):
    """(cap, V, V, V, 8) corner samples of a (cap, V+2, V+2, V+2) halo."""
    return torch.stack([halo[:, 1 + dx:1 + dx + V, 1 + dy:1 + dy + V,
                             1 + dz:1 + dz + V]
                        for dx, dy, dz in CUBE_CORNERS], dim=-1)


DILATE = graphs.UnitCache("dilate_blocks", size=2)
EXTRACT = graphs.UnitCache("extract_mesh", size=4)


def dilate_blocks(cfg: TSDFConfig, state, active_submap: int, bitmap):
    """26-dilate a per-slot block bitmap through the allocated-neighbour
    table, restricted to the active submap's blocks: a block's mesh reads
    corners from its +1 halo and normals across any face. CPU state:
    :func:`dilate_blocks_ref`; on the card one graph replay
    (``ops/graphs.py``), ``bitmap`` staged."""
    if graphs.eager(state.table):
        return dilate_blocks_ref(cfg, state, active_submap, bitmap)
    active = int(active_submap)
    return DILATE.call(
        ("dilate_blocks", cfg, active),
        lambda w, s: dilate_blocks_ref(cfg, state, active, s["bitmap"]),
        bound=graphs.leaves((state,)),
        inputs={"bitmap": (bitmap, torch.bool)})


def dilate_blocks_ref(cfg: TSDFConfig, state, active_submap: int, bitmap):
    """The eager body of :func:`dilate_blocks` (every device)."""
    nb = cfg.grid.max_blocks + 1
    dev = bitmap.device
    src = bitmap.clone()
    src[-1].fill_(False)
    cols = neighbor_slot_cols(cfg.grid, state, active_submap)   # (27, nb)
    tgt = torch.where(src[None, :], cols, nb - 1).reshape(-1).long()
    out = torch.zeros((nb,), dtype=torch.bool, device=dev)
    out.index_fill_(0, tgt, True)
    out = out | bitmap
    blk = state.block_active & (state.block_coords[:, 0] == int(active_submap))
    out = out & blk
    out[-1].fill_(False)
    return out


def extract_mesh(cfg: TSDFConfig, max_triangles: int, step: int,
                 surface_block_cap: int, state, active_submap: int,
                 surface_thres: float, block_mask=None):
    """Isosurface of the active submap: see :func:`extract_mesh_ref`, which
    CPU state takes. On the card one graph replay (``ops/graphs.py``) per
    (``max_triangles``, ``step``, ``surface_block_cap``, submap,
    threshold), ``block_mask`` staged."""
    if graphs.eager(state.table):
        return extract_mesh_ref(cfg, max_triangles, step, surface_block_cap,
                                state, active_submap, surface_thres,
                                block_mask)
    active = int(active_submap)
    inputs = {} if block_mask is None else {
        "mask": (block_mask, torch.bool)}

    def body(w, s):
        return extract_mesh_ref(cfg, max_triangles, step, surface_block_cap,
                                state, active, surface_thres, s.get("mask"))
    static = ("extract_mesh", cfg, int(max_triangles), int(step),
              int(surface_block_cap), active, float(surface_thres),
              block_mask is None)
    return EXTRACT.call(static, body, bound=graphs.leaves((state,)),
                        inputs=inputs)


def extract_mesh_ref(cfg: TSDFConfig, max_triangles: int, step: int,
                     surface_block_cap: int, state, active_submap: int,
                     surface_thres: float, block_mask=None):
    """Isosurface of the active submap. Returns a dict: vertices, normals,
    colors (max_triangles*3, 3); num_triangles, total_triangles (before the
    cap), num_surface_blocks, surface_blocks_dropped (0-d int32);
    block_slots (cap,) storage slot per compacted block (ascending) and
    block_tri_counts (cap,) triangles per block — each block's triangles
    are one contiguous span. With ``block_mask`` only surface blocks in
    the mask are meshed; corner and normal reads still see the whole map,
    so their triangles equal those of a full extraction."""
    spec = cfg.grid
    V = spec.V
    V3 = spec.voxels_per_block
    nb = spec.max_blocks + 1
    dev = state.table.device
    s_id = int(active_submap)
    tab = _tables(dev)
    nt_tab, edge_tab = tab["ntri"], tab["edges"]
    thres = float(np.float32(surface_thres))

    tsdf_t = state.channels["TSDF"].float()
    obs_t = state.channels["TSDF_observed"] > 0
    blk = state.block_active & (state.block_coords[:, 0] == s_id)
    blk[-1].fill_(False)

    # ---- phase 0: compact surface blocks --------------------------------
    anchor = obs_t & (tsdf_t < thres)
    blk_has = anchor.any(dim=1) & blk
    if block_mask is not None:
        blk_has = blk_has & block_mask
    cap = surface_block_cap
    bpos, bkept, btotal = compact_mask(blk_has, cap)
    slot_of = torch.full((cap + 1,), nb - 1, dtype=torch.int32, device=dev)
    slot_of[bpos.long()] = torch.arange(nb, dtype=torch.int32, device=dev)
    slot_of = slot_of[:cap]
    sl = slot_of.long()
    bvalid = torch.arange(cap, device=dev) < bkept
    origin_c = block_origin_voxel(spec, state.block_coords[sl])   # (cap, 3)
    intra = _intra_offsets(V, dev)                                 # (V3, 3)
    corners_np = tab["corners"]

    # ---- corner sampling --------------------------------------------------
    if step == 1:
        nsl = neighbor_slot_table(spec, state, s_id,
                                  rows=slot_of)                   # (cap,3,3,3)
        nsl = torch.where(bvalid[:, None, None, None], nsl, nb - 1)

        def halo(src, fill):
            center = torch.where(bvalid[:, None, None, None], src[sl],
                                 torch.full((), fill, dtype=src.dtype,
                                            device=dev))
            return assemble_halo(src, nsl, V, fill, center)

        # unobserved / missing neighbours read TSDF 0, observed 0
        tsdf_src = torch.where(obs_t, tsdf_t, 0.0)
        tsdf_src[-1].fill_(0.0)
        obs_src = obs_t.clone()
        obs_src[-1].fill_(False)
        cv = _corner_values_halo(halo(tsdf_src.reshape(nb, V, V, V), 0.0),
                                 V).reshape(cap, V3, 8)
        cobs = _corner_values_halo(halo(obs_src.reshape(nb, V, V, V), False),
                                   V).reshape(cap, V3, 8)
        if cfg.texture_enabled:
            col_t = state.channels["color"].float()               # (nb,3,V3)
            comps = []
            for c in range(3):
                src = col_t[:, c, :].clone()
                src[-1].fill_(0.0)
                comps.append(_corner_values_halo(
                    halo(src.reshape(nb, V, V, V), 0.0), V).reshape(
                        cap, V3, 8))
            ccol = torch.stack(comps, dim=-1)              # (cap, V3, 8, 3)
    else:
        cell = origin_c[:, None, :] + intra[None]                 # (cap,V3,3)
        corners = cell[:, :, None, :] + corners_np[None, None] * step
        cv = _lookup(spec, state, "TSDF", s_id, corners).float()
        cobs = _lookup(spec, state, "TSDF_observed", s_id, corners) > 0
        if cfg.texture_enabled:
            blin_c, intra_c, _ = voxel_to_block_c(
                spec, s_id, corners[..., 0], corners[..., 1], corners[..., 2])
            slots_c = lookup_slots(spec, state.table, blin_c)
            flat = flat_voxel_index(spec, slots_c, intra_c)
            col_t = state.channels["color"]
            ccol = torch.stack([gather_channel(col_t[:, c, :], flat)
                                for c in range(3)], dim=-1).float()

    cell_ok = anchor[sl] & bvalid[:, None] & cobs.all(dim=-1)

    # ---- phase A: per-cell triangle counts ---------------------------------
    C = cap * V3
    inside = (cv < 0.0).reshape(C, 8)
    pow2 = tab["pow2"]
    tets = tab["tets"]

    def tet_case(ins, t):
        return (ins[:, tets[t]].to(torch.int32) * pow2).sum(dim=-1)

    tcount = torch.zeros((C,), dtype=torch.int32, device=dev)
    for t in range(6):
        tcount += nt_tab[t][tet_case(inside, t).long()]
    tcount = torch.where(cell_ok.reshape(C), tcount, 0)

    cend = torch.cumsum(tcount, 0, dtype=torch.int32)
    cbase = cend - tcount
    total = cend[-1]
    kept = torch.clamp(total, max=max_triangles)
    tri = torch.arange(max_triangles, dtype=torch.int32, device=dev)
    tri_valid = tri < kept
    # owning cell of every output triangle: the first cell whose running
    # count passes it (rows past ``kept`` are masked below)
    cell_i = torch.clamp(torch.searchsorted(cend, tri, right=True),
                         max=C - 1)
    local = tri - cbase[cell_i]

    # ---- phase B: build the kept triangles ---------------------------------
    vals = cv.reshape(C, 8)[cell_i]                               # (T, 8)
    insideK = vals < 0.0
    ccum = torch.zeros_like(local)
    tet_i = torch.zeros_like(local)
    tri_i = torch.zeros_like(local)
    k_case = torch.zeros_like(local)
    for t in range(6):
        case_t = tet_case(insideK, t)
        nt_t = nt_tab[t][case_t.long()]
        in_t = (local >= ccum) & (local < ccum + nt_t)
        tet_i = torch.where(in_t, t, tet_i)
        tri_i = torch.where(in_t, local - ccum, tri_i)
        k_case = torch.where(in_t, case_t, k_case)
        ccum = ccum + nt_t
    e = edge_tab[tet_i.long(), k_case.long(), tri_i.long()].long()  # (T,3,2)
    e = torch.clamp(e, min=0)   # rows past ``kept`` carry -1; masked below

    cell_block = cell_i // V3
    cell_intra = cell_i % V3
    base = (origin_c[cell_block] + intra[cell_intra]).float()     # (T, 3)
    cpos = base[:, None, None, :] + corners_np.float()[e] * step  # (T,3,2,3)
    v0 = torch.gather(vals, 1, e[:, :, 0])                        # (T, 3)
    v1 = torch.gather(vals, 1, e[:, :, 1])
    vpos, mu = _vertex_interp(cpos[:, :, 0], cpos[:, :, 1], v0, v1)

    # normals: central-difference TSDF gradient at round(p); unallocated
    # voxels read 0
    vijk = torch.round(vpos).to(torch.int32)                      # (T, 3, 3)
    offs = tab["offs"]
    probe = vijk[:, :, None, :] + offs[None, None]                # (T,3,6,3)
    tv = _lookup(spec, state, "TSDF", s_id, probe).float()
    grad = torch.stack([tv[..., 0] - tv[..., 1], tv[..., 2] - tv[..., 3],
                        tv[..., 4] - tv[..., 5]], dim=-1)
    nrm = grad / torch.clamp(sqrt_rn((grad * grad).sum(-1, keepdim=True)),
                             min=1e-12)

    if cfg.texture_enabled:
        ccol_t = ccol.reshape(C, 8, 3)[cell_i]                    # (T, 8, 3)
        colA = torch.gather(ccol_t, 1, e[:, :, 0, None].expand(-1, -1, 3))
        colB = torch.gather(ccol_t, 1, e[:, :, 1, None].expand(-1, -1, 3))
        # a black corner takes the other end's color
        a_zero = (colA == 0).all(dim=-1, keepdim=True)
        b_zero = (colB == 0).all(dim=-1, keepdim=True)
        col = fma(mu[..., None], colB - colA, colA)
        col = torch.where(b_zero, colA, col)
        col = torch.where(a_zero, colB, col)
    else:
        col = torch.full(vpos.shape, 0.5, device=dev)

    vmask = tri_valid[:, None, None]
    return {
        "vertices": torch.where(vmask, vpos * cfg.voxel_scale,
                                -1000000.0).reshape(-1, 3),
        "normals": torch.where(vmask, nrm, 0.0).reshape(-1, 3),
        "colors": torch.where(vmask, col, 0.5).reshape(-1, 3),
        "num_triangles": kept,
        "total_triangles": total,
        "num_surface_blocks": bkept,
        "surface_blocks_dropped": torch.clamp(btotal - cap, min=0),
        "block_slots": slot_of,
        "block_tri_counts": tcount.reshape(cap, V3).sum(dim=1,
                                                        dtype=torch.int32),
    }


def pack_mesh_delivery(vertices, normals, colors, rows: int,
                       with_colors: bool) -> torch.Tensor:
    """The first ``rows`` mesh rows as one uint8 buffer: vertices as int16
    millimetres (0.5 mm, ±32.7 m), normals as int8 /127, colors as uint8
    /255 — [rows*6 | rows*3 | rows*3 if with_colors]."""
    vq = torch.clamp(torch.round(vertices[:rows] * 1000.0), -32767,
                     32767).to(torch.int16)
    nq = torch.clamp(torch.round(normals[:rows] * 127.0), -127,
                     127).to(torch.int8)
    parts = [vq.contiguous().view(torch.uint8).reshape(-1),
             nq.contiguous().view(torch.uint8).reshape(-1)]
    if with_colors:
        parts.append(torch.clamp(torch.round(colors[:rows] * 255.0), 0,
                                 255).to(torch.uint8).reshape(-1))
    return torch.cat(parts)


def unpack_mesh_delivery(buf, rows: int, with_colors: bool):
    """Host-side inverse of :func:`pack_mesh_delivery` (numpy)."""
    if isinstance(buf, torch.Tensor):
        buf = host_read("mesh.buffer", buf).numpy()
    buf = np.asarray(buf)
    v = buf[:rows * 6].view(np.int16).reshape(rows, 3).astype(np.float32)
    v *= 1e-3
    n = buf[rows * 6:rows * 9].view(np.int8).reshape(rows, 3)
    n = n.astype(np.float32) / 127.0
    if with_colors:
        c = buf[rows * 9:rows * 12].reshape(rows, 3).astype(np.float32)
        c /= 255.0
    else:
        c = np.full((rows, 3), 0.5, np.float32)
    return v, n, c
