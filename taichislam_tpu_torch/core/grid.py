"""Block voxel grid: direct-mapped block table plus flat channel arrays.

Same layout as the JAX package's ``core/grid.py``: an int32 table over the
bounded block-coordinate space (-1 = unallocated), channels of shape
``(max_blocks + 1[, C], V^3)`` whose last row is a garbage row, and
allocation as an exclusive prefix sum (deterministic, no atomics).

Unlike the JAX functions, which return new arrays, the allocation and
scatter functions here update the state's tensors IN PLACE, the 0-d
counters included, and return the state: every tensor of a state keeps its
address for the state's life, which a captured CUDA graph needs
(``ops/sequence.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from taichislam_tpu_torch.core.config import GridSpec
from taichislam_tpu_torch.core.device import resolve_device


class GridState(NamedTuple):
    """One block voxel grid.

    Attributes:
        table: int32 (num_submaps * blocks_per_submap,) block coord -> slot.
        block_coords: int32 (max_blocks + 1, 4) slot -> (s, bi, bj, bk).
        block_active: bool (max_blocks + 1,).
        num_blocks: int32 0-d tensor, allocated slot count.
        alloc_overflow: int32 0-d tensor, dropped allocations.
        channels: dict name -> (max_blocks + 1[, C], V^3) tensors.
    """

    table: torch.Tensor
    block_coords: torch.Tensor
    block_active: torch.Tensor
    num_blocks: torch.Tensor
    alloc_overflow: torch.Tensor
    channels: Dict[str, torch.Tensor]


def make_grid_state(spec: GridSpec, channel_defs: Dict[str, Tuple],
                    device=None) -> GridState:
    """Empty grid; ``channel_defs`` maps name -> (torch dtype, extra_shape).
    On the CUDA card unless ``device`` says otherwise (see
    :func:`resolve_device`)."""
    device = resolve_device(device)
    nb = spec.max_blocks + 1
    channels = {
        name: torch.zeros((nb,) + tuple(extra) + (spec.voxels_per_block,),
                          dtype=dtype, device=device)
        for name, (dtype, extra) in channel_defs.items()
    }
    i32 = dict(dtype=torch.int32, device=device)
    return GridState(
        table=torch.full((spec.table_size,), -1, **i32),
        block_coords=torch.full((nb, 4), -1, **i32),
        block_active=torch.zeros((nb,), dtype=torch.bool, device=device),
        num_blocks=torch.zeros((), **i32),
        alloc_overflow=torch.zeros((), **i32),
        channels=channels,
    )


def voxel_to_block(spec: GridSpec, s, ijk: torch.Tensor):
    """Signed voxel coords (..., 3) -> (block_lin, intra_lin, in_bounds);
    ``s`` broadcasts to ``ijk[..., 0]``; ``block_lin`` is -1 out of
    bounds."""
    return voxel_to_block_c(spec, s, ijk[..., 0], ijk[..., 1], ijk[..., 2])


def voxel_to_block_c(spec: GridSpec, s, vi, vj, vk):
    """Signed voxel coords (component tensors) -> (block_lin, intra_lin,
    in_bounds); ``block_lin`` is -1 out of bounds."""
    V = spec.V
    o = spec.origin_voxel
    ui = vi - o[0]
    uj = vj - o[1]
    uk = vk - o[2]
    inb = ((ui >= 0) & (ui < spec.N) & (uj >= 0) & (uj < spec.N) &
           (uk >= 0) & (uk < spec.Nz))
    inb = inb & (s >= 0) & (s < spec.num_submaps)
    bi = torch.div(ui, V, rounding_mode="floor")
    bj = torch.div(uj, V, rounding_mode="floor")
    bk = torch.div(uk, V, rounding_mode="floor")
    ii, ij, ik = ui - bi * V, uj - bj * V, uk - bk * V
    blin = (bi * spec.bn_xy + bj) * spec.bn_z + bk + \
        s * spec.blocks_per_submap
    blin = torch.where(inb, blin, torch.full_like(blin, -1))
    intra_lin = (ii * V + ij) * V + ik
    return blin, intra_lin, inb


def block_lin_to_coords(spec: GridSpec, blin: torch.Tensor) -> torch.Tensor:
    """Linear block id -> (s, bi, bj, bk) int32 stack (..., 4)."""
    bps = spec.blocks_per_submap
    plane = spec.bn_xy * spec.bn_z
    s = torch.div(blin, bps, rounding_mode="floor")
    r = blin - s * bps
    bi = torch.div(r, plane, rounding_mode="floor")
    r2 = r - bi * plane
    bj = torch.div(r2, spec.bn_z, rounding_mode="floor")
    bk = r2 - bj * spec.bn_z
    return torch.stack([s, bi, bj, bk], dim=-1).to(torch.int32)


def block_origin_voxel(spec: GridSpec, block_coords: torch.Tensor
                       ) -> torch.Tensor:
    """(..., 4) (s, bi, bj, bk) -> (..., 3) signed voxel index of the
    block's lower corner."""
    return block_coords[..., 1:4] * spec.V + _origin(spec.origin_voxel,
                                                     block_coords.device)


@functools.lru_cache(maxsize=16)
def _origin(origin, device) -> torch.Tensor:
    """A grid's origin voxel as an int32 tensor, made once per device (a
    captured graph may then read it: it holds no host-to-device copy)."""
    return torch.tensor(origin, dtype=torch.int32, device=device)


def lookup_slots(spec: GridSpec, table: torch.Tensor,
                 blin: torch.Tensor) -> torch.Tensor:
    """Slots of linear block ids; misses map to the garbage slot."""
    slot = table[blin.clamp(0, spec.table_size - 1).long()]
    return torch.where((blin < 0) | (slot < 0),
                       torch.full_like(slot, spec.max_blocks), slot)


def flat_voxel_index(spec: GridSpec, slot, intra_lin):
    """Address into a channel viewed as ((max_blocks+1) * V^3,)."""
    return slot * spec.voxels_per_block + intra_lin


def allocate_blocks(spec: GridSpec, state: GridState, cand_blin: torch.Tensor,
                    cand_valid: torch.Tensor, submap_id: int) -> GridState:
    """Allocate storage for every valid candidate block of submap
    ``submap_id`` (global linear ids) through a touched bitmap over the
    submap's table region. In place; returns the updated state."""
    bps = spec.blocks_per_submap
    lo = int(submap_id) * bps
    rel = cand_blin.reshape(-1) - lo
    bad = (~cand_valid.reshape(-1)) | (rel < 0) | (rel >= bps)
    rel = torch.where(bad, torch.full_like(rel, bps), rel)
    touched = torch.zeros((bps + 1,), dtype=torch.bool,
                          device=cand_blin.device)
    touched.index_fill_(0, rel.long(), True)
    return allocate_from_touched(spec, state, touched[:bps], lo)


def allocate_from_touched(spec: GridSpec, state: GridState,
                          touched: torch.Tensor, lo: int) -> GridState:
    """Allocate every block marked in ``touched`` (a bitmap over the table
    region starting at ``lo``): new slots from an exclusive prefix sum.
    In place; returns the updated state."""
    bps = touched.shape[0]
    region = state.table[lo:lo + bps]
    new_mask = touched & (region < 0)
    offs = torch.cumsum(new_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = state.num_blocks + offs
    ok = new_mask & (slot < spec.max_blocks)
    region.copy_(torch.where(ok, slot, region))

    # new slots' coords and active flags; misses land on the garbage row,
    # which is restored afterwards
    garbage = spec.max_blocks
    tgt = torch.where(ok, slot, torch.full_like(slot, garbage)).long()
    lin_ids = lo + torch.arange(bps, dtype=torch.int32,
                                device=touched.device)
    state.block_coords[tgt] = block_lin_to_coords(spec, lin_ids)
    state.block_active.index_fill_(0, tgt, True)
    state.block_coords[garbage].fill_(-1)
    state.block_active[garbage].fill_(False)

    n_new = new_mask.sum(dtype=torch.int32)
    n_fit = torch.clamp(torch.minimum(n_new, spec.max_blocks -
                                      state.num_blocks), min=0)
    state.alloc_overflow.add_(n_new - n_fit)
    state.num_blocks.add_(n_fit)
    return state


def reset_grid(state: GridState) -> GridState:
    """Deallocate every block and zero the channels and counters, in
    place."""
    state.table.fill_(-1)
    state.block_coords.fill_(-1)
    state.block_active.fill_(False)
    for v in state.channels.values():
        v.zero_()
    state.num_blocks.zero_()
    state.alloc_overflow.zero_()
    return state


def clone_state(state: GridState) -> GridState:
    """A copy of ``state`` that shares no tensor with it."""
    return state._replace(
        channels={k: v.clone() for k, v in state.channels.items()},
        **{f: getattr(state, f).clone() for f in state._fields
           if f != "channels"})


def copy_state_(dst: GridState, src: GridState) -> GridState:
    """Write ``src``'s values into ``dst``'s tensors, in place (their
    addresses stay); returns ``dst``."""
    for f in dst._fields:
        if f != "channels":
            getattr(dst, f).copy_(getattr(src, f))
    for k, v in dst.channels.items():
        v.copy_(src.channels[k])
    return dst


def channel_flat(channel: torch.Tensor) -> torch.Tensor:
    """A channel (B[, C], V^3) viewed flat."""
    return channel.reshape(-1)


def channel_unflat(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flat.reshape(like.shape)


def comp_flat_index(spec: GridSpec, slot, intra_lin, comp: int):
    """Address component ``comp`` of a (nb, 3, V^3) channel viewed flat."""
    return (slot * 3 + comp) * spec.voxels_per_block + intra_lin


def gather_channel(channel: torch.Tensor, flat_idx: torch.Tensor
                   ) -> torch.Tensor:
    """``channel.flat[flat_idx]``; indices past the end read 0."""
    flat = channel.reshape(-1)
    n = flat.shape[0]
    idx = flat_idx.long()
    ok = (idx >= 0) & (idx < n)
    vals = flat[torch.where(ok, idx, torch.zeros_like(idx))]
    return torch.where(ok, vals, torch.zeros((), dtype=flat.dtype,
                                             device=flat.device))


def _in_range(channel, flat_idx, values):
    """Flat indices inside ``channel`` (negative ones counted from the end,
    as JAX's indexing does) and their values; the rest are dropped."""
    n = channel.numel()
    idx = flat_idx.reshape(-1).long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    vals = torch.broadcast_to(values, flat_idx.shape).reshape(-1)
    return idx[ok], vals[ok].to(channel.dtype)


def scatter_add(channel: torch.Tensor, flat_idx: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """``channel.flat[flat_idx] += values``, in place; indices outside the
    channel are dropped."""
    idx, vals = _in_range(channel, flat_idx, values)
    channel.view(-1).index_add_(0, idx, vals)
    return channel


def scatter_set(channel: torch.Tensor, flat_idx: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """``channel.flat[flat_idx] = values``, in place; indices outside the
    channel are dropped. Of lanes that share an index the last one wins,
    as in JAX's sequential CPU scatter."""
    idx, vals = _in_range(channel, flat_idx, values)
    key, perm = torch.sort(idx, stable=True)
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    channel.view(-1)[key[last]] = vals[perm[last]]
    return channel


def clear_garbage_row(state: GridState) -> GridState:
    """Zero every channel's garbage slot, in place, so writes it absorbed
    never reach an export."""
    for v in state.channels.values():
        v[-1].zero_()
    return state


def scatter_max(channel: torch.Tensor, flat_idx: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """``channel.flat[flat_idx] = max(channel.flat[flat_idx], values)``,
    in place (every index must lie inside the channel)."""
    flat = channel.view(-1)
    flat.scatter_reduce_(0, flat_idx.reshape(-1).long(),
                         values.reshape(-1).to(flat.dtype), reduce="amax")
    return channel
