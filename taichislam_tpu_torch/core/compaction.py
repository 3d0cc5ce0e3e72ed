"""Prefix-sum stream compaction (deterministic, linear-index order)."""

from __future__ import annotations

import torch


def compact_mask(mask: torch.Tensor, capacity: int):
    """Return (positions, kept, count) for compacting ``mask`` into
    ``capacity`` slots.

    ``positions[i]`` is the output index of element i when ``mask[i]`` and
    it fits in ``capacity``; otherwise ``capacity``. ``kept`` and ``count``
    are 0-d int32 tensors (``count`` may exceed ``capacity``).
    """
    mask = mask.reshape(-1)
    idx = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    if mask.numel() > 0:
        count = idx[-1] + 1
    else:
        count = torch.zeros((), dtype=torch.int32, device=mask.device)
    pos = torch.where(mask & (idx < capacity), idx,
                      torch.full_like(idx, capacity))
    return pos, torch.clamp(count, max=capacity), count


def compact(values: torch.Tensor, mask: torch.Tensor, capacity: int,
            fill_value=0):
    """Compact ``values`` (leading dim = mask size) where ``mask`` holds,
    in index order. Returns (out (capacity, ...), kept, total); ``total``
    may exceed ``capacity`` (overflow detection)."""
    pos, kept, total = compact_mask(mask, capacity)
    out = torch.full((capacity + 1,) + tuple(values.shape[1:]), fill_value,
                     dtype=values.dtype, device=values.device)
    out[pos.long()] = values    # dropped elements land on the extra row
    return out[:capacity], kept, total


def compact_sort(mask: torch.Tensor, capacity: int, operands, fills):
    """Stable compaction of parallel 1-d ``operands`` where ``mask`` holds:
    survivors move to the front in index order (the order of the JAX
    package's stable mask-key sort). Returns ([out (capacity,) per
    operand], kept, total); padding and overflow lanes hold each operand's
    ``fills`` value."""
    pos, kept, total = compact_mask(mask, capacity)
    pos = pos.long()
    outs = []
    for arr, fill in zip(operands, fills):
        out = torch.full((capacity + 1,), fill, dtype=arr.dtype,
                         device=arr.device)
        out[pos] = arr.reshape(-1)   # dropped lanes land on the extra slot
        outs.append(out[:capacity])
    return outs, kept, total
