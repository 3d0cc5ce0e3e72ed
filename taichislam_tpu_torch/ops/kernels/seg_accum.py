"""K1: sorted segmented block reduction (CUDA kernel + plain twin).

Counterpart of ``segmented_block_reduce`` in the JAX package's
``ops/pallas/seg_accum.py``.
Lanes are sorted by the packed key ``bkey * V3 + intra`` (stable),
optionally cut to a lane cap, and every distinct block's lanes are summed
into an ``(n_vals, V3)`` f32 tile. The kernel is ``csrc/seg_accum.cu``: one
host call runs key packing with the compaction of the valid lanes, a
hand-written radix sort of a u32 key (u64 without ``max_bkey``), the head
scan and the reduction on the stream, and no PyTorch op besides the
allocations. ``segmented_block_reduce_ref`` is the plain
PyTorch version with the same signature. The wrapper takes the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises. It is capture-safe: its host work depends on shapes only, its
workspace comes from the allocator (a graph's pool under capture), and its
launch counters count each replay of a captured graph
(``build.count``), with each launch's work: lanes, lanes x values, sorted
key bytes, presorted launches, touched-block capacity and tile values, the
sizes the caller hands the kernel (``k1/*`` in ``utils/profiling``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

SENTINEL_BLOCK = 2 ** 24   # invalid-lane block key; sorts last
SENTINEL_KEY = 2 ** 30     # invalid packed key of segmented_block_accumulate
CHUNK = 2048               # lane-cap rounding unit (16 rows x 128 lanes)
TILE = 4096                # lanes per CTA of the sort passes and head scan
PREP_TILE = 1024           # lanes per CTA of the key packing and compaction
MAX_VALS = 8


def _key_bound(max_bkey):
    """Block keys below this bound are valid: ``max_bkey`` where given
    (callers guarantee valid keys below it), else ``SENTINEL_BLOCK``."""
    return SENTINEL_BLOCK if max_bkey is None else \
        min(int(max_bkey), SENTINEL_BLOCK)


def _lane_cap(N, lane_cap):
    """Lanes kept after the sort and whether the cap cut any: the first
    ``lane_cap`` rounded up to whole CHUNKs, as the JAX package cuts."""
    n_pad = -(-N // CHUNK) * CHUNK
    if lane_cap is not None and lane_cap < n_pad:
        cap = max(-(-lane_cap // CHUNK) * CHUNK, CHUNK)
        if cap < n_pad:
            return cap, True
    return N, False


class _Sorted(NamedTuple):
    key: torch.Tensor            # (n,) int64 sorted packed keys
    perm: torch.Tensor | None    # (n,) int64 source lane of each sorted lane
    vals: torch.Tensor           # (n_vals, N) f32, unsorted lane order
    n: int                       # lanes fed to the reduction
    lanes_dropped: torch.Tensor  # 0-d int32
    sentinel: int                # packed key of invalid lanes


def _prepare(bkey, intra, vals, V3, lane_cap, presorted, vals_f16, max_bkey):
    """Sort, cap and round: the plain version's wrapper work."""
    if not 1 <= len(vals) <= MAX_VALS:
        raise ValueError(f"n_vals must be in [1, {MAX_VALS}], got {len(vals)}")
    N = bkey.shape[0]
    valid = bkey < _key_bound(max_bkey)
    sentinel = SENTINEL_BLOCK * V3
    key = torch.where(valid, bkey.long() * V3 + intra.long(),
                      torch.full_like(bkey, sentinel, dtype=torch.int64))
    vals = [v.float() for v in vals]
    if vals_f16 and not presorted and len(vals) >= 2:
        # value pairs ride the JAX sort at f16 precision; an odd last
        # value stays f32 there too
        n_pair = len(vals) // 2 * 2
        vals = [v.half().float() for v in vals[:n_pair]] + vals[n_pair:]
    vals = torch.stack(vals).contiguous()
    if presorted:
        perm = None
    else:
        key, perm = torch.sort(key, stable=True)
    lanes_dropped = torch.zeros((), dtype=torch.int32, device=bkey.device)
    n, capping = _lane_cap(N, lane_cap)
    if capping:
        n_valid = valid.sum(dtype=torch.int32)
        lanes_dropped = torch.clamp(n_valid - n, min=0)
    return _Sorted(key[:n].contiguous(),
                   None if perm is None else perm[:n].contiguous(),
                   vals, n, lanes_dropped, sentinel)


def _check(bkey, intra, vals):
    dev = bkey.device
    for name, t, dt in (("bkey", bkey, torch.int32),
                        ("intra", intra, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or t.device != dev:
            raise ValueError(f"{name}: want 1-d {dt} on {dev}")
    if intra.shape != bkey.shape:
        raise ValueError("intra: want the shape of bkey")
    for v in vals:
        if v.shape != bkey.shape or v.device != dev:
            raise ValueError("vals: want 1-d tensors shaped like bkey")


def segmented_block_reduce_ref(bkey, intra, vals: Sequence[torch.Tensor],
                               V3: int, max_touched: int,
                               lane_cap: int | None = None,
                               presorted: bool = False,
                               vals_f16: bool = False,
                               max_bkey: int | None = None):
    """Plain PyTorch version. Returns (touched (max_touched,) int32 block
    keys ascending, -1 padded; acc (max_touched, n_vals, V3) f32 with zeros
    in untouched voxels and rows; n_touched 0-d int32, may exceed
    max_touched; lanes_dropped 0-d int32). ``max_bkey`` bounds the valid
    block keys as at the JAX call sites; it changes no result for keys
    below it."""
    _check(bkey, intra, vals)
    s = _prepare(bkey, intra, vals, V3, lane_cap, presorted, vals_f16,
                 max_bkey)
    n_vals = s.vals.shape[0]
    dev = bkey.device
    valid = s.key < s.sentinel
    b = torch.div(s.key, V3, rounding_mode="floor")
    prev = torch.cat([torch.full((1,), -1, dtype=b.dtype, device=dev),
                      b[:-1]])
    head = valid & (b != prev)
    rank = torch.cumsum(head.to(torch.int64), 0) - 1
    n_touched = head.sum(dtype=torch.int32)
    ok = valid & (rank < max_touched)
    vs = s.vals[:, :s.n] if s.perm is None else s.vals[:, s.perm]
    intra_s = s.key - b * V3
    acc = torch.zeros((max_touched * n_vals * V3,), dtype=torch.float32,
                      device=dev)
    for v in range(n_vals):
        idx = (rank * n_vals + v) * V3 + intra_s
        acc.index_add_(0, idx[ok], vs[v][ok])
    touched = torch.full((max_touched,), -1, dtype=torch.int32, device=dev)
    sel = head & ok
    touched[rank[sel]] = b[sel].to(torch.int32)
    return (touched, acc.view(max_touched, n_vals, V3), n_touched,
            s.lanes_dropped)


def _plan(N, V3, presorted, max_bkey):
    """(key bound, key bytes, radix passes) of the kernel. The key is u32
    when ``kb * V3 < 2^30`` (the JAX package's packed-sort rule) and u64
    otherwise; the passes cover the bits of the invalid key ``kb * V3``,
    the largest key there is."""
    kb = _key_bound(max_bkey)
    top = kb * V3
    key_bytes = 4 if top < SENTINEL_KEY else 8
    passes = 0 if presorted or N == 0 else -(-top.bit_length() // 8)
    return kb, key_bytes, passes


def _align(x):
    return -(-x // 256) * 256


def _workspace_bytes(N, n, n_vals, key_bytes, passes, max_touched):
    """Bytes of the kernel's workspace (``layout`` in seg_accum.cu)."""
    tiles = -(-N // TILE)
    parts = (N * key_bytes, N * key_bytes if passes > 0 else 0,
             N * 4 if passes > 1 else 0, N * 4 if passes > 0 else 0,
             N * n_vals * 4, 8 * 256 * 4, 16 * 4, -(-N // PREP_TILE) * 4,
             passes * tiles * 256 * 4, -(-n // TILE) * 4,
             (max_touched + 1) * 4)
    return sum(_align(p) for p in parts)


def segmented_block_reduce(bkey, intra, vals: Sequence[torch.Tensor],
                           V3: int, max_touched: int, *,
                           lane_cap: int | None = None,
                           presorted: bool = False, vals_f16: bool = False,
                           max_bkey: int | None = None,
                           site: str = "other"):
    """Sort lanes by (block key, intra index) and sum each touched block's
    lanes into an (n_vals, V3) tile; same results as
    :func:`segmented_block_reduce_ref`. ``max_bkey`` bounds the valid block
    keys (lanes at or above it count as invalid) and lets the kernel sort a
    u32 key over fewer bits. CUDA tensors run ``csrc/seg_accum.cu`` in one
    host call; CPU tensors run the plain version. ``site`` names the call
    site in the per-site launch counts."""
    if bkey.device.type == "cpu":
        return segmented_block_reduce_ref(bkey, intra, vals, V3, max_touched,
                                          lane_cap, presorted, vals_f16,
                                          max_bkey)
    if bkey.device.type != "cuda":
        raise ValueError(f"unsupported device {bkey.device}")
    from taichislam_tpu_torch.ops.kernels import build

    _check(bkey, intra, vals)
    n_vals = len(vals)
    if not 1 <= n_vals <= MAX_VALS:
        raise ValueError(f"n_vals must be in [1, {MAX_VALS}], got {n_vals}")
    if not (bkey.is_contiguous() and intra.is_contiguous()):
        raise ValueError("bkey / intra: want contiguous tensors")
    vals = [v if v.dtype == torch.float32 else v.float() for v in vals]
    lib = build.library()
    N = bkey.shape[0]
    kb, key_bytes, passes = _plan(N, V3, presorted, max_bkey)
    n, capping = _lane_cap(N, lane_cap)
    n_f16 = n_vals // 2 * 2 if vals_f16 and not presorted else 0
    dev = bkey.device
    touched = torch.empty((max_touched,), dtype=torch.int32, device=dev)
    acc = torch.empty((max_touched, n_vals, V3), dtype=torch.float32,
                      device=dev)
    n_touched = torch.empty((), dtype=torch.int32, device=dev)
    lanes_dropped = torch.empty((), dtype=torch.int32, device=dev)
    ws_bytes = _workspace_bytes(N, n, n_vals, key_bytes, passes, max_touched)
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)
    ptrs = (ctypes.c_void_p * MAX_VALS)(*[v.data_ptr() for v in vals])
    strides = (ctypes.c_int64 * MAX_VALS)(*[v.stride(0) for v in vals])
    err = lib.seg_accum_launch(
        bkey.data_ptr(), intra.data_ptr(), ptrs, strides, N, n_vals, n_f16,
        V3, kb, key_bytes, passes, n, int(capping), max_touched,
        touched.data_ptr(), acc.data_ptr(), n_touched.data_ptr(),
        lanes_dropped.data_ptr(), ws.data_ptr(), ws_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "seg_accum_launch")
    build.count(segmented_block_reduce, site, {
        "k1/launches": 1, "k1/lanes": N, "k1/lane_vals": N * n_vals,
        "k1/key_bytes": N * key_bytes, "k1/presorted": int(presorted),
        "k1/max_touched": max_touched,
        "k1/tile_vals": max_touched * n_vals * V3})
    return touched, acc, n_touched, lanes_dropped


segmented_block_reduce.launches = 0
segmented_block_reduce.site_launches = {}   # call site -> launches


def segmented_block_accumulate(keys, w, wd, V3: int, max_touched: int):
    """Back-compat form over packed keys (``bkey * V3 + intra``;
    ``SENTINEL_KEY`` or more for invalid lanes): returns (touched, acc,
    n_touched) of :func:`segmented_block_reduce` on the values (w, wd)."""
    invalid = keys >= SENTINEL_KEY
    bk = torch.div(keys, V3, rounding_mode="floor")
    bkey = torch.where(invalid, torch.full_like(keys, SENTINEL_BLOCK), bk)
    intra = torch.where(invalid, torch.zeros_like(keys), keys - bk * V3)
    return segmented_block_reduce(bkey, intra, (w, wd), V3, max_touched)[:3]
