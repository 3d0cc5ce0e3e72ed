"""K1: sorted segmented block reduction (CUDA kernel + plain twin).

Counterpart of ``taichislam_tpu.ops.pallas.seg_accum.segmented_block_reduce``.
Lanes are sorted by the packed key ``bkey * V3 + intra`` (``torch.sort``,
stable), optionally cut to a lane cap, and every distinct block's lanes
are summed into an ``(n_vals, V3)`` f32 tile. The kernel is
``csrc/seg_accum.cu``; ``segmented_block_reduce_ref`` is the plain PyTorch
version with the same signature. The wrapper takes the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

SENTINEL_BLOCK = 2 ** 24   # invalid-lane block key; sorts last
SENTINEL_KEY = 2 ** 30     # invalid packed key of segmented_block_accumulate
CHUNK = 2048               # lane-cap rounding unit (16 rows x 128 lanes)


class _Sorted(NamedTuple):
    key: torch.Tensor            # (n,) int64 sorted packed keys
    perm: torch.Tensor | None    # (n,) int64 source lane of each sorted lane
    vals: torch.Tensor           # (n_vals, N) f32, unsorted lane order
    n: int                       # lanes fed to the reduction
    lanes_dropped: torch.Tensor  # 0-d int32


def _prepare(bkey, intra, vals, V3, lane_cap, presorted, vals_f16):
    """Sort, cap and round: the wrapper work shared by kernel and twin."""
    if not 1 <= len(vals) <= 8:
        raise ValueError(f"n_vals must be in [1, 8], got {len(vals)}")
    N = bkey.shape[0]
    valid = bkey < SENTINEL_BLOCK
    key = torch.where(valid, bkey.long() * V3 + intra.long(),
                      torch.full_like(bkey, SENTINEL_BLOCK,
                                      dtype=torch.int64) * V3)
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
    n = N
    n_pad = -(-N // CHUNK) * CHUNK
    if lane_cap is not None and lane_cap < n_pad:
        cap = max(-(-lane_cap // CHUNK) * CHUNK, CHUNK)
        if cap < n_pad:
            n_valid = valid.sum(dtype=torch.int32)
            lanes_dropped = torch.clamp(n_valid - cap, min=0)
            n = cap
    return _Sorted(key[:n].contiguous(),
                   None if perm is None else perm[:n].contiguous(),
                   vals, n, lanes_dropped)


def _check(bkey, intra, vals):
    dev = bkey.device
    for name, t, dt in (("bkey", bkey, torch.int32),
                        ("intra", intra, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or t.device != dev:
            raise ValueError(f"{name}: want 1-d {dt} on {dev}")
    for v in vals:
        if v.shape != bkey.shape or v.device != dev:
            raise ValueError("vals: want 1-d tensors shaped like bkey")


def segmented_block_reduce_ref(bkey, intra, vals: Sequence[torch.Tensor],
                               V3: int, max_touched: int,
                               lane_cap: int | None = None,
                               presorted: bool = False,
                               vals_f16: bool = False):
    """Plain PyTorch version. Returns (touched (max_touched,) int32 block
    keys ascending, -1 padded; acc (max_touched, n_vals, V3) f32 with zeros
    in untouched voxels and rows; n_touched 0-d int32, may exceed
    max_touched; lanes_dropped 0-d int32)."""
    _check(bkey, intra, vals)
    s = _prepare(bkey, intra, vals, V3, lane_cap, presorted, vals_f16)
    n_vals = s.vals.shape[0]
    dev = bkey.device
    b = torch.div(s.key, V3, rounding_mode="floor")
    valid = b < SENTINEL_BLOCK
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


def segmented_block_reduce(bkey, intra, vals: Sequence[torch.Tensor],
                           V3: int, max_touched: int,
                           lane_cap: int | None = None,
                           presorted: bool = False, vals_f16: bool = False,
                           site: str = "other"):
    """Sort lanes by (block key, intra index) and sum each touched block's
    lanes into an (n_vals, V3) tile; same results as
    :func:`segmented_block_reduce_ref`. CUDA tensors run
    ``csrc/seg_accum.cu``; CPU tensors run the plain version. ``site``
    names the call site in the per-site launch counts."""
    if bkey.device.type == "cpu":
        return segmented_block_reduce_ref(bkey, intra, vals, V3, max_touched,
                                          lane_cap, presorted, vals_f16)
    if bkey.device.type != "cuda":
        raise ValueError(f"unsupported device {bkey.device}")
    from taichislam_tpu_torch.ops.kernels import build

    _check(bkey, intra, vals)
    lib = build.library()
    s = _prepare(bkey, intra, vals, V3, lane_cap, presorted, vals_f16)
    n_vals = s.vals.shape[0]
    dev = bkey.device
    touched = torch.empty((max_touched,), dtype=torch.int32, device=dev)
    acc = torch.empty((max_touched, n_vals, V3), dtype=torch.float32,
                      device=dev)
    n_touched = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(-(-s.n // 256), 1),), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.seg_accum_launch(
        s.key.data_ptr(), None if s.perm is None else s.perm.data_ptr(),
        s.vals.data_ptr(), s.vals.shape[1], s.n, n_vals, V3, max_touched,
        touched.data_ptr(), acc.data_ptr(), n_touched.data_ptr(),
        scratch.data_ptr(), stream)
    build.check(err, "seg_accum_launch")
    segmented_block_reduce.launches += 1
    sites = segmented_block_reduce.site_launches
    sites[site] = sites.get(site, 0) + 1
    return touched, acc, n_touched, s.lanes_dropped


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
