#!/usr/bin/env python3
"""The hand-written kernels' inputs at the main path's shapes, and an A/B
timing of two checkouts of the port on one card.

``k1_cases``, ``k1_cap_case``, ``sweep_fields``, ``k2_case`` and
``k3_case`` build the inputs that ``chip_smoke.py`` phase 2 holds each
kernel against its twin on (numpy, from fixed seeds): K1 at its five call
sites, K2 and K3 at 264 and 1056 rows. Run as a script, this file times the
kernels of two checkouts at those shapes, and K2 and K3 over 264 rows at
V = 8 and at V = 24 and 32 (rows past one CTA's shared memory), in turns
(old, new, new, old), each turn in its own process that imports the port
from its checkout:

    git archive <earlier commit> | tar -x -C build/old
    python3 kernel_ab.py --old build/old \\
        [--new .] [--out build/kernel_ab.json]

``--old`` is an unpacked ``git archive`` of the earlier commit. Each turn
builds its checkout's kernels (nvcc, into that checkout's build/) and
prints one JSON line: per kernel and shape the median event ms of one call
(CUDA events, the host's share included) and its device ms (the kernels
torch.profiler records, the mean of five calls); the script prints the
four turns and writes them to ``--out``. It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SENTINEL_BLOCK = 2 ** 24
# the node's 100 x 10 m map at 5 cm, V = 16: 125 x 125 x 13 blocks
NODE_BLOCKS = 125 * 125 * 13
# a full refuse's lanes on the launch files' path: 7 corners x bcap 1024
# source blocks x 4096 voxels (the PGO refuse of chip_smoke.py phase 8)
FUSION_LANES = 7 * 1024 * 4096


def k1_cases(fusion: bool = True):
    """K1's call sites: (name, bkey, intra, vals, kwargs, max_bkey) with
    max_bkey as the call site passes it (None at the presorted sites)."""
    rng = np.random.default_rng(1)
    out = []
    # march site: keys over 2197 blocks x 4096 voxels, 60 x 8192 lanes,
    # 10% invalid, f16-rounded pair of values, lane cap 524288
    n = 60 * 8192
    bkey = rng.integers(0, 2197, n).astype(np.int32)
    bkey[rng.random(n) < 0.1] = SENTINEL_BLOCK
    intra = rng.integers(0, 4096, n).astype(np.int32)
    vals = [rng.random(n, dtype=np.float32) * 50,
            rng.standard_normal(n).astype(np.float32) * 5]
    out.append(("march", bkey, intra, vals,
                dict(V3=4096, max_touched=256, lane_cap=524288,
                     vals_f16=True), 2197))
    # bins site: one block of V3 = 8192 bins, presorted ranks, 5 values
    n = 76800
    rank = np.sort(rng.integers(0, 9000, n)).astype(np.int32)
    _, rank = np.unique(rank, return_inverse=True)
    rank = rank.astype(np.int32)
    ok = rank < 8192
    bkey = np.where(ok, 0, SENTINEL_BLOCK).astype(np.int32)
    intra = np.where(ok, rank, 0).astype(np.int32)
    vals = [np.ones(n, np.float32)] + [rng.standard_normal(n).astype(
        np.float32) for _ in range(4)]
    out.append(("bins", bkey, intra, vals,
                dict(V3=8192, max_touched=1, presorted=True), None))
    # textured march site at the node's shape: 102 steps x 6144 bins over
    # a 100 x 10 m map's blocks; Σw, Σw·d and three Σw·c, pairs f16-rounded
    n = 102 * 6144
    blocks = rng.choice(NODE_BLOCKS, 700, replace=False)
    bkey = blocks[rng.integers(0, 700, n)].astype(np.int32)
    bkey[rng.random(n) < 0.3] = SENTINEL_BLOCK
    intra = rng.integers(0, 4096, n).astype(np.int32)
    w = rng.random(n, dtype=np.float32) * 10
    vals = [w, w * rng.standard_normal(n).astype(np.float32)] + [
        w * rng.random(n, dtype=np.float32) for _ in range(3)]
    out.append(("march5", bkey, intra, vals,
                dict(V3=4096, max_touched=1024, vals_f16=True), NODE_BLOCKS))
    # textured bins site: count, px, py, pz, depth, r, g, b
    n = 76800
    rank = np.sort(rng.integers(0, 9000, n)).astype(np.int32)
    _, rank = np.unique(rank, return_inverse=True)
    ok = rank < 8192
    bkey = np.where(ok, 0, SENTINEL_BLOCK).astype(np.int32)
    intra = np.where(ok, rank, 0).astype(np.int32)
    vals = [np.ones(n, np.float32)] + [rng.standard_normal(n).astype(
        np.float32) for _ in range(4)] + [
        rng.uniform(0, 255, n).astype(np.float32) for _ in range(3)]
    out.append(("bins8", bkey, intra, vals,
                dict(V3=8192, max_touched=1, presorted=True), None))
    if fusion:
        # fusion site: a full refuse's 29.4 M lanes, 6 values (Σw, Σw·d,
        # Σocc, three Σw·c), 354 touched blocks of the node's global map,
        # 60% of the lanes invalid (empty source slots and zero weights)
        n = FUSION_LANES
        blocks = np.sort(rng.choice(NODE_BLOCKS, 354, replace=False))
        bkey = blocks[rng.integers(0, 354, n)].astype(np.int32)
        bkey[rng.random(n, dtype=np.float32) < 0.6] = SENTINEL_BLOCK
        intra = rng.integers(0, 4096, n, dtype=np.int32)
        w = rng.random(n, dtype=np.float32)
        vals = [w, w * rng.standard_normal(n, dtype=np.float32),
                (rng.random(n, dtype=np.float32) < 0.5).astype(np.float32)] \
            + [w * rng.random(n, dtype=np.float32) for _ in range(3)]
        out.append(("fusion", bkey, intra, vals,
                    dict(V3=4096, max_touched=512), NODE_BLOCKS))
    return out


CHUNK = 2048   # the lane cap's rounding unit (ops/kernels/seg_accum.py)


def k1_cap_case():
    """K1 at the march shape with a lane cap that cuts inside a block and
    a ``max_bkey`` below some lanes' block keys (those lanes count as
    invalid): (bkey, intra, vals, kwargs, max_bkey). The cap is a CHUNK
    multiple near half the valid lanes whose sorted lanes on both sides of
    the cut share a block."""
    rng = np.random.default_rng(4)
    n = 60 * 8192
    bkey = rng.integers(0, 2197, n).astype(np.int32)
    bkey[rng.random(n) < 0.1] = SENTINEL_BLOCK
    intra = rng.integers(0, 4096, n).astype(np.int32)
    vals = [rng.random(n, dtype=np.float32) * 50,
            rng.standard_normal(n).astype(np.float32) * 5]
    max_bkey = 2000
    ok = bkey < max_bkey
    blocks = np.sort(bkey[ok].astype(np.int64) * 4096 + intra[ok]) // 4096
    cap = int(ok.sum()) // 2 // CHUNK * CHUNK
    while blocks[cap - 1] != blocks[cap]:
        cap += CHUNK
    return bkey, intra, vals, dict(V3=4096, max_touched=2048, lane_cap=cap,
                                   vals_f16=True), max_bkey


def sweep_fields(rng, N, V, n_upd):
    """Random halo-assembled fields in the sweep layout: participating
    voxels with TSDF in [-0.4, 0.4], a field near the seeds, an
    interior-only side mask consistent with the encoding (numpy)."""
    W = V + 2
    tsdf = rng.uniform(-0.4, 0.4, (N, W, W * W)).astype(np.float32)
    part = rng.random((N, W, W * W)) < 0.85
    enc = np.where(part, tsdf, 1e6).astype(np.float32)
    esdf = (tsdf + rng.uniform(-0.3, 0.3, tsdf.shape)).astype(np.float32)
    c = np.arange(W)
    inter1 = (c >= 1) & (c <= V)
    inter = (inter1[:, None, None] & inter1[None, :, None] &
             inter1[None, None, :]).reshape(1, W, W * W)
    fixed = part & (np.abs(tsdf) < 0.05)
    upd = (np.arange(N) < n_upd)[:, None, None]
    side = np.where(part & ~fixed & inter & upd,
                    np.where(tsdf >= 0, 1, -1), 0).astype(np.int8)
    enc[-1] = 1e6   # garbage row: never a source
    esdf[-1] = 0.0
    return esdf, enc, side


K2_ROWS = 264           # the bench's block-mode rows (33 slabs)
SWEEP_KW = dict(V=16, v1=0.05, gamma=0.05, eps=0.025, max_ray=3.0)


def k2_case(N=K2_ROWS, V=16):
    """K2's inputs: (esdf, enc, side, slab_act) over N rows: at 264 rows 200
    updatable, else three quarters of the rows; 80 % of the slabs
    active."""
    rng = np.random.default_rng(2 if N == K2_ROWS else 3)
    esdf, enc, side = sweep_fields(rng, N, V, 200 if N == K2_ROWS else
                                   N * 3 // 4)
    slab_act = (rng.random(N // 8) < 0.8).astype(np.int32)
    return esdf, enc, side, slab_act


def k3_case(N=K2_ROWS, V=16):
    """K3's inputs: (esdf, enc, nsl27, upd) over N rows: a random
    27-neighbour table over the used rows with the garbage row ``cap``
    (256 at 264 rows, N - 8 else) and padding rows past it, whose enc is
    ENC_BIG; three quarters of the used rows updatable (200 of 256)."""
    rng = np.random.default_rng(2 if N == K2_ROWS else 3)
    cap = 256 if N == K2_ROWS else N - 8
    n_upd = 200 if N == K2_ROWS else cap * 3 // 4
    esdf, enc, _ = sweep_fields(rng, N, V, n_upd)
    rng.random(N // 8)    # K2's slab gates: the 264-row case follows them
    nsl = rng.integers(0, cap + 1, (27, N)).astype(np.int32)
    nsl[13] = np.minimum(np.arange(N), cap)
    nsl[:, cap:] = cap
    upd = (np.arange(N) < n_upd).astype(np.int32)
    enc[cap:] = 1e6
    esdf[cap:] = 0.0
    return esdf, enc, nsl, upd


# ---------------------------------------------------------------------------
# A/B timing
# ---------------------------------------------------------------------------

def _cuda_ms(fn, reps):
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_ms(fn, n=5):
    """Mean device ms of one ``fn()`` call: the CUDA kernels torch.profiler
    records over ``n`` warmed calls (a window that records no kernel is
    taken again, up to three times). Unlike the event time, it leaves out
    the host's share of a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(a.device_time_total for a in prof.key_averages()
                 if a.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return us / n / 1000.0
    return None


def worker(root: str) -> dict:
    """Time one checkout's kernels (imported from ``root``) at the phase-2
    shapes; returns {kernel/shape: event ms, kernel/shape device: device
    ms}."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from taichislam_tpu_torch.ops.kernels import build
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    dev = torch.device("cuda", 0)
    build.library()
    takes_bound = "max_bkey" in inspect.signature(
        k1.segmented_block_reduce).parameters
    out = {}

    def timed(key, fn, reps):
        out[key] = _cuda_ms(fn, reps)
        out[f"{key} device"] = _device_ms(fn)

    for name, bkey, intra, vals, kw, mb in k1_cases():
        args = (torch.from_numpy(bkey).to(dev),
                torch.from_numpy(intra).to(dev),
                [torch.from_numpy(v).to(dev) for v in vals])
        kw = dict(kw, max_bkey=mb) if takes_bound and mb else kw
        timed(f"K1 {name}", lambda: k1.segmented_block_reduce(*args, **kw),
              5 if name == "fusion" else 20)
        del args
    # the main path's V = 16 at 264 and 1056 rows, and V = 8 (the block
    # size of the examples and tests), 24 and 32 (the rows past one CTA's
    # shared memory) at 264 rows
    shapes = ((K2_ROWS, 16, ""), (4 * K2_ROWS, 16, ""),
              (K2_ROWS, 8, " V=8"), (K2_ROWS, 24, " V=24"),
              (K2_ROWS, 32, " V=32"))
    for N, V, tag in shapes:
        esdf, enc, side, act = (torch.from_numpy(a).to(dev)
                                for a in k2_case(N, V))
        kw = dict(SWEEP_KW, V=V)
        for scans in (True, False):
            timed(f"K2 {N} rows{tag} scans={scans}",
                  lambda: ks.esdf_sweep(esdf, enc, side, act,
                                        with_scans=scans, **kw), 20)
    for N, V, tag in shapes:
        e3, n3, nsl, upd = (torch.from_numpy(a).to(dev)
                            for a in k3_case(N, V))
        for budget in (3, 32):
            lk = dict(SWEEP_KW, V=V, eps_conv=2e-3, max_sweeps=budget,
                      scan_sweeps=1, scan_period=0)
            timed(f"K3 {N} rows{tag} budget {budget}",
                  lambda: ks.esdf_sweep_loop(e3, n3, nsl, upd, **lk), 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="earlier checkout")
    ap.add_argument("--new", default=".", help="this checkout")
    ap.add_argument("--out", default=None, help="JSON file of the turns")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(a.worker)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = []
    for tag in ("old", "new", "new", "old"):
        root = Path(a.old if tag == "old" else a.new).resolve()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--old", "-",
             "--worker", str(root)], cwd=str(root), capture_output=True,
            text=True)
        if res.returncode != 0:
            print(res.stdout[-2000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append({"tag": tag, "ms": ms})
        print(json.dumps(turns[-1]), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"card": smi, "turns": turns},
                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
