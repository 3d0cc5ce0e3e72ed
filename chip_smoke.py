#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (taichislam_tpu_torch) on one GPU.

Phases:
  1. card line (nvidia-smi) and the kernel build (nvcc, from csrc/), with
     each kernel's registers, local memory (stack frame, spills) and static
     shared memory as ptxas reported them (the V > 20 builds k2_kernel_gm
     and k3_loop_kernel<-1> included) and K2/K3's dynamic shared memory
     per row, or device-memory scratch per CTA past V = 20;
  2. each hand-written kernel against its plain PyTorch twin on the card,
     at the main path's shapes (K1 at its five call sites, two calls
     bit-identical, and with a lane cap inside a block; K2 at 264 and 1056
     rows with and without scans, and equal to the twin where every slab is
     idle, on a single 8-row slab with no gate and at V = 8 and 7; K3 at
     264 and 1056 rows, budgets 3 and 32, and at V = 8 and 7, stats equal
     to the twin's; V = 16 and 8 are compiled with constant shapes, V = 7
     takes the runtime-shape build; K2 and K3 also at 264 rows with V = 24
     and 32, the device-memory build, equal to the twin exactly), with both
     times (CUDA events,
     median), the bound (bytes or operations, counted from this run's
     inputs: valid lanes, the rows and updating voxels each call or sweep
     computes), the library yardstick
     where there is one, and the CUDA kernels of one call from
     torch.profiler (only the kernel's own, no aten op but allocation);
  3. the main path at the bench configuration: 640x480 depth frames fused
     into a 5 cm TSDF (V = 16, 2048 blocks, float16 storage) with the
     per-frame incremental ESDF (budget 3, and budget 1, which takes the
     per-sweep kernel), capacities grown until nothing is dropped; the
     kernels' launch counters must grow during this run;
  4. the first frames again through the plain path on the CPU: tables and
     observed flags exact, TSDF and ESDF within 4e-3, sweep counts equal;
  5. the model API: DenseESDF.recast_depth_to_map on the card;
  6. the node's default single-map path, built as taichislam_tpu/node/core.py
     builds it: a textured DenseESDF over a 100 x 10 m map at 5 cm with the
     D435 depth and color cameras (color_same_proj=False) and the default
     ESDF modes, plus the incremental MarchingCubeMesher; per frame
     recast_depth_to_map, generate_mesh(1), cvt_TSDF_surface_to_voxels and
     cvt_ESDF_to_voxels_slice(0.0) over 16 textured 640x480 frames, then
     saveMap / DenseTSDF.loadMap. No capacity may drop, K1 must launch, the
     ESDF must be finite, the mesh and both exports non-empty;
  7. the first frames of that path on the card and through the plain path
     on the CPU, on a 10 x 10 m map: tables, observed and fixed flags, ESDF
     modes and sweeps exact; TSDF, color and ESDF within 4e-3; triangle and
     export counts exact, vertices within 1e-4 m;
  8. the launch files' path (enable_submap, mapping_type=tsdf), built as
     taichislam_tpu/node/core.py:152-169 builds it: SubmapMapping(DenseTSDF)
     with the node's option builders (100 x 10 m, 5 cm, V = 16, textured),
     keyframe_step 10, the D435 cameras and the MarchingCubeMesher on the
     global map; 40 textured orbit frames, so full refuses at frames 10, 20
     and 30, each logged with its ms, lanes and block cap. No capacity may
     drop, K1 must launch at the fusion site; then drone B ingests A's
     payloads, A re-poses by PGO and flushes (the PGO refuse read twice,
     before and after the flush, each with the cudaMalloc calls made
     inside it), and the same frames with incremental_fuse +
     async_finalize must give the same global map. K1
     is also held against its twin on the lanes of a full refuse of that
     collection (reported as phase 2's fusion shape), and a torch.profiler
     window gives kernels per frame and the idle share;
  9. the octo path: SubmapMapping(Octomap) at the node's get_octo_opts,
     40 frames, LOD exports at levels 0 and 1 non-empty;
 10. both submap types on a 10 x 10 m map, 9 frames, keyframe_step 4, on
     the card and on the CPU: global tables, observed flags, occupancy and
     sent-submap indices exact, TSDF / W / color within 4e-3;
 11. the topo graph on phase 6's map at the node's skeleton options,
     seeded at the ESDF slice's largest distance: max_nodes 100, then until
     the frontiers run out; nodes >= 1, facelets > 10, finite vertices on
     the map; nodes, facelets, frontiers, edges, wall ms, map calls, host
     syncs and ms per call;
 12. the same graph on phase 6's saved map loaded on the card and on the
     CPU: node, edge and frontier counts exact, facelets within 1e-5; and
     the TopoGen worker in a spawn process with a Manager dict on the card,
     edge lines back;
 13. DenseESDF at V = 24 (block mode only, so K3's device-memory build) on
     the bench-sized map, 4 frames, the profiler recording that build, card
     against CPU as in phase 7;
 14. the bundle-adjustment demo's gradient descent on the card to the JAX
     demo's convergence test, against the CPU; NNLS.solve_lm on the linear
     fit and the rotation BA of tests/test_opti.py, card against CPU within
     1e-4;
 15. TaichiSLAMNodeCore at the node's defaults with the ESDF type, the
     published map and its z = 0 slice and a browser-viewer render: 16
     orbit frames as fake messages through process_taichi and rendering()
     (per-frame ESDF mode, slice and surface counts, triangles, wall ms);
     then 4 frames on a 10 x 10 m map, a core on the card against a core on
     the CPU, published clouds exact;
 16. two cores with the launch file's parameters (drones 0 and 1) on a
     LoopbackTransport hub: 40 frames, boundary ms, drone 1's submaps, the
     PGO refuse, and which transport make_udpm_transport would pick;
 17. the entry points (demo_synthetic --topo --two-drones, demo -m tsdf
     with the browser viewer, gen_topo_graph --benchmark), each in its own
     process (wall s);
 18. recast_depth_sequence on the bench-sized map against the per-frame
     loop (DenseTSDF, DenseESDF at 6 and 32 sweeps, SubmapMapping), exact;
     and the sequences' graph path (one CUDA graph replay per frame)
     against the same windows through the eager *_ref loop, bit for bit;
 19. ShardedDenseTSDF at its own defaults (10 x 10 m, 5 cm, V = 16, 8192
     slots, f32, ESDF 8 sweeps and cap 512) over phase 3's frames: on a
     one-rank NCCL mesh, its ESDF equal after every frame to a
     single-device esdf_update chain on its state, K2 launched at the
     sharded call site and in the profiler, its integrate against the same
     model on the CPU (TSDF within 1e-5); then on 4 gloo ranks sharing the
     card, every rank's gathered map, ESDF, surface export and mesh patch
     equal to the one-rank run (ms/frame, collective bytes and peak memory
     per rank); then one rank and 4 ranks again with max_blocks cut so that
     the blocks land in every shard (every rank's K1 reduces lanes), equal;
 20. 4 drones as 4 gloo ranks sharing the card, with the launch file's
     submap and global configurations: 20 frames each through
     multi_drone_lifecycle_step (ESDF budget 6, mesh patch), then
     multi_drone_fuse; each drone exactly equal to the same drone run alone
     through the single-device ops, the fused map against fuse_submaps (ms
     per step and per fuse, the fuse's collective bytes). The ranks' launch
     counts add into the kernels line; the kernels are built once, in
     phase 1, before any rank starts;
 21. config 3 of tools/bench_configs.py at full size (10 x 10 m at 5 cm,
     V = 16, 4096 blocks, max ray 5.1 m, ESDF 8 sweeps, slack 0.5, eps
     2e-3) over 40 orbit frames (640x480) staged on the card once: the
     per-call deferred path (esdf_check_interval 8, capacity interval 8;
     one graph replay a frame) and the windowed path (W = 20), each in two
     passes, against the same frames through the eager *_ref loop on the
     card, bit for bit after every frame or window; the second pass timed
     (CUDA events) for both; graph captures and replays; K1 / K2 / K3
     launches per frame; the CUDA kernels of one frame and the idle share
     of one verdict interval (torch.profiler); no capacity drop in the
     timed pass; interval 8 against interval 1 drained, ESDF within 5e-3
     at tests/test_esdf.py:384's settings (raise slack 0, seed eps 0) and
     reported at config 3's own;
     the first 8 per-call frames against the CPU plain path (tables,
     observed and fixed flags exact, TSDF and ESDF within 4e-3);
 22. the port's bench.py (python -m taichislam_tpu_torch.bench) at full
     size through its run_bench: 50 orbit frames at 640x480 staged on the
     card once, every row (fusion only, fusion + ESDF at 3 and 32 sweeps,
     the 8192-block map) sized by the JAX bench's rule and timed over
     graph replays, the full-map and incremental marching cubes; its JSON
     line logged; no capture in a timed pass and no drop; launches per
     frame (2 K1, 1 K3 with the ESDF, no K2); the primary's map after its
     timed passes against the same window through the eager *_ref loop
     on the card, bit for bit at float16 storage, with both ms/frame and
     phase 3's beside them; the idle share of one profiled window;
 23. the port's tools, each in its own process: bench_configs --frames 40
     (all five configurations and their table), bench_secondary,
     compare_vs_reference (FIDELITY: PASS) and viewer_demo_scene on a free
     port for 3 s.

Exits non-zero without a result when no CUDA device is present. The last
line is {"ok": true, "device": {...}}; the line before it lists the kernels.

Usage: python3 chip_smoke.py
"""

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_FRAMES = 16
CPU_FRAMES = 4
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Median ms of ``fn()`` over ``reps`` runs (CUDA events, warmed)."""
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


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins, their bounds and yardsticks
# ---------------------------------------------------------------------------

# the least time the card could take (NVIDIA's data sheet, H100 SXM at
# 700 W): bytes over the HBM3 rate; f32 operations outside the tensor
# cores over their issue rate. The sheet's 67 TFLOP/s counts an FMA as two
# operations; the sweeps' adds, compares and mins are one each and issue
# at half that.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2


def bound(n_bytes, n_ops=0.0):
    """(bound_ms, bound_by) of work moving ``n_bytes`` (each input read
    once, each output written once) and doing ``n_ops`` f32 operations
    that are not FMAs."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def upd_ops(scans):
    """f32 operations of ``sweep_row`` at one voxel that updates: 26
    neighbour mins or maxes, three candidate adds, two candidate mins, the
    eps add, its compare, two clamps and the change test's subtract and
    compare, plus the min with the scan candidate on a scan sweep."""
    return 37 + int(scans)


def sweep_row_ops(V, n_upd, scans):
    """f32 operations of one row of ``sweep_row`` (csrc/esdf_sweep.cu),
    counted from its code, selects and index arithmetic left out: five
    compares per voxel of the row and its halo (observed, fixed, the two
    source tests, the sign); for each of the ``n_upd`` voxels that update,
    ``upd_ops(scans)``; on a scan sweep, the six axis scans: 2 V^2 lines
    per axis (one per sign), forward and back over the V interior positions
    (5 and 6 operations a position), and one more min a position on the
    axis whose candidates meet another axis's in shared memory."""
    ops = 5 * (V + 2) ** 3 + upd_ops(scans) * n_upd
    if scans:
        ops += 2 * V * V * V * (3 * 11 + 1)
    return ops


def updating_voxels(enc, V, gamma):
    """(N,) count per row of the interior voxels whose side is not zero
    where the row updates: observed and not fixed (the loop kernel's rule)."""
    import torch
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    W = V + 2
    obs = enc < ks.ENC_BIG * 0.5
    fixed = obs & (enc.abs() < float(np.float32(gamma)))
    c = torch.arange(W, device=enc.device)
    inter1 = (c >= 1) & (c <= V)
    inter = (inter1.view(W, 1, 1) & inter1.view(1, W, 1) &
             inter1.view(1, 1, W)).reshape(1, W, W * W)
    return (obs & ~fixed & inter).flatten(1).sum(1)


def k3_ops(e3, enc, nsl, upd, lk, stats):
    """(f32 operations, rows computed at least once) of this run's K3 loop:
    for each sweep, the rows it computes (the updatable rows of its active
    slabs), with the scans on the sweeps that take them. The gates are
    replayed with the twin: the slabs that changed in sweep s come from its
    fields after s - 1 and s sweeps (interiors, by more than eps_conv), and
    loop_gates_ref gives the next sweep's active slabs. Their count must
    equal the kernel's computed_slabs."""
    import torch
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    V = lk["V"]
    W = V + 2
    sweeps, _, comp, _ = (int(x) for x in stats.tolist())
    n_upd = updating_voxels(enc, V, lk["gamma"])
    updr = upd != 0
    acts, _ = ks.loop_gates_ref(nsl, upd)
    prev = e3.view(-1, W, W, W)[:, 1:-1, 1:-1, 1:-1]
    ops = n_comp = 0
    ever = torch.zeros_like(updr)
    for s in range(sweeps):
        scans = s < lk["scan_sweeps"] or (lk["scan_period"] > 0 and
                                          s % lk["scan_period"] == 0)
        rows = acts.repeat_interleave(8) & updr
        ever |= rows
        n_comp += int(acts.sum())
        nv = n_upd[rows]
        ops += int(rows.sum()) * sweep_row_ops(V, 0, scans) + \
            int(nv.sum()) * upd_ops(scans)
        fld, _ = ks.esdf_sweep_loop_ref(e3, enc, nsl, upd,
                                        **dict(lk, max_sweeps=s + 1))
        cur = fld.view(-1, W, W, W)[:, 1:-1, 1:-1, 1:-1]
        chg = ((cur - prev).abs() > float(np.float32(lk["eps_conv"])))
        slabchg = chg.flatten(1).any(1).view(-1, 8).any(1)
        acts, _ = ks.loop_gates_ref(nsl, upd, slabchg)
        prev = cur
    require(n_comp == comp, f"K3 op count: {n_comp} computed slabs replayed "
            f"against the kernel's {comp}")
    return ops, int(ever.sum())


# windows taken of one call before its device time counts as not measured
PROFILE_TRIES = 6


def profile_call(fn, expect=()):
    """torch.profiler over one call of ``fn`` (warmed): the CUDA kernels by
    name with their counts and device ms, and the aten ops other than
    allocation. A window that recorded no CUDA kernel, or none whose name
    holds one of ``expect`` (the profiler now and then misses a window's
    device events, several in a row), is taken again after a growing
    pause, up to PROFILE_TRIES windows in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        time.sleep(0.2 * t)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [a.key for a in prof.key_averages()
                 if a.device_type == torch.autograd.DeviceType.CUDA]
        if names and all(any(e in n for n in names) for e in expect):
            break
    kernels, aten = {}, {}
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(a.key, (0, 0.0))
            kernels[a.key] = (n + a.count, us + a.device_time_total)
        elif a.key.startswith("aten::") and a.key not in ALLOC_OPS:
            aten[a.key] = a.count
    return kernels, aten


ALLOC_OPS = ("aten::empty", "aten::empty_like", "aten::empty_strided")
# the kernels every K1 call issues (the sort passes vary with the keys)
K1_STAGES = ("k1_init", "k1_prepare", "k1_heads", "k1_reduce")


def kernel_name(k):
    """A profiler's kernel name without its return type, namespace and
    arguments."""
    k = k.replace("void ", "").replace("(anonymous namespace)::", "")
    return k.split("(")[0]


def profile_line(tag, fn, ms, prefix, expect=()):
    """Print the kernels of one call (count and device ms by name) beside
    its event time; require that the call ran only kernels whose names hold
    ``prefix`` and no aten op other than allocation. Returns (kernels per
    call, device ms), both None when no window recorded a CUDA kernel (the
    call's kernel has already matched its twin; only its device time is
    then not measured)."""
    kernels, aten = profile_call(fn, expect)
    require(not aten, f"{tag}: aten ops on the kernel path {aten}")
    if not kernels:
        log(f"[phase2] {tag} profiler: no CUDA kernel recorded in "
            f"{PROFILE_TRIES} windows (the profiler's misses, PERF.md §7): "
            f"device ms not measured; aten ops besides allocation none")
        return None, None
    short = {}
    for k, (n, us) in kernels.items():
        k = kernel_name(k).split("<")[0]
        n0, us0 = short.get(k, (0, 0.0))
        short[k] = (n0 + n, us0 + us)
    n_k = sum(n for n, _ in short.values())
    dev_ms = sum(us for _, us in short.values()) / 1000.0
    parts = ", ".join(f"{k} {n}x {us / 1000.0:.4f} ms"
                      for k, (n, us) in short.items())
    log(f"[phase2] {tag} profiler: {n_k} CUDA kernels per call ({parts}), "
        f"device {dev_ms:.4f} ms beside event {ms:.4f} ms; aten ops besides "
        f"allocation {aten or 'none'}")
    require(all(prefix in k for k in kernels),
            f"{tag}: kernels outside csrc/ {list(kernels)}")
    return n_k, dev_ms


def k1_bytes(bkey, n_vals, max_touched, V3, max_bkey):
    """K1's bytes: bkey and intra of every lane and the values of the valid
    lanes in (k1_prepare reads no value of an invalid lane); touched, the
    tiles and the two counts out."""
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    n_valid = int((bkey < k1._key_bound(max_bkey)).sum())
    return (bkey.numel() * 8 + n_valid * 4 * n_vals +
            max_touched * (4 + 4 * n_vals * V3) + 8)


def k1_library(name, args, kw, dev):
    """(label, ms) of one PyTorch call beside K1: at the presorted bins
    sites ``index_add_`` computes the whole tile; at the
    march and fusion sites ``torch.sort`` of the u32 packed keys (as int32)
    is only the sort, K1's first stage."""
    import torch
    bkey, intra, vals = args
    V3 = kw["V3"]
    if kw.get("presorted"):
        ok = bkey < 2 ** 24
        v = torch.where(ok[None, :], torch.stack(vals), 0.0)
        idx = torch.where(ok, intra, 0).long()
        acc = torch.zeros((len(vals), V3), device=dev)
        return "index_add_ (the whole tile)", cuda_ms(
            lambda: acc.index_add_(1, idx, v), 20)
    key = torch.where(bkey < 2 ** 24, bkey * V3 + intra,
                      torch.full_like(bkey, 2 ** 30))
    return "torch.sort of the int32 keys (the sort alone)", cuda_ms(
        lambda: torch.sort(key, stable=True), 5 if name == "fusion" else 20)


def check_seg_accum(dev, results):
    import torch
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    from kernel_ab import k1_cap_case, k1_cases

    err, shapes = 0.0, []
    for name, bkey, intra, vals, kw, mb in k1_cases():
        args = (torch.from_numpy(bkey).to(dev),
                torch.from_numpy(intra).to(dev),
                [torch.from_numpy(v).to(dev) for v in vals])
        kw = dict(kw, max_bkey=mb)
        got = k1.segmented_block_reduce(*args, site="check", **kw)
        again = k1.segmented_block_reduce(*args, site="check", **kw)
        want = k1.segmented_block_reduce_ref(*args, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]), f"K1 {name}: touched keys")
        require(int(got[2]) == int(want[2]), f"K1 {name}: n_touched")
        require(int(got[3]) == int(want[3]), f"K1 {name}: lanes_dropped")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K1 {name}: two calls differ")
        e = float((got[1] - want[1]).abs().max())
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        err = max(err, e)
        reps = 5 if name == "fusion" else 20
        ms = cuda_ms(lambda: k1.segmented_block_reduce(*args, site="check",
                                                       **kw), reps)
        pms = cuda_ms(lambda: k1.segmented_block_reduce_ref(*args, **kw),
                      3 if name == "fusion" else 20)
        N, nv = len(bkey), len(vals)
        b_ms, b_by = bound(k1_bytes(args[0], nv, kw["max_touched"], kw["V3"],
                                    mb))
        label, lib_ms = k1_library(name, args, kw, dev)
        log(f"[phase2] K1 {name}: {N} lanes, {nv} values, n_touched "
            f"{int(got[2])}, lanes_dropped {int(got[3])}, max_abs_err {e}, "
            f"two calls bit-identical; ms {ms:.4f} plain_ms {pms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}) library_ms {lib_ms:.4f} "
            f"[{label}]")
        n_k, dev_ms = profile_line(
            f"K1 {name}", lambda: k1.segmented_block_reduce(
                *args, site="check", **kw), ms, "k1_", expect=K1_STAGES)
        shapes.append(dict(shape=name, lanes=N, n_vals=nv, ms=ms,
                           device_ms=dev_ms,
                           plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, library_call=label,
                           kernels_per_call=n_k, max_abs_err=e))
        del args, got, again, want
    check_seg_accum_cap(dev, k1_cap_case())
    check_seg_accum_packed(dev, shapes)
    march = shapes[0]
    results["K1"] = dict(max_abs_err=err, ms=march["ms"],
                         plain_ms=march["plain_ms"],
                         bound_ms=march["bound_ms"],
                         bound_by=march["bound_by"], library_ms=None,
                         shapes=shapes)


def check_seg_accum_packed(dev, shapes):
    """K1w, segmented_block_accumulate (packed keys bkey * V3 + intra, two
    values), at the march shape: equal to K1 on the unpacked keys; its event
    ms, the device ms of its kernels (K1's and the PyTorch ops that unpack
    the keys), the plain version's ms (the twin on the unpacked keys) and
    the bound of the same work."""
    import torch
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    from kernel_ab import k1_cases
    name, bkey, intra, vals, kw, _ = k1_cases(fusion=False)[0]
    ok = bkey < k1.SENTINEL_BLOCK
    keys = np.where(ok, bkey.astype(np.int64) * kw["V3"] + intra,
                    k1.SENTINEL_KEY).astype(np.int32)
    keys, w, wd = (torch.from_numpy(a).to(dev) for a in (keys, *vals))
    args = (keys, w, wd, kw["V3"], kw["max_touched"])
    got = k1.segmented_block_accumulate(*args)
    unpacked = (torch.from_numpy(bkey).to(dev),
                torch.from_numpy(intra).to(dev), (w, wd), kw["V3"],
                kw["max_touched"])
    want = k1.segmented_block_reduce(*unpacked, site="check")
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and int(got[2]) == int(want[2]), "K1w: differs from K1")
    ms = cuda_ms(lambda: k1.segmented_block_accumulate(*args), 20)
    pms = cuda_ms(lambda: k1.segmented_block_reduce_ref(*unpacked), 20)
    kernels, _ = profile_call(lambda: k1.segmented_block_accumulate(*args),
                              K1_STAGES)
    dev_ms = sum(us for _, us in kernels.values()) / 1000.0 if kernels \
        else None
    b_ms, b_by = bound(keys.numel() * 4 + int(ok.sum()) * 8 +
                       kw["max_touched"] * (4 + 8 * kw["V3"]) + 4)
    log(f"[phase2] K1w segmented_block_accumulate at the {name} shape: as "
        f"K1 on the unpacked keys; ms {ms:.4f} device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
        f"({sum(n for n, _ in kernels.values())} CUDA kernels) plain_ms "
        f"{pms:.4f} (the twin on the unpacked keys) bound_ms {b_ms:.4f} "
        f"({b_by}); main-path launches 0")
    shapes.append(dict(shape=f"K1w {name}", lanes=len(keys), n_vals=2,
                       ms=ms, device_ms=dev_ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None,
                       kernels_per_call=None, max_abs_err=0.0))


def check_seg_accum_cap(dev, case):
    """K1 where the lane cap cuts inside a block and some block keys lie at
    or past max_bkey: touched keys, n_touched, lanes_dropped (> 0) and the
    tiles as the twin gives them."""
    import torch
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    bkey, intra, vals, kw, mb = case
    args = (torch.from_numpy(bkey).to(dev), torch.from_numpy(intra).to(dev),
            [torch.from_numpy(v).to(dev) for v in vals])
    kw = dict(kw, max_bkey=mb)
    got = k1.segmented_block_reduce(*args, site="check", **kw)
    want = k1.segmented_block_reduce_ref(*args, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "K1 cap: touched keys")
    require(int(got[2]) == int(want[2]), "K1 cap: n_touched")
    require(int(got[3]) == int(want[3]) > 0,
            f"K1 cap: lanes_dropped {int(got[3])} vs {int(want[3])}")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    e = float((got[1] - want[1]).abs().max())
    log(f"[phase2] K1 lane cap {kw['lane_cap']} inside a block, max_bkey "
        f"{mb}: n_touched {int(got[2])}, lanes_dropped {int(got[3])}, "
        f"max_abs_err {e}, as the twin")


def k2_bound(V, slab_act, side, scans):
    """(bound_ms, bound_by) of one K2 call, counted from this call's
    inputs. Bytes: every row's field read and written (an idle slab's row
    only passes through), the side of the interior voxels of the rows of
    active slabs (interior-only by contract), the enc of those rows that
    have a voxel to update, and the gate. Operations: sweep_row's on each
    of those rows and at each of their updating voxels."""
    N, W3 = side.shape[0], (V + 2) ** 3
    act = slab_act.repeat_interleave(8) != 0
    n_upd = (side != 0).flatten(1).sum(1)
    rows = act & (n_upd > 0)
    n_act, n_rows = int(act.sum()), int(rows.sum())
    return bound(N * W3 * 8 + n_act * V ** 3 + n_rows * W3 * 4 + N // 8 * 4,
                 n_rows * sweep_row_ops(V, 0, scans) +
                 int(n_upd[act].sum()) * upd_ops(scans))


def sweep_shapes():
    """(rows, V) of K2 and K3 in phase 2: the bench's 264 rows and 1056 at
    V = 16, and 264 rows at V = 24 and 32."""
    from kernel_ab import K2_ROWS, SWEEP_KW
    V = SWEEP_KW["V"]
    return [(K2_ROWS, V), (4 * K2_ROWS, V), (K2_ROWS, 24), (K2_ROWS, 32)]


def check_esdf(dev, results):
    import torch
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from kernel_ab import SWEEP_KW, k2_case, k3_case

    # K2 at the bench's 264 rows (one wave) and at 1056 rows (past it),
    # and at V = 24 and 32 (rows too large for shared memory: the
    # device-memory build), which must equal the twin exactly
    err2, k2 = 0.0, []
    for N, V in sweep_shapes():
        kw = dict(SWEEP_KW, V=V)
        tag = f"{N} rows" + ("" if V == SWEEP_KW["V"] else f" V = {V}")
        esdf, enc, side, slab_act = (torch.from_numpy(a).to(dev)
                                     for a in k2_case(N, V=V))
        for scans in (False, True):
            got = ks.esdf_sweep(esdf, enc, side, slab_act, with_scans=scans,
                                **kw)
            want = ks.esdf_sweep_ref(esdf, enc, side, slab_act,
                                     with_scans=scans, **kw)
            e = float((got - want).abs().max())
            require(e <= (0.0 if V > ks.MAX_V else 1e-6),
                    f"K2 {tag} scans={scans}: max abs err {e}")
            err2 = max(err2, e)
            ms = cuda_ms(lambda: ks.esdf_sweep(esdf, enc, side, slab_act,
                                               with_scans=scans, **kw), 20)
            pms = cuda_ms(lambda: ks.esdf_sweep_ref(
                esdf, enc, side, slab_act, with_scans=scans, **kw), 5)
            b_ms, b_by = k2_bound(V, slab_act, side, scans)
            log(f"[phase2] K2 {tag} scans={scans}: max_abs_err {e} ms "
                f"{ms:.4f} plain_ms {pms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
                f"library_ms none (no single PyTorch call computes it)")
            n_k, dev_ms = profile_line(
                f"K2 {tag} scans={scans}",
                lambda: ks.esdf_sweep(esdf, enc, side, slab_act,
                                      with_scans=scans, **kw), ms, "k2_")
            k2.append(dict(shape=f"{tag} scans={scans}", V=V, ms=ms,
                           device_ms=dev_ms, plain_ms=pms, bound_ms=b_ms,
                           bound_by=b_by, kernels_per_call=n_k,
                           max_abs_err=e))
        del esdf, enc, side, slab_act, got, want
    check_esdf_edges(dev)
    main = k2[1]   # 264 rows with scans
    results["K2"] = dict(max_abs_err=err2, ms=main["ms"],
                         plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"], library_ms=None,
                         shapes=k2)

    # K3 at the bench's 264 rows and at 1056 rows (more rows than CTAs fit
    # on the card at once, so CTAs take rows by grid stride), and at V = 24
    # and 32 (the device-memory build)
    err3, shapes = 0.0, []
    for n_rows, V in sweep_shapes():
        kw = dict(SWEEP_KW, V=V)
        W3 = (V + 2) ** 3
        tag = f"{n_rows} rows" + ("" if V == SWEEP_KW["V"] else f" V = {V}")
        e3, n3, nsl, upd = (torch.from_numpy(a).to(dev)
                            for a in k3_case(n_rows, V=V))
        for budget in (3, 32):
            lk = dict(kw, eps_conv=2e-3, max_sweeps=budget, scan_sweeps=1,
                      scan_period=0)
            got, gst = ks.esdf_sweep_loop(e3, n3, nsl, upd, **lk)
            want, wst = ks.esdf_sweep_loop_ref(e3, n3, nsl, upd, **lk)
            require(torch.equal(gst.cpu(), wst.cpu()),
                    f"K3 {tag} budget {budget}: stats "
                    f"{gst.tolist()} vs {wst.tolist()}")
            e = float((got - want).abs().max())
            require(e <= (0.0 if V > ks.MAX_V else 1e-6),
                    f"K3 {tag} budget {budget}: max abs err {e}")
            rows_g = ((got - e3).abs() > 2e-3).flatten(1).any(1)
            rows_w = ((want - e3).abs() > 2e-3).flatten(1).any(1)
            require(torch.equal(rows_g, rows_w),
                    f"K3 {tag} budget {budget}: rows")
            err3 = max(err3, e)
            ms = cuda_ms(lambda: ks.esdf_sweep_loop(e3, n3, nsl, upd, **lk),
                         10)
            pms = cuda_ms(lambda: ks.esdf_sweep_loop_ref(e3, n3, nsl, upd,
                                                         **lk), 3)
            sweeps = int(gst[0])
            # the field read and written; the enc of the rows computed at
            # least once; the neighbour table, upd and the stats
            ops, n_enc = k3_ops(e3, n3, nsl, upd, lk, gst)
            b_ms, b_by = bound(n_rows * W3 * 8 + n_enc * W3 * 4 +
                               n_rows * 27 * 4 + n_rows * 4 + 16, ops)
            log(f"[phase2] K3 {tag} budget {budget}: stats "
                f"{gst.tolist()} max_abs_err {e} ms {ms:.4f} plain_ms "
                f"{pms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms none "
                f"(no single PyTorch call computes it)")
            n_k, dev_ms = profile_line(
                f"K3 {tag} budget {budget}",
                lambda: ks.esdf_sweep_loop(e3, n3, nsl, upd, **lk), ms,
                "k3_loop_kernel")
            require(n_k in (1, None), f"K3: {n_k} kernels in one call")
            shapes.append(dict(shape=f"{tag} budget {budget}", V=V,
                               sweeps=sweeps, ms=ms, device_ms=dev_ms,
                               plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                               kernels_per_call=n_k, max_abs_err=e))
        del e3, n3, nsl, upd, got, want
    first = shapes[0]
    results["K3"] = dict(max_abs_err=err3, ms=first["ms"],
                         plain_ms=first["plain_ms"],
                         bound_ms=first["bound_ms"],
                         bound_by=first["bound_by"], library_ms=None,
                         shapes=shapes)


def check_esdf_edges(dev):
    """K2 where every slab is idle (every row passes through), on a single
    8-row slab with no gate (a null gate on the card), at V = 8 (the other
    constant-shape build) and at V = 7 (the runtime-shape build, loading
    voxel by voxel since a plane is no whole number of float4s), with and
    without scans; K3 at V = 8 and 7, budget 32. Each equal to its twin
    within 1e-6, K3's stats exactly."""
    import torch
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from kernel_ab import SWEEP_KW, k2_case, k3_case, sweep_fields
    esdf, enc, side, slab_act = (torch.from_numpy(a).to(dev)
                                 for a in k2_case())
    rng = np.random.default_rng(5)
    one = [torch.from_numpy(a).to(dev) for a in sweep_fields(
        rng, 8, SWEEP_KW["V"], 8)]
    cases = [("all slabs idle", (esdf, enc, side, torch.zeros_like(
        slab_act)), SWEEP_KW), ("one 8-row slab, no gate", (*one, None),
                                SWEEP_KW)]
    for V in (8, 7):
        f = [torch.from_numpy(a).to(dev) for a in sweep_fields(rng, 64, V,
                                                                48)]
        cases.append((f"V = {V}, 64 rows", (*f, slab_act[:8]),
                      dict(SWEEP_KW, V=V)))
    for name, args, kw in cases:
        for scans in (False, True):
            got = ks.esdf_sweep(*args, with_scans=scans, **kw)
            want = ks.esdf_sweep_ref(*args, with_scans=scans, **kw)
            e = float((got - want).abs().max())
            require(e <= 1e-6, f"K2 {name} scans={scans}: max abs err {e}")
            if name == "all slabs idle":
                require(torch.equal(got, args[0]), "K2 idle slabs changed")
            log(f"[phase2] K2 {name} scans={scans}: max_abs_err {e}, as "
                f"the twin")
    for V in (8, 7):
        args = [torch.from_numpy(a).to(dev) for a in k3_case(64, V=V)]
        lk = dict(SWEEP_KW, V=V, eps_conv=2e-3, max_sweeps=32,
                  scan_sweeps=1, scan_period=0)
        got, gst = ks.esdf_sweep_loop(*args, **lk)
        want, wst = ks.esdf_sweep_loop_ref(*args, **lk)
        e = float((got - want).abs().max())
        require(torch.equal(gst.cpu(), wst.cpu()) and e <= 1e-6,
                f"K3 V = {V}: stats {gst.tolist()} vs {wst.tolist()}, max "
                f"abs err {e}")
        log(f"[phase2] K3 V = {V}, 64 rows budget 32: stats {gst.tolist()} "
            f"max_abs_err {e}, as the twin")


def build_report():
    """Registers, local memory (stack frame, spills) and shared memory per
    kernel, as ptxas reported them in build/kernels/build.log, and K2/K3's
    dynamic shared memory per row at V = 16 and 8."""
    import re
    from taichislam_tpu_torch.ops.kernels import build
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from kernel_ab import SWEEP_KW
    name, spill, rows = None, "", []
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(k[123]_[a-z_]+)", m.group(1))
            name, spill = (k.group(1) if k else m.group(1)), ""
            v = re.search(r"ILi(n?\d+)E", m.group(1))   # template <int VC>
            name += f"<{v.group(1).replace('n', '-')}>" if v else ""
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and int(m.group(1)):
            spill = f" (stack frame {m.group(1)} B, spills {m.group(2)} / " \
                f"{m.group(3)} B)"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            st = re.search(r"(\d+) bytes smem", line)
            rows.append(f"{name} {m.group(1)} regs "
                        f"{st.group(1) if st else 0} B static{spill}")
            name = None
    V = SWEEP_KW["V"]
    log(f"[phase1] ptxas per kernel: {'; '.join(rows)}; K2/K3 dynamic "
        f"shared memory per row at V = {V}: {ks.row_smem_bytes(V)} B, at "
        f"V = 8: {ks.row_smem_bytes(8)} B; past V = {ks.MAX_V} (k2_kernel_gm, "
        f"k3_loop_kernel<-1>) the row lives in device memory, "
        f"{ks.row_scratch_bytes(24)} B per CTA at V = 24 and "
        f"{ks.row_scratch_bytes(32)} B at V = 32")


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def bench_config():
    from taichislam_tpu_torch.core.config import TSDFConfig
    return TSDFConfig(
        map_scale=(10.0, 10.0), voxel_scale=0.05, num_voxel_per_blk_axis=16,
        max_ray_length=3.0, min_ray_length=0.3, recast_step=2,
        max_blocks=2048, max_bins=8192, max_submap_num=64,
        max_touched_blocks=256, max_march_lanes=524288,
        storage_dtype="float16", esdf_raise_slack_voxels=0.5,
        esdf_converge_eps=2e-3)


def run_frames(cfg, frames, dev, esdf_cap, budget, n=None, stages=None):
    """The per-frame loop: integrate, gate, incremental ESDF. Returns the
    final state, ESDF arrays, per-frame sweeps and the capacity maxima.
    With ``stages`` (a list), CUDA events around the three stages of each
    frame are appended to it."""
    import torch
    from taichislam_tpu_torch.ops import esdf as esdf_ops
    from taichislam_tpu_torch.ops import tsdf as tsdf_ops

    depth, Rs, Ts, K = frames
    spec = cfg.grid
    shape = (spec.max_blocks + 1, spec.voxels_per_block)
    state = tsdf_ops.make_tsdf_state(cfg, device=dev)
    esdf = torch.zeros(shape, device=dev)
    fixed = torch.zeros(shape, dtype=torch.int8, device=dev)
    pending = torch.zeros((shape[0],), dtype=torch.bool, device=dev)
    seen_t = torch.zeros(shape, device=dev)
    seen_o = torch.zeros(shape, dtype=torch.bool, device=dev)
    part = None
    rows = []
    def mark():
        if stages is not None:
            stages.append(torch.cuda.Event(enable_timing=True))
            stages[-1].record()

    for f in range(len(depth) if n is None else n):
        mark()
        state, stats = tsdf_ops.integrate_depth(cfg, state, depth[f], None,
                                                Rs[f], Ts[f], K, K, 0)
        sweeps = ov = torch.zeros((), dtype=torch.int32, device=dev)
        mark()
        if budget:
            dirty, seen_t, seen_o = esdf_ops.esdf_seed_dirty(
                cfg, state, seen_t, seen_o, stats["touched_blocks"])
            dirty = dirty | pending
            mark()
            esdf, fixed, part, sweeps, pending, ov = esdf_ops.esdf_update(
                cfg, budget, esdf_cap, state, esdf, fixed, 0, dirty,
                tsdf_src=seen_t, obs_src=seen_o)
            mark()
        rows.append(torch.stack([
            stats["alloc_overflow"] + stats["touched_dropped"] +
            stats["lanes_dropped"], stats["bins_dropped"], ov.to(torch.int32),
            stats["num_bins"] + stats["bins_dropped"], stats["live_lanes"],
            sweeps.to(torch.int32)]))
    per_frame = torch.stack(rows).cpu().numpy()
    return state, esdf, fixed, part, per_frame


def size_capacities(cfg, frames, dev, esdf_cap, budget):
    """Grow capacities as bench.py does until no frame drops anything."""
    from taichislam_tpu_torch.models.dense_tsdf import bin_bucket_for
    for _ in range(8):
        *_, pf = run_frames(cfg, frames, dev, esdf_cap, budget)
        dropped, bins_dropped, esdf_ov = (int(pf[:, i].max())
                                          for i in range(3))
        want = bin_bucket_for(int(pf[:, 3].max()))
        want_lanes = bin_bucket_for(int(pf[:, 4].max()))
        if esdf_ov > 0:
            need = esdf_cap + esdf_ov
            while esdf_cap < need:
                esdf_cap *= 2
        elif dropped + bins_dropped == 0 and want >= cfg.max_bins and \
                cfg.max_march_lanes == want_lanes:
            return cfg, esdf_cap, pf
        elif dropped + bins_dropped == 0 and want < cfg.max_bins:
            cfg = dataclasses.replace(cfg, max_bins=want,
                                      max_march_lanes=want_lanes)
        elif dropped + bins_dropped == 0:
            cfg = dataclasses.replace(cfg, max_march_lanes=want_lanes)
        else:
            cfg = dataclasses.replace(
                cfg, max_bins=max(want, cfg.max_bins),
                max_march_lanes=want_lanes,
                max_touched_blocks=cfg.max_touched_blocks * 2)
    raise AssertionError("capacities did not settle without drops")


# ---------------------------------------------------------------------------
# phases 6-7: the node's default single-map path
# ---------------------------------------------------------------------------

# taichislam_tpu/node/core.py:80-89 (D435 depth and color cameras) and the
# map options of get_esdf_opts (core.py:107-143)
KDEPTH = np.array([384.2377014160156, 0.0, 323.4873046875, 0.0,
                   384.2377014160156, 235.0628204345703, 0.0, 0.0, 1.0],
                  np.float32)
KCOLOR = KDEPTH.copy()
NODE_MAP = dict(map_scale=[100, 10], voxel_scale=0.05, texture_enabled=True,
                color_same_proj=False, max_ray_length=5.1,
                min_ray_length=0.3, disp_ceiling=1.8, disp_floor=-0.3,
                max_esdf_sweeps=64)
BENCH_MAP = dict(NODE_MAP, map_scale=[10, 10], max_submap_num=64)
DROP_KEYS = ("alloc_overflow", "touched_dropped", "lanes_dropped",
             "bins_dropped")


def textures(n, h=480, w=640, seed=7):
    """Deterministic, spatially coherent, non-constant RGB frames."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for f in range(n):
        base = np.stack([128 + 100 * np.sin((ii + 13 * f) / 40.0),
                         128 + 100 * np.cos((jj - 7 * f) / 30.0),
                         (ii // 16 * 37 + jj // 16 * 53 + f * 11) % 256], -1)
        out.append(np.clip(base + rng.integers(0, 16, (h, w, 3)), 0,
                           255).astype(np.uint8))
    return out


class Timer:
    """Per-stage milliseconds: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, dev):
        import torch
        self.cuda = dev.type == "cuda"
        self.torch = torch
        self.marks = []

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks[:-1],
                                                      self.marks[1:])]
        return [1000 * (b - a) for a, b in zip(self.marks[:-1],
                                                self.marks[1:])]


def hold_bins(m, floor):
    """Hold a DenseTSDF's adaptive ray-bin bucket at or above ``floor``."""
    follow = m._update_bin_bucket

    def held(stats):
        follow(stats)
        m._bin_bucket = max(m._bin_bucket, floor)
    m._update_bin_bucket = held
    m._bin_bucket = floor


def node_run(dev, frames, texs, map_kw, n, bin_floor=None):
    """Drive the node's per-frame loop for ``n`` frames. The model adapts
    its ray-bin bucket to each frame's load, so a frame whose load rises
    past the bucket drops bins; ``bin_floor`` (the largest bucket a sizing
    pass needed) holds the bucket at or above it. Returns (model, mesher,
    per-frame records, per-frame stage ms)."""
    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
    depth, Rs, Ts = frames
    m = DenseESDF(**map_kw, device=dev)
    m.set_dep_camera_intrinsic(KDEPTH)
    m.set_color_camera_intrinsic(KCOLOR)
    mesher = MarchingCubeMesher(m, 1_000_000, tsdf_surface_thres=0.25)
    if bin_floor is not None:
        hold_bins(m, bin_floor)
    recs, stage_ms = [], []
    for f in range(n):
        t = Timer(dev)
        t.mark()
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f], texs[f])
        t.mark()
        mesher.generate_mesh(1)
        t.mark()
        m.cvt_TSDF_surface_to_voxels()
        t.mark()
        m.cvt_ESDF_to_voxels_slice(0.0)
        t.mark()
        stage_ms.append(t.ms())
        st = m.last_stats
        drops = {k: int(st[k]) for k in DROP_KEYS if int(st[k])}
        recs.append(dict(
            mode=m._esdf_last_mode, sweeps=m.last_esdf_sweeps,
            dirty=m.last_esdf_dirty, drops=sum(drops.values()),
            dropped=drops, bucket=m._bin_bucket,
            tris=mesher.num_facelets, surface=m.num_TSDF_particles,
            slice=m.num_export_ESDF_particles))
    return m, mesher, recs, np.array(stage_ms)


def node_phase(dev, smi, frames, texs, launches):
    """Phase 6: the node path at the node's defaults, 16 frames; a first
    untimed pass finds the largest ray-bin bucket the frames need (and
    warms the allocator), the measured pass holds the bucket there.
    Returns the map, its saveMap file (kept for phases 11-12) and that
    file loaded on the card."""
    import torch
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    wm, _, wrec, _ = node_run(dev, frames, texs, NODE_MAP, N_FRAMES)
    floor = max(r["bucket"] for r in wrec)
    log(f"[phase6] sizing pass (follow-the-load bin bucket): drops/frame "
        f"{[r['dropped'] for r in wrec]}, buckets "
        f"{[r['bucket'] for r in wrec]}, modes {[r['mode'] for r in wrec]}")
    del wm
    counters = (k1.segmented_block_reduce, ks.esdf_sweep, ks.esdf_sweep_loop)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m, mesher, recs, ms = node_run(dev, frames, texs, NODE_MAP, N_FRAMES,
                                   bin_floor=floor)
    torch.cuda.synchronize()
    got = dict(zip(("K1", "K2", "K3"), (c.launches for c in counters)))
    for k, v in got.items():
        launches[k] += v
    log(f"[phase6] launches during the node path: {got}")
    # K1 fuses the map and K3 sweeps its block frames; phase 11 reads it
    require(got["K1"] > 0 and got["K3"] > 0,
            f"node path: K1 or K3 not launched ({got})")
    require(max(r["drops"] for r in recs) == 0,
            f"node path: capacity drops {[r['dropped'] for r in recs]}")
    require(bool(torch.isfinite(m.esdf[m.esdf_observed]).all()),
            "node path: ESDF not finite")
    require(int(m.esdf_observed.sum()) > 0, "node path: empty ESDF")
    require(mesher.num_facelets > 0, "node path: no triangles")
    require(min(r["surface"] for r in recs) > 0 and
            min(r["slice"] for r in recs) > 0, "node path: empty export")
    log(f"[phase6] ESDF mode/frame {[r['mode'] for r in recs]}")
    log(f"[phase6] sweeps/frame {[r['sweeps'] for r in recs]} dirty/frame "
        f"{[r['dirty'] for r in recs]}")
    log(f"[phase6] triangles/frame {[r['tris'] for r in recs]} surface "
        f"{recs[-1]['surface']} slice {recs[-1]['slice']} particles")
    per = ms.mean(0)
    log(f"[phase6] ms/frame: recast (fusion + ESDF) {per[0]:.3f} mesh "
        f"{per[1]:.3f} surface export {per[2]:.3f} ESDF slice {per[3]:.3f} "
        f"total {per.sum():.3f} ({smi})")
    log(f"[phase6] recast ms per frame {np.round(ms[:, 0], 3).tolist()}")
    log(f"[phase6] launches per frame: K1 {got['K1'] / N_FRAMES:.2f} "
        f"K3 {got['K3'] / N_FRAMES:.2f} K2 {got['K2'] / N_FRAMES:.2f}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    node_profile(dev, frames, texs, floor)
    path = OUT_DIR / "node_map.npy"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    m.saveMap(str(path))
    loaded = DenseTSDF.loadMap(str(path), device=dev)
    n_act, n_load = m.count_active(), loaded.count_active()
    require(n_act == n_load > 0, f"saveMap/loadMap: {n_act} vs {n_load}")
    log(f"[phase6] saveMap -> loadMap: {n_load} active voxels both")
    return m, loaded, path


def node_profile(dev, frames, texs, bin_floor, n=4):
    """torch.profiler over the first ``n`` frames of the node path: CUDA
    kernels per frame, device busy time against the wall clock, and the
    kernels by device time (the table goes to build/chip_smoke/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        node_run(dev, frames, texs, NODE_MAP, n, bin_floor=bin_floor)
        torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1000.0
    log(f"[phase6] profiled {n} frames: {len(kernels) / n:.0f} CUDA kernels "
        f"per frame, device busy {busy / n:.3f} of {wall / n:.3f} ms per "
        f"frame under the profiler (idle share {1 - busy / wall:.3f})")
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "node_profile.txt").write_text(table)


def node_cpu_phase(dev, frames, texs):
    """Phase 7: the first frames of the node path on the card and on the
    CPU, on the bench-sized map."""
    import torch
    cpu = torch.device("cpu")
    g = node_run(dev, frames, texs, BENCH_MAP, CPU_FRAMES)
    c = node_run(cpu, frames, texs, BENCH_MAP, CPU_FRAMES)
    gm, gmesh, grec, _ = g
    cm, cmesh, crec, _ = c
    require(gmesh.delivery == "quantized", "bench map mesh delivery")
    for key in ("mode", "sweeps", "dirty", "tris", "surface", "slice"):
        require([r[key] for r in grec] == [r[key] for r in crec],
                f"node card vs CPU: {key} {[r[key] for r in grec]} vs "
                f"{[r[key] for r in crec]}")
    gs, cs = gm.state, cm.state
    require(torch.equal(gs.table.cpu(), cs.table), "table")
    require(torch.equal(gs.channels["TSDF_observed"].cpu(),
                        cs.channels["TSDF_observed"]), "TSDF_observed")
    require(torch.equal(gm.esdf_observed.cpu(), cm.esdf_observed),
            "esdf_observed")
    require(torch.equal(gm.esdf_fixed.cpu(), cm.esdf_fixed), "esdf_fixed")
    errs = {}
    for name in ("TSDF", "color"):
        errs[name] = float((gs.channels[name].cpu().float() -
                            cs.channels[name].float()).abs().max())
    obs = cm.esdf_observed
    errs["ESDF"] = float((gm.esdf.cpu() - cm.esdf)[obs].abs().max())
    n = gmesh.num_facelets * 3
    errs["vertices"] = float(np.abs(gmesh.mesh_vertices[:n] -
                                    cmesh.mesh_vertices[:n]).max())
    for k, v in errs.items():
        require(v <= (1e-4 if k == "vertices" else 4e-3),
                f"node card vs CPU: {k} max abs {v}")
    log(f"[phase7] card vs CPU over {CPU_FRAMES} frames: max abs {errs}; "
        f"modes {[r['mode'] for r in crec]} sweeps "
        f"{[r['sweeps'] for r in crec]} triangles "
        f"{[r['tris'] for r in crec]}")


# ---------------------------------------------------------------------------
# phases 8-10: the launch files' submap path
# ---------------------------------------------------------------------------

SUB_FRAMES = 40
KEYFRAME_STEP = 10
# node/core.py:107-150 at the node's defaults: get_general_mapping_opts,
# get_sdf_opts, get_octo_opts; get_submap_opts adds the submap display cap
GENERAL = dict(texture_enabled=True, max_disp_particles=1024 * 1024,
               map_scale=[100, 10], voxel_scale=0.05, max_ray_length=5.1,
               min_ray_length=0.3, disp_ceiling=1.8, disp_floor=-0.3,
               color_same_proj=False)
SDF_OPTS = dict(GENERAL, num_voxel_per_blk_axis=16)
OCTO_OPTS = dict(GENERAL, K=2, min_occupy_thres=2)
EXT = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


def submap_run(dev, frames, texs, n, octo=False, bin_floor=None,
               keyframe_step=None, map_scale=None, mesh=True, **sm_kw):
    """Drive SubmapMapping as node/core.py:152-169 builds it for ``n``
    textured frames, all keyframes: per frame recast_depth_to_map_by_frame,
    generate_mesh(1) on the global map (DenseTSDF) and the global + active
    local export. Returns (mapping, mesher, sent payloads, per-frame
    records with stage ms, drops, and each boundary's fusion)."""
    import torch
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
    from taichislam_tpu_torch.models.octomap import Octomap
    from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
    depth, Rs, Ts = frames
    keyframe_step = keyframe_step or KEYFRAME_STEP
    opts = OCTO_OPTS if octo else SDF_OPTS
    if map_scale is not None:
        opts = dict(opts, map_scale=map_scale)
    sm = SubmapMapping(Octomap if octo else DenseTSDF, global_opts=opts,
                       sub_opts=dict(opts, max_disp_particles=100000),
                       keyframe_step=keyframe_step, device=dev, **sm_kw)
    sm.set_color_camera_intrinsic(KCOLOR)
    sm.set_dep_camera_intrinsic(KDEPTH)
    sent = []
    sm.map_send_handle = sent.append
    col, gm = sm.submap_collection, sm.global_map
    mesher = None if octo or not mesh else MarchingCubeMesher(
        gm, 1_000_000, tsdf_surface_thres=0.25)
    if bin_floor is not None:
        hold_bins(col, bin_floor)
    fuses = []

    def timed(fn):
        def run(*a, **kw):
            t = Timer(dev)
            t.mark()
            fn(*a, **kw)
            t.mark()
            fuses.append(dict(ms=t.ms()[0], **getattr(gm, "last_fuse", {})))
        return run
    gm.fuse_submaps = timed(gm.fuse_submaps)
    gm.fuse_submaps_incremental = timed(gm.fuse_submaps_incremental)
    recs = []
    for f in range(n):
        boundary = f > 0 and f % keyframe_step == 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = Timer(dev)
        t.mark()
        sm.recast_depth_to_map_by_frame(f, True, (Rs[f], Ts[f]), EXT,
                                        depth[f], texs[f])
        t.mark()
        if mesher is not None:
            mesher.generate_mesh(1)
        t.mark()
        if octo:
            sm.cvt_occupy_to_voxels(0)
        else:
            sm.cvt_TSDF_surface_to_voxels()
        t.mark()
        rec = dict(ms=t.ms(), boundary=boundary,
                   peak_mib=(torch.cuda.max_memory_allocated() / 2**20
                             if dev.type == "cuda" else 0.0))
        if octo:
            rec.update(drops=0, export=sm.num_export_particles)
        else:
            st = col.last_stats
            drops = {k: int(st[k]) for k in DROP_KEYS if int(st[k])}
            rec.update(drops=sum(drops.values()), dropped=drops,
                       bucket=col._bin_bucket, export=sm.num_TSDF_particles,
                       tris=mesher.num_facelets if mesher else 0)
            if boundary:
                gst = gm.last_stats
                rec["fuse"] = dict(fuses[-1], **{
                    k: int(gst[k]) for k in ("fuse_sources", "fuse_dropped",
                                             "fuse_tiles_dropped")})
        recs.append(rec)
    return sm, mesher, sent, recs


def sorted_global(m):
    """The global map's observed voxels (indices, TSDF, W) sorted by
    index, on the host."""
    idx, tsdf, w, _, _ = m.to_numpy()
    order = np.lexsort(idx.T)
    return idx[order], tsdf[order], w[order]


def stage_log(tag, recs, smi):
    ms = np.array([r["ms"] for r in recs])
    inner = ~np.array([r["boundary"] for r in recs])
    per = ms[inner].mean(0)
    log(f"[{tag}] ms/frame off the boundaries: recast {per[0]:.3f} mesh "
        f"{per[1]:.3f} export {per[2]:.3f} total {per.sum():.3f} ({smi})")
    for f, r in enumerate(recs):
        if r["boundary"]:
            log(f"[{tag}] boundary frame {f}: recast {r['ms'][0]:.3f} ms "
                f"(mesh {r['ms'][1]:.3f}, export {r['ms'][2]:.3f}), fusion "
                f"{r.get('fuse')}, peak device memory {r['peak_mib']:.1f} "
                f"MiB")
    log(f"[{tag}] peak device memory off the boundaries "
        f"{max(r['peak_mib'] for r in recs if not r['boundary']):.1f} MiB")


def submap_phase(dev, smi, frames, texs, launches, results):
    """Phase 8: the launch files' path. A first untimed pass finds the
    largest ray-bin bucket the collection needs; the measured pass holds
    it, then drone B ingests A's payloads, A re-poses by PGO and flushes;
    the same frames again with incremental_fuse and async_finalize must
    give the same global map."""
    import torch
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    sm0, _, _, recs0 = submap_run(dev, frames, texs, SUB_FRAMES)
    floor = max(r["bucket"] for r in recs0)
    log(f"[phase8] sizing pass: drops/frame "
        f"{[r['dropped'] for r in recs0 if r['drops']]}, buckets "
        f"{sorted(set(r['bucket'] for r in recs0))}, collection blocks "
        f"{int(sm0.submap_collection.state.num_blocks)}")
    del sm0
    counters = (k1.segmented_block_reduce, ks.esdf_sweep, ks.esdf_sweep_loop)
    for c in counters:
        c.launches = 0
    k1.segmented_block_reduce.site_launches.clear()
    torch.cuda.synchronize()
    sm, mesher, sent, recs = submap_run(dev, frames, texs, SUB_FRAMES,
                                        bin_floor=floor)
    torch.cuda.synchronize()
    got = dict(zip(("K1", "K2", "K3"), (c.launches for c in counters)))
    sites = dict(k1.segmented_block_reduce.site_launches)
    for k, v in got.items():
        launches[k] += v
    log(f"[phase8] launches during the submap path: {got}, K1 by site "
        f"{sites}")
    require(sites.get("fusion", 0) > 0, "K1 not launched at the fusion site")
    results["K1"]["fusion_launches"] = sites["fusion"]
    require(max(r["drops"] for r in recs) == 0,
            f"submap path: collection drops {[r['dropped'] for r in recs]}")
    fuses = [r["fuse"] for r in recs if r["boundary"]]
    n_bound = (SUB_FRAMES - 1) // KEYFRAME_STEP
    require(len(fuses) == n_bound, f"submap path: {len(fuses)} refuses")
    for fz in fuses:
        require(fz["fuse_dropped"] == 0 and fz["fuse_tiles_dropped"] == 0,
                f"submap path: fusion dropped {fz}")
    require(mesher.num_facelets > 0, "submap path: no triangles")
    require(min(r["export"] for r in recs) > 0, "submap path: empty export")
    col = sm.submap_collection
    log(f"[phase8] collection blocks {int(col.state.num_blocks)}, global "
        f"blocks {int(sm.global_map.state.num_blocks)}, sends {len(sent)}, "
        f"triangles {mesher.num_facelets}, export {recs[-1]['export']}")
    stage_log("phase8", recs, smi)
    full = sorted_global(sm.global_map)

    # drone B ingests A's payloads; A re-poses by PGO and flushes
    b = SubmapMapping(DenseTSDF, global_opts=SDF_OPTS,
                      sub_opts=dict(SDF_OPTS, max_disp_particles=100000),
                      keyframe_step=KEYFRAME_STEP, device=dev)
    t = Timer(dev)
    t.mark()
    for buf in sent:
        b.input_remote_submap(buf)
    t.mark()
    ms_b = t.ms()[0]

    def pgo_refuse():
        """Re-pose every submap by 5 cm and refuse: (ms, cudaMalloc calls
        made inside the refuse)."""
        shift = {fid: (np.asarray(sm.pgo_poses[fid][0]),
                       np.asarray(sm.pgo_poses[fid][1]) + np.float32(0.05))
                 for fid in sm.submaps}
        sm.set_frame_poses(shift)
        n0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
        t = Timer(dev)
        t.mark()
        sm.local_to_global()
        t.mark()
        st = sm.global_map.last_stats
        require(int(st["fuse_dropped"]) == 0 and
                int(st["fuse_tiles_dropped"]) == 0, "PGO refuse dropped")
        return (t.ms()[0],
                torch.cuda.memory_stats().get("num_device_alloc", 0) - n0)

    pgo = [pgo_refuse()]
    t = Timer(dev)
    t.mark()
    sm.flush()
    b.input_remote_submap(sent[-1])
    t.mark()
    ms_f = t.ms()[0]
    # a second reading of the same refuse, after the flush
    pgo.append(pgo_refuse())
    n_b = b.submap_collection.remote_submap_num
    require(n_b == len(sent) == n_bound + 1,
            f"drone B holds {n_b} of {len(sent)}")
    require(b.global_map.count_active() > 0, "drone B: empty global map")
    fz = sm.global_map.last_fuse
    log(f"[phase8] drone B ingested {n_b} submaps in {ms_b:.3f} ms, global "
        f"voxels {b.global_map.count_active()}; PGO refuse "
        f"{pgo[0][0]:.3f} ms ({pgo[0][1]} cudaMalloc calls inside it; bcap "
        f"{fz['bcap']}, lanes {fz['lanes']}), again after the flush "
        f"{pgo[1][0]:.3f} ms ({pgo[1][1]} cudaMalloc calls); flush + ingest "
        f"{ms_f:.3f} ms")
    del b

    sm_a, _, sent_a, recs_a = submap_run(
        dev, frames, texs, SUB_FRAMES, bin_floor=floor,
        incremental_fuse=True, async_finalize=True)
    sm_a.sync()
    inc = sorted_global(sm_a.global_map)
    require(np.array_equal(inc[0], full[0]), "async vs full refuse: keys")
    errs = [float(np.abs(a.astype(np.float32) - b_.astype(np.float32)).max())
            for a, b_ in zip(inc[1:], full[1:])]
    require(max(errs) <= 1e-4, f"async vs full refuse: TSDF/W {errs}")
    require(len(sent_a) == n_bound, f"async sends {len(sent_a)}")
    log(f"[phase8] incremental + async finalize: {len(inc[0])} voxels, "
        f"same keys, TSDF/W max abs {errs}")
    stage_log("phase8 async", recs_a, smi)
    del sm_a
    check_seg_accum_fusion(dev, sm, results)
    submap_profile(dev, frames, texs, floor)


def check_seg_accum_fusion(dev, sm, results):
    """Phase 2 at the fusion shape: K1 on the lanes of a full refuse of
    phase 8's collection (6 values, not presorted, no lane cap) against
    its twin."""
    import torch
    from taichislam_tpu_torch.ops import fusion as fusion_ops
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    col, gm = sm.submap_collection, sm.global_map
    bcap = gm._collection_bcap(col)
    glob_cfg = dataclasses.replace(gm.cfg,
                                   max_touched_blocks=gm._fuse_touched_bucket)
    c = fusion_ops.splat_contributions(col.cfg, glob_cfg, bcap, col.state,
                                       *gm._bases())
    bkey, intra, vals = fusion_ops.reduce_lanes(glob_cfg, c)
    del c
    gspec = glob_cfg.grid
    args = (bkey, intra, vals, gspec.voxels_per_block,
            glob_cfg.max_touched_blocks)
    mb = dict(max_bkey=gspec.num_submaps * gspec.blocks_per_submap)
    got = k1.segmented_block_reduce(*args, site="check", **mb)
    want = k1.segmented_block_reduce_ref(*args, **mb)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "K1 fusion: touched keys")
    require(int(got[2]) == int(want[2]), "K1 fusion: n_touched")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    e = float((got[1] - want[1]).abs().max())
    ms = cuda_ms(lambda: k1.segmented_block_reduce(*args, site="check",
                                                   **mb), 5)
    pms = cuda_ms(lambda: k1.segmented_block_reduce_ref(*args, **mb), 3)
    b_ms, b_by = bound(k1_bytes(bkey, len(vals), args[4], args[3],
                                mb["max_bkey"]))
    label, lib_ms = k1_library("fusion", args[:3], dict(V3=args[3]), dev)
    log(f"[phase2] K1 fusion (a full refuse's lanes): {bkey.numel()} lanes "
        f"(bcap {bcap}), {len(vals)} values, n_touched {int(got[2])} of "
        f"{args[4]}, max_abs_err {e} ms {ms:.4f} plain_ms {pms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by}) library_ms {lib_ms:.4f} [{label}]")
    _, dev_ms = profile_line(
        "K1 fusion (a full refuse's lanes)",
        lambda: k1.segmented_block_reduce(*args, site="check", **mb), ms,
        "k1_", expect=K1_STAGES)
    results["K1"].update(fusion_max_abs_err=e, fusion_ms=ms,
                         fusion_device_ms=dev_ms,
                         fusion_plain_ms=pms, fusion_lanes=bkey.numel(),
                         fusion_bound_ms=b_ms, fusion_library_ms=lib_ms)
    results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], e)


def submap_profile(dev, frames, texs, bin_floor, n=12):
    """torch.profiler over the first ``n`` frames of the submap path (the
    boundary at frame 10 and its full refuse included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        submap_run(dev, frames, texs, n, bin_floor=bin_floor)
        torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1000.0
    log(f"[phase8] profiled {n} frames: {len(kernels) / n:.0f} CUDA kernels "
        f"per frame, device busy {busy / n:.3f} of {wall / n:.3f} ms per "
        f"frame under the profiler (idle share {1 - busy / wall:.3f})")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "submap_profile.txt").write_text(prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=40))


def octo_phase(dev, smi, frames, texs):
    """Phase 9: the octo path, SubmapMapping(Octomap) at the node's
    get_octo_opts; the LOD exports at levels 0 and 1."""
    sm, _, sent, recs = submap_run(dev, frames, texs, SUB_FRAMES, octo=True)
    require(len(sent) == (SUB_FRAMES - 1) // KEYFRAME_STEP,
            f"octo sends {len(sent)}")
    stage_log("phase9", recs, smi)
    for level in (0, 1):
        t = Timer(dev)
        t.mark()
        sm.cvt_occupy_to_voxels(level)
        t.mark()
        n = sm.num_export_particles
        require(n > 0, f"octo export level {level} empty")
        log(f"[phase9] cvt_occupy_to_voxels({level}): {n} particles in "
            f"{t.ms()[0]:.3f} ms ({smi})")
    log(f"[phase9] collection blocks "
        f"{int(sm.submap_collection.state.num_blocks)}, global blocks "
        f"{int(sm.global_map.state.num_blocks)}")


def submap_cpu_phase(dev, frames, texs, n=9):
    """Phase 10: both submap types on a 10 x 10 m map, on the card and
    through the plain path on the CPU."""
    import zlib

    import torch
    from taichislam_tpu_torch.models.submap_mapping import \
        _decode_submap_npz
    cpu = torch.device("cpu")
    for octo in (False, True):
        runs = [submap_run(d, frames, texs, n, octo=octo, keyframe_step=4,
                           map_scale=[10, 10], mesh=False)
                for d in (dev, cpu)]
        (g, _, g_sent, g_recs), (c, _, c_sent, c_recs) = runs
        gs, cs = g.global_map.state, c.global_map.state
        for name in ("table", "block_coords", "num_blocks"):
            require(torch.equal(getattr(gs, name).cpu(), getattr(cs, name)),
                    f"card vs CPU ({'octo' if octo else 'tsdf'}): {name}")
        exact = ("occupy",) if octo else ("TSDF_observed", "occupy")
        for name in exact:
            require(torch.equal(gs.channels[name].cpu(), cs.channels[name]),
                    f"card vs CPU: {name}")
        errs = {name: float((gs.channels[name].cpu().float() -
                             cs.channels[name].float()).abs().max())
                for name in gs.channels if name not in exact}
        require(max(errs.values()) <= 4e-3, f"card vs CPU: {errs}")
        require(len(g_sent) == len(c_sent) == 2, "card vs CPU: sends")
        for a, b in zip(g_sent, c_sent):
            da, db = (_decode_submap_npz(zlib.decompress(x)) for x in (a, b))
            require(da["frame_id"] == db["frame_id"], "sent frame ids")
            if not octo:
                require(np.array_equal(da["indices"], db["indices"]),
                        "sent submap indices")
        require([r["export"] for r in g_recs] == [r["export"] for r in c_recs],
                "card vs CPU: export counts")
        log(f"[phase10] {'octo' if octo else 'tsdf'} card vs CPU over {n} "
            f"frames: tables, flags, occupancy and sent indices exact; max "
            f"abs {errs}; global blocks {int(gs.num_blocks)}")

# ---------------------------------------------------------------------------
# phases 11-12: the topo graph on the node-default map
# ---------------------------------------------------------------------------

# the node's skeleton options (taichislam_tpu/node/core.py:97-104)
TOPO_OPTS = dict(coll_det_num=64, max_raycast_dist=2.5,
                 frontier_combine_angle_threshold=20)


def topo_seed(m):
    """The seed of examples/demo_synthetic.py: the voxel of the z = 0 ESDF
    slice with the largest distance (observed free space)."""
    xyz, esdf = m.get_voxels_ESDF_slice(0.0)
    k = m.num_export_ESDF_particles
    return xyz[:k][np.argmax(esdf[:k])].astype(np.float32), float(
        esdf[:k].max())


def topo_graph(m, seed, max_nodes):
    """A TopoGraphGen at the node's options over map ``m``, grown from
    ``seed``: (graph, wall ms of generate_topo_graph, and of that the ms
    spent in its map calls: uploads, the packed queries and their host
    reads, timed on the host clock around them; one warm-up fan first)."""
    import torch
    from taichislam_tpu_torch.models import topo_graph as tg
    topo = tg.TopoGraphGen(m, **TOPO_OPTS)
    topo.detect_collisions(seed)
    topo.reset()
    spent = [0.0]

    def timed(fn):
        def inner(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t
        return inner
    names = ("_packed_map_raycast", "_packed_map_query",
             "_packed_facelet_checks")
    saved = [getattr(tg, n) for n in names]
    for n, f in zip(names, saved):
        setattr(tg, n, timed(f))
    topo._dev, topo._fetch = timed(topo._dev), timed(topo._fetch)
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        topo.generate_topo_graph(seed, max_nodes=max_nodes)
    finally:
        for n, f in zip(names, saved):
            setattr(tg, n, f)
        del topo._dev, topo._fetch
    return topo, 1000 * (time.perf_counter() - t0), 1000 * spent[0]


def topo_summary(topo):
    return (f"nodes {topo.num_nodes} facelets {topo.num_facelets} frontiers "
            f"{topo.num_frontiers} edges {len(topo.edges)}")


def topo_phase(dev, smi, m):
    """Phase 11: the topo graph on the node-default map of phase 6 (its
    TSDF fused through K1, its ESDF through K3), at the node's skeleton
    options, seeded as the JAX demo seeds it: once with max_nodes 100, once
    until the frontiers run out (the worker's bound)."""
    seed, dist = topo_seed(m)
    log(f"[phase11] seed {np.round(seed, 3).tolist()} (ESDF {dist:.3f} m on "
        f"the z = 0 slice)")
    spec = m.cfg.grid
    lo = np.array(spec.voxel_bounds_lo) * m.voxel_scale - m.voxel_scale
    hi = np.array(spec.voxel_bounds_hi) * m.voxel_scale
    graphs = []
    for max_nodes, label in ((100, "max_nodes 100"),
                             (100000, "until the frontiers run out")):
        topo, wall, map_ms = topo_graph(m, seed, max_nodes)
        v = topo.tri_vertices
        require(topo.num_nodes >= 1 and topo.num_facelets > 10,
                f"topo {label}: {topo_summary(topo)}")
        require(bool(np.isfinite(v).all() and (v >= lo).all() and
                     (v <= hi).all()), f"topo {label}: vertices off the map")
        n = topo.host_syncs
        log(f"[phase11] {label}: {topo_summary(topo)}; generate_topo_graph "
            f"{wall:.3f} ms, {n} map calls of one host sync each, "
            f"{wall / n:.3f} ms of the whole per call; the map calls "
            f"{map_ms:.3f} ms ({map_ms / n:.3f} ms each), host numpy (hull, "
            f"facelet fans, BFS) {wall - map_ms:.3f} ms ({smi})")
        graphs.append(topo)
    n = graphs[1].num_nodes
    log(f"[phase11] " + (f"a graph of {n} nodes (>= 50) was timed above" if
                         n >= 50 else f"the room held {n} nodes (fewer "
                         f"than 50)"))
    return seed


def topo_cpu_phase(dev, loaded, path, seed):
    """Phase 12: the saved node map loaded on the card (phase 6) and on the
    CPU; the same graph on both, exact; then TopoGen in a spawn process
    with a Manager dict, on the card."""
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    cpu_map = DenseTSDF.loadMap(str(path), device="cpu")
    (g, g_ms, _), (c, c_ms, _) = (topo_graph(m, seed, 100)
                                  for m in (loaded, cpu_map))
    for key in ("num_nodes", "num_frontiers", "search_frontiers_idx"):
        require(getattr(g, key) == getattr(c, key),
                f"topo card vs CPU: {key} {getattr(g, key)} vs "
                f"{getattr(c, key)}")
    require(sorted(g.connected) == sorted(c.connected) and
            len(g.edges) == len(c.edges), "topo card vs CPU: edges")
    require(np.array_equal(g.fl_poly, c.fl_poly) and
            np.array_equal(g.fl_frontier, c.fl_frontier),
            "topo card vs CPU: facelet owners and frontier flags")
    err = max(float(np.abs(getattr(g, k) - getattr(c, k)).max(initial=0.0))
              for k in ("fl_v0", "fl_e1", "fl_e2", "fl_normal", "fl_center"))
    require(err <= 1e-5, f"topo card vs CPU: facelets max abs {err}")
    log(f"[phase12] topo card vs CPU, max_nodes 100: {topo_summary(g)} on "
        f"both, facelets max abs {err}; {g_ms:.3f} ms on the card, "
        f"{c_ms:.3f} ms on the CPU")
    del cpu_map
    topo_worker_phase(path, seed, dev)


def topo_worker_phase(path, seed, dev, timeout_s=300):
    """TopoGen in its own process (spawn: CUDA cannot start in a forked
    child) with a Manager dict, on ``dev``: the map in, the edge lines
    back. The worker and the manager are stopped before this returns."""
    import multiprocessing as mp
    from taichislam_tpu_torch.node.topo_worker import TopoGenThread
    obj = np.load(str(path), allow_pickle=True).item()
    ctx = mp.get_context("spawn")
    params = {"sdf_params": SDF_OPTS, "skeleton_graph_gen_opts": TOPO_OPTS,
              "device": str(dev)}
    with ctx.Manager() as manager:
        man_d = manager.dict(exit=False, update=True,
                             start_pt=seed.tolist(),
                             map_data={k: obj[k] for k in (
                                 "indices", "TSDF", "W_TSDF", "occupy",
                                 "color")})
        proc = ctx.Process(target=TopoGenThread, args=(params, man_d))
        t0 = time.perf_counter()
        proc.start()
        try:
            while ("topo_graph_viz" not in man_d and proc.is_alive() and
                   time.perf_counter() - t0 < timeout_s):
                time.sleep(0.2)
            viz = man_d.get("topo_graph_viz")
            wall = time.perf_counter() - t0
        finally:
            man_d["exit"] = True
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    require(viz is not None and len(viz["lines"]) > 0,
            f"TopoGen worker: no edge lines (exit code {proc.exitcode})")
    log(f"[phase12] TopoGen in a spawn process on {dev}: "
        f"{len(viz['lines']) // 2} edges back in {wall:.1f} s (process "
        f"start, map load and the whole graph)")


# ---------------------------------------------------------------------------
# phase 13: a V = 24 map, end to end
# ---------------------------------------------------------------------------

# the bench-sized node map with 24-voxel blocks and the block-mode ESDF only
# (K3's device-memory build); 1024 blocks hold the 4 frames
V24_MAP = dict(BENCH_MAP, num_voxel_per_blk_axis=24, esdf_dense_max_voxels=0,
               max_blocks=1024)


def v24_run(d, frames, texs, n=CPU_FRAMES):
    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    depth, Rs, Ts = frames
    m = DenseESDF(**V24_MAP, device=d)
    m.set_dep_camera_intrinsic(KDEPTH)
    m.set_color_camera_intrinsic(KCOLOR)
    recs = []
    for f in range(n):
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f], texs[f])
        recs.append((m._esdf_last_mode, m.last_esdf_sweeps))
    return m, recs


def v24_phase(dev, frames, texs, launches):
    """Phase 13: DenseESDF at V = 24 on the bench-sized map, 4 frames on
    the card (under torch.profiler, which must record the V > 20 K3 build)
    and on the CPU: the phase-7 gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    counters = (k1.segmented_block_reduce, ks.esdf_sweep, ks.esdf_sweep_loop)
    for t in range(PROFILE_TRIES):
        # the same run again when the profiler missed every device event
        time.sleep(0.2 * t)
        for c in counters:
            c.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            g, grec = v24_run(dev, frames, texs)
            torch.cuda.synchronize()
        got = dict(zip(("K1", "K2", "K3"), (c.launches for c in counters)))
        cuda = [(a.key, a.count) for a in prof.key_averages()
                if a.device_type == torch.autograd.DeviceType.CUDA]
        if cuda:
            break
    for k, v in got.items():
        launches[k] += v
    k3 = [(key, n) for key, n in cuda if "k3_loop_kernel<-1>" in key]
    require(got["K1"] > 0 and got["K3"] > 0 and k3,
            f"V = 24: launches {got}, profiler {k3}")
    kname = k3[0][0].replace("void ", "").replace("(anonymous namespace)::",
                                                  "").split("(")[0]
    c, crec = v24_run(torch.device("cpu"), frames, texs)
    require(grec == crec, f"V = 24 card vs CPU: modes/sweeps {grec} vs {crec}")
    require(all(mode == "block" for mode, _ in grec), f"V = 24 modes {grec}")
    gs, cs = g.state, c.state
    require(torch.equal(gs.table.cpu(), cs.table), "V = 24 table")
    for name in ("TSDF_observed",):
        require(torch.equal(gs.channels[name].cpu(), cs.channels[name]), name)
    require(torch.equal(g.esdf_observed.cpu(), c.esdf_observed) and
            torch.equal(g.esdf_fixed.cpu(), c.esdf_fixed),
            "V = 24 ESDF flags")
    errs = {name: float((gs.channels[name].cpu().float() -
                         cs.channels[name].float()).abs().max())
            for name in ("TSDF", "color")}
    obs = c.esdf_observed
    errs["ESDF"] = float((g.esdf.cpu() - c.esdf)[obs].abs().max())
    require(max(errs.values()) <= 4e-3, f"V = 24 card vs CPU: {errs}")
    log(f"[phase13] V = 24 DenseESDF, {CPU_FRAMES} frames: modes/sweeps "
        f"{grec}, {int(gs.num_blocks)} blocks, {int(obs.sum())} ESDF voxels; "
        f"launches {got}, profiler {k3[0][1]}x {kname}; "
        f"card vs CPU: table and flags exact, max abs {errs}")


# ---------------------------------------------------------------------------
# phase 14: the optimizer
# ---------------------------------------------------------------------------

def linear_fit(d):
    """tests/test_opti.py's linear fit: (a, b) of y = 2x + 1 over 50 x."""
    import torch
    from taichislam_tpu_torch.opti.nnls import NNLS, CostFunction
    xs = np.random.default_rng(5).normal(size=(50,)).astype(np.float32)
    x, y = (torch.as_tensor(a).to(d) for a in (xs, 2.0 * xs + 1.0))
    nnls = NNLS(device=d)
    nnls.add_parameter_block("ab", np.zeros(2, np.float32))
    nnls.add_cost_function(CostFunction(lambda ab: ab[0] * x + ab[1] - y,
                                        ["ab"]))
    return nnls


def rotation_ba(d):
    """tests/test_opti.py's rotation BA: a camera rotation from 30
    reprojected points."""
    import torch
    from taichislam_tpu_torch.opti import transformations as tf
    from taichislam_tpu_torch.opti.nnls import NNLS, CostFunction
    rng = np.random.default_rng(6)
    pts = torch.as_tensor(rng.uniform(-1, 1, size=(30, 3)).astype(
        np.float32) + np.array([0, 0, 4], np.float32)).to(d)
    q_true = np.array([0.05, -0.03, 0.02, 1.0], np.float32)
    q_true /= np.linalg.norm(q_true)

    def project(q):
        p = tf.quaternion_rotate(q.expand(pts.shape[0], 4), pts)
        return p[:, :2] / p[:, 2:3]
    uv = project(torch.as_tensor(q_true).to(d))
    nnls = NNLS(device=d)
    nnls.add_parameter_block("q", np.array([0, 0, 0, 1], np.float32))
    nnls.add_cost_function(CostFunction(
        lambda q: project(q / torch.linalg.norm(q)) - uv, ["q"]))
    return nnls


def opti_phase(dev, smi, iters=300):
    """Phase 14: the bundle-adjustment demo's manifold gradient descent on
    the card, to the JAX demo's convergence test (final loss under 5 % of
    the initial), and on the CPU; NNLS.solve_lm on the two problems of
    tests/test_opti.py on both devices, within 1e-4."""
    import torch
    from taichislam_tpu_torch.opti import ba_demo
    cpu = torch.device("cpu")
    runs = []
    for d in (dev, cpu):
        qs, ts, pts, obs = ba_demo.make_scene(device=d)
        q0, t0 = ba_demo.initial_guess(qs, ts, device=d)
        P = torch.as_tensor(pts).to(d)
        loss0 = float(ba_demo.reprojection_loss(q0, t0, P, obs))
        t = time.perf_counter()
        _, _, losses = ba_demo.gradient_descent(q0, t0, P, obs, iters=iters)
        runs.append((loss0, losses[-1],
                     1000 * (time.perf_counter() - t) / iters))
    (g0, gf, g_ms), (c0, cf, c_ms) = runs
    require(gf < 0.05 * g0, f"BA on the card: loss {g0} -> {gf}")
    rel = abs(gf - cf) / cf
    require(rel <= 1e-3, f"BA card vs CPU: final loss {gf} vs {cf}")
    log(f"[phase14] BA demo, {iters} manifold GD steps: loss {g0:.6f} -> "
        f"{gf:.6f} on the card ({gf / g0:.4f} of the start, the JAX demo "
        f"asks < 0.05), {cf:.6f} on the CPU (rel {rel:.2e}); "
        f"{g_ms:.3f} ms/step on the card, {c_ms:.3f} on the CPU ({smi})")
    for name, build, iters_lm in (("linear fit", linear_fit, 10),
                                  ("rotation BA", rotation_ba, 25)):
        outs = [build(d).solve_lm(iters=iters_lm) for d in (dev, cpu)]
        err = max(float(np.abs(outs[0][k] - outs[1][k]).max())
                  for k in outs[0])
        require(err <= 1e-4, f"NNLS {name}: card vs CPU max abs {err}")
        log(f"[phase14] NNLS.solve_lm {name}: card "
            f"{np.round(next(iter(outs[0].values())), 6).tolist()}, card vs "
            f"CPU max abs {err}")


# ---------------------------------------------------------------------------
# phases 15-18: the node, the entry points and the sequences
# ---------------------------------------------------------------------------

# taichislam_tpu/node/core.py:70-143 at its defaults (textured, the D435
# cameras, 100 x 10 m at 5 cm, V = 16, max ray 5.1 m, the mesher), with the
# ESDF type, the published map and its z = 0 slice, and no multi-drone comm
NODE_CORE_PARAMS = {"~mapping_type": "esdf", "~output_map": True,
                    "~esdf/publish_slice_z": 0.0, "~enable_multi": False}
# launch/taichislam-d435.launch:7-19 (its args) and :42-60 (its rosparams)
LAUNCH_PARAMS = {
    "~enable_submap": True, "~mapping_type": "tsdf",
    "~texture_enabled": False, "~enable_mesher": False,
    "~output_map": False, "~max_ray_length": 3.1, "~min_ray_length": 0.3,
    "~disp/max_disp_particles": 10485760, "~disp/max_mesh": 3000000,
    "~disp_ceiling": 1.8, "~disp_floor": -0.5, "~texture_compressed": True,
    "~voxel_scale": 0.1, "~color_same_proj": True,
    "Kdepth/fx": 384.2377014160156, "Kdepth/fy": 384.2377014160156,
    "Kdepth/cx": 323.4873046875, "Kdepth/cy": 235.0628204345703,
    "Kcolor/fx": 604.7939453125, "Kcolor/fy": 604.9515991210938,
    "Kcolor/cx": 321.3017578125, "Kcolor/cy": 242.9977264404297,
    "~keyframe_step": 10}
ROOT = Path(__file__).resolve().parent


def pose_msg(R, T):
    """A geometry_msgs/Pose-shaped message of (R, T)."""
    from types import SimpleNamespace
    from taichislam_tpu_torch.opti.transformations import \
        quaternion_from_matrix
    q = quaternion_from_matrix(R)
    return SimpleNamespace(
        position=SimpleNamespace(x=float(T[0]), y=float(T[1]),
                                 z=float(T[2])),
        orientation=SimpleNamespace(x=float(q[0]), y=float(q[1]),
                                    z=float(q[2]), w=float(q[3])))


def node_messages(frames, f):
    """Frame ``f`` of the orbit as the node receives it
    (tests/test_node_core.py:16-36): a VIOFrame-shaped frame with the pose
    and an identity extrinsic, and the uint16 millimetre depth as bytes."""
    from types import SimpleNamespace
    depth, Rs, Ts = frames
    frame = SimpleNamespace(
        frame_id=f, is_keyframe=True,
        odom=SimpleNamespace(pose=SimpleNamespace(pose=pose_msg(Rs[f],
                                                                Ts[f]))),
        extrinsics=[pose_msg(np.eye(3), np.zeros(3))])
    d = np.ascontiguousarray(depth[f], np.uint16)
    return frame, SimpleNamespace(width=d.shape[1], height=d.shape[0],
                                  data=d.tobytes())


def make_node(dev, params, keep=False, **kw):
    """TaichiSLAMNodeCore over ``params`` on ``dev``, publishing into a
    list: (has_rgb, points, xyz, colors) per cloud (the arrays with
    ``keep``)."""
    from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore
    pub = []

    def publish(xyz, col, has_rgb):
        pub.append((has_rgb, len(xyz)) + ((np.array(xyz), np.array(col))
                                          if keep else ()))
    core = TaichiSLAMNodeCore(
        get_param=lambda name, default=None: params.get(name, default),
        publish_pointcloud=publish, device=dev, **kw)
    return core, pub


def node_bin_floor(dev, core, frames, texs, n, opts):
    """The largest ray-bin bucket a DenseTSDF at the node's options
    ``opts`` follows to over ``n`` frames (the bins depend on the frames
    only), so that the node's map can hold it and drop nothing."""
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    depth, Rs, Ts = frames
    m = DenseTSDF(**opts, device=dev)
    m.set_dep_camera_intrinsic(core.Kdep)
    m.set_color_camera_intrinsic(core.Kcolor)
    floor = m._bin_bucket
    for f in range(n):
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f],
                              texs[f] if texs is not None else None)
        floor = max(floor, m._bin_bucket)
    return floor


def reset_counts():
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    counters = (k1.segmented_block_reduce, ks.esdf_sweep, ks.esdf_sweep_loop)
    for c in counters:
        c.launches = 0
    k1.segmented_block_reduce.site_launches.clear()
    return counters


def read_counts(counters, launches):
    got = dict(zip(("K1", "K2", "K3"), (c.launches for c in counters)))
    for k, v in got.items():
        launches[k] += v
    return got, dict(counters[0].site_launches)


def node_core_phase(dev, smi, frames, texs, launches):
    """Phase 15: TaichiSLAMNodeCore at the node's defaults with the ESDF
    type and a headless render, 16 orbit frames as fake messages through
    the main loop's process_taichi (recast, generate_mesh(1) into the
    render, the published ESDF slice) and rendering() (the surface export
    to the viewer); then 4 frames on a 10 x 10 m map without a render (the
    surface and the slice published), a core on the card against a core on
    the CPU. The render is the browser viewer's InteractiveRender, a
    TaichiSLAMRender whose rendering() packs the scene for a localhost page
    and needs no matplotlib."""
    import torch
    from taichislam_tpu_torch.utils.viewer_server import InteractiveRender
    render = InteractiveRender(port=0, announce=False)
    core, pub = make_node(dev, NODE_CORE_PARAMS, render=render)
    m = core.mapping
    floor = node_bin_floor(dev, core, frames, texs, N_FRAMES,
                           core.get_sdf_opts())
    hold_bins(m, floor)
    counters = reset_counts()
    torch.cuda.synchronize()
    recs = []
    for f in range(N_FRAMES):
        frame, msg = node_messages(frames, f)
        core.stage_depth(frame, msg, texs[f])
        n_pub = len(pub)
        t0 = time.perf_counter()
        core.process_taichi()
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        core.rendering()
        st = m.last_stats
        drops = {k: int(st[k]) for k in DROP_KEYS if int(st[k])}
        recs.append(dict(ms=ms, drops=drops, mode=m._esdf_last_mode,
                         published=[p[:2] for p in pub[n_pub:]],
                         surface=len(render.par),
                         tris=core.mesher.num_facelets))
    torch.cuda.synchronize()
    got, _ = read_counts(counters, launches)
    scene_mib = len(render.server.store.snapshot()[1]) / 2**20
    render.close()
    log(f"[phase15] launches during the node's {N_FRAMES} frames: {got}")
    require(got["K1"] > 0 and got["K3"] > 0,
            f"node core: K1 or K3 not launched ({got})")
    require(all(not r["drops"] for r in recs),
            f"node core: capacity drops {[r['drops'] for r in recs]}")
    # with a render and the mesher, output() meshes and publishes the ESDF
    # slice; the surface goes to the viewer in the loop's rendering() tick
    require(all(r["published"] and all(n > 0 and rgb for rgb, n in
                                       r["published"]) for r in recs),
            "node core: a frame published no ESDF slice")
    require(min(r["surface"] for r in recs) > 0, "node core: empty surface")
    require(recs[-1]["tris"] > 0, "node core: no triangles")
    log(f"[phase15] per frame: ESDF mode {[r['mode'] for r in recs]}, "
        f"slice points {[r['published'][0][1] for r in recs]}, surface "
        f"points {[r['surface'] for r in recs]}, triangles "
        f"{[r['tris'] for r in recs]}; bin bucket held at {floor}; the "
        f"viewer's last scene {scene_mib:.1f} MiB")
    ms = np.array([r["ms"] for r in recs])
    block = ms[[r["mode"] == "block" for r in recs]]
    log(f"[phase15] process_taichi wall ms per frame (closed by "
        f"torch.cuda.synchronize) {np.round(ms, 3).tolist()}; mean "
        f"{ms.mean():.3f}, block-mode frames "
        f"{f'{block.mean():.3f}' if len(block) else 'none'} ({smi})")
    del core, m, render

    # card against CPU on a 10 x 10 m map, the surface and slice published
    params = dict(NODE_CORE_PARAMS, **{"~map_size_xy": 10,
                                       "~map_size_z": 10})
    runs = []
    for d in (dev, torch.device("cpu")):
        c, p = make_node(d, params, keep=True)
        for f in range(CPU_FRAMES):
            frame, msg = node_messages(frames, f)
            c.stage_depth(frame, msg, texs[f])
            c.process_taichi()
        runs.append(p)
        del c
    g, c = runs
    require(len(g) == len(c) == 2 * CPU_FRAMES,
            f"node card vs CPU: {len(g)} vs {len(c)} clouds")
    err = 0.0
    for a, b in zip(g, c):
        require(a[:2] == b[:2], f"node card vs CPU: counts {a[:2]} {b[:2]}")
        require(np.array_equal(a[2], b[2]), "node card vs CPU: xyz")
        err = max(err, float(np.abs(a[3] - b[3]).max(initial=0.0)))
    require(err <= 4e-3, f"node card vs CPU: colors max abs {err}")
    log(f"[phase15] card vs CPU, {CPU_FRAMES} frames on a 10 x 10 m map: "
        f"published counts {[a[1] for a in g]} exact, xyz exact, colors "
        f"max abs {err}")


def launch_node_phase(dev, smi, frames, launches):
    """Phase 16: two cores with the launch file's parameters (drones 0 and
    1) on the port's LoopbackTransport hub; 40 orbit frames on drone 0,
    drone 1 handles its comm after each boundary; then PGO poses on drone
    0 and its refuse."""
    import torch
    from types import SimpleNamespace
    from taichislam_tpu_torch import runtime
    from taichislam_tpu_torch.utils.comm import (LoopbackTransport,
                                                 SLAMComm,
                                                 make_udpm_transport)
    hub = LoopbackTransport.Hub()
    a, _ = make_node(dev, dict(LAUNCH_PARAMS, **{"~drone_id": 0}),
                     comm=SLAMComm(0, transport=LoopbackTransport(hub)))
    b, _ = make_node(dev, dict(LAUNCH_PARAMS, **{"~drone_id": 1}),
                     comm=SLAMComm(1, transport=LoopbackTransport(hub)))
    sm = a.mapping
    col = sm.submap_collection
    floor = node_bin_floor(dev, a, frames, None, SUB_FRAMES,
                           a.get_submap_opts())
    hold_bins(col, floor)
    counters = reset_counts()
    torch.cuda.synchronize()
    recs = []
    for f in range(SUB_FRAMES):
        frame, msg = node_messages(frames, f)
        a.stage_depth(frame, msg)
        t0 = time.perf_counter()
        a.process_taichi()
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        boundary = f > 0 and f % KEYFRAME_STEP == 0
        if boundary:
            b.handle_comm()
        st = col.last_stats
        recs.append(dict(ms=ms, boundary=boundary,
                         drops={k: int(st[k]) for k in DROP_KEYS
                                if int(st[k])},
                         remote=b.mapping.submap_collection.remote_submap_num))
    # PGO: drone 0's trajectory moves every submap's base by 5 cm
    fids = sorted(sm.submaps)
    want = np.asarray(sm.pgo_poses[fids[0]][1], np.float64) + 0.05
    traj = SimpleNamespace(drone_id=0, frame_ids=fids, poses=[
        pose_msg(sm.pgo_poses[i][0], np.asarray(sm.pgo_poses[i][1]) + 0.05)
        for i in fids])
    a.traj_callback(traj)
    moved = sm.global_map.submaps_base_T_np[sm.submaps[fids[0]]].copy()
    t0 = time.perf_counter()
    sm.local_to_global()
    torch.cuda.synchronize()
    pgo_ms = 1000 * (time.perf_counter() - t0)
    gst = sm.global_map.last_stats
    b.handle_comm()
    torch.cuda.synchronize()
    got, sites = read_counts(counters, launches)
    n_b = b.mapping.submap_collection.remote_submap_num
    log(f"[phase16] launches during the two drones' run: {got}, K1 by site "
        f"{sites}")
    require(sites.get("fusion", 0) > 0, "launch node: K1 not at fusion")
    require(all(not r["drops"] for r in recs),
            f"launch node: drops {[r['drops'] for r in recs]}")
    require(int(gst["fuse_dropped"]) == 0 and
            int(gst["fuse_tiles_dropped"]) == 0, "launch node: PGO dropped")
    require(np.allclose(moved, want, atol=1e-5),
            f"launch node: PGO re-pose {moved} for {want}")
    require(n_b == (SUB_FRAMES - 1) // KEYFRAME_STEP and
            b.mapping.global_map.count_active() > 0,
            f"launch node: drone 1 holds {n_b} submaps")
    ms = np.array([r["ms"] for r in recs])
    inner = ~np.array([r["boundary"] for r in recs])
    log(f"[phase16] drone 0: process_taichi off the boundaries "
        f"{ms[inner].mean():.3f} ms/frame, boundary frames "
        + ", ".join(f"{f}: {r['ms']:.3f} ms" for f, r in enumerate(recs)
                    if r["boundary"])
        + f"; PGO re-pose of {len(fids)} submaps and refuse "
        f"{pgo_ms:.3f} ms ({smi})")
    log(f"[phase16] drone 1 received {n_b} submaps (after each boundary "
        f"{[r['remote'] for r in recs if r['boundary']]}), global voxels "
        f"{b.mapping.global_map.count_active()}; drone 0 global voxels "
        f"{sm.global_map.count_active()}")
    native = runtime.native_available()
    try:
        tr = make_udpm_transport("udpm://224.0.0.251:7667?ttl=0")
        chosen = type(tr).__name__
        tr.close()
    except OSError as e:
        chosen = f"none: the socket did not bind ({e})"
    log(f"[phase16] make_udpm_transport would choose {chosen} (native "
        f"transport built: {native}); this phase used LoopbackTransport")


def run_tool(args, timeout_s, want=None):
    """``python -m <args>`` from the checkout's root; returns (stdout lines,
    wall s). Fails unless it exits 0 (and prints ``want``)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    require(res.returncode == 0 and (want is None or want in res.stdout),
            f"{args[0]}: exit {res.returncode}, {lines[-5:]}, "
            f"{res.stderr[-2000:]}")
    return lines, wall


def entry_points_phase(smi, timeout_s=300):
    """Phase 17: the port's entry points as a user runs them, each in its
    own process on the card. The offline demo serves its render through the
    browser viewer on a free localhost port: its matplotlib frame needs a
    package this host may not have."""
    runs = [("demo_synthetic", ["taichislam_tpu_torch.examples.demo_synthetic",
                                "--frames", "8", "--topo", "--two-drones"],
             "[demo] OK"),
            ("demo", ["taichislam_tpu_torch.demo", "-m", "tsdf", "--viewer",
                      "--viewer-port", "0"], "demo done"),
            ("gen_topo_graph", ["taichislam_tpu_torch.examples.gen_topo_graph",
                                "--benchmark", "--run_num", "5"],
             "avg gen convex cost time")]
    for name, args, want in runs:
        lines, wall = run_tool(args, timeout_s, want)
        log(f"[phase17] python -m {' '.join(args)}: exit 0 in {wall:.1f} s "
            f"wall ({smi}); last lines {lines[-3:]}")


def hold_seq_bins(m, floor):
    """Hold the ray-bin bucket a window verdict leaves at or above
    ``floor`` (hold_bins for the sequence path)."""
    verdict = m._sequence_verdict

    def held(stats):
        redo = verdict(stats)
        m._bin_bucket = max(m._bin_bucket, floor)
        return redo
    m._sequence_verdict = held
    m._bin_bucket = floor


def sequence_phase(dev, frames, texs, n=6, n_sub=9):
    """Phase 18: recast_depth_sequence on the bench-sized map against the
    port's own per-frame loop under the JAX semantics (the ESDF window's
    budget is min(max_esdf_sweeps, 6)), with the same bin bucket and ESDF
    block cap on both sides; and the sequences' graph path against the
    same windows through their eager *_ref loop, bit for bit."""
    import torch
    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
    depth, Rs, Ts = frames
    tsdf_kw = {k: v for k, v in BENCH_MAP.items()
               if not k.startswith(("esdf", "max_e"))}
    probe = DenseTSDF(**tsdf_kw, device=dev)
    probe.set_dep_camera_intrinsic(KDEPTH)
    probe.set_color_camera_intrinsic(KCOLOR)
    floor = probe._bin_bucket
    for f in range(n_sub):
        probe.recast_depth_to_map(Rs[f], Ts[f], depth[f], texs[f])
        floor = max(floor, probe._bin_bucket)
    del probe

    def build(cls, **kw):
        m = cls(**kw, device=dev)
        m.set_dep_camera_intrinsic(KDEPTH)
        m.set_color_camera_intrinsic(KCOLOR)
        hold_bins(m, floor)
        hold_seq_bins(m, floor)
        if cls is DenseESDF:
            m._esdf_cap_bucket = 1024
        return m

    def compare(name, a, b, esdf=False):
        for key in ("table", "block_coords", "num_blocks"):
            require(torch.equal(getattr(a.state, key),
                                getattr(b.state, key)), f"{name}: {key}")
        for key in ("TSDF_observed", "occupy"):
            require(torch.equal(a.state.channels[key],
                                b.state.channels[key]), f"{name}: {key}")
        errs = {k: float((a.state.channels[k].float() -
                          b.state.channels[k].float()).abs().max())
                for k in ("TSDF", "W_TSDF", "color")}
        if esdf:
            require(torch.equal(a.esdf_observed, b.esdf_observed) and
                    torch.equal(a.esdf_fixed, b.esdf_fixed),
                    f"{name}: ESDF flags")
            errs["ESDF"] = float((a.esdf - b.esdf)[a.esdf_observed].abs()
                                 .max())
        require(max(errs["TSDF"], errs["W_TSDF"], errs.get("ESDF", 0.0))
                <= 1e-5 and errs["color"] <= 4e-3, f"{name}: {errs}")
        return errs

    out = []
    seq = build(DenseTSDF, **tsdf_kw)
    seq.recast_depth_sequence(Rs[:n], Ts[:n], depth[:n], texs[:n])
    eag = build(DenseTSDF, **tsdf_kw)
    with eager_sequences():
        eag.recast_depth_sequence(Rs[:n], Ts[:n], depth[:n], texs[:n])
    maps_bit_equal(seq, eag, "DenseTSDF graph vs eager")
    del eag
    ref = build(DenseTSDF, **tsdf_kw)
    for f in range(n):
        ref.recast_depth_to_map(Rs[f], Ts[f], depth[f], texs[f])
    require(int(seq.last_stats["max_dropped"]) == 0, "sequence dropped")
    out.append(("DenseTSDF", compare("DenseTSDF sequence", seq, ref)))
    del seq, ref
    esdf_kw = dict(BENCH_MAP, esdf_dense_max_voxels=0)
    for sweeps in (6, 32):
        seq = build(DenseESDF, **dict(esdf_kw, max_esdf_sweeps=sweeps))
        seq.recast_depth_sequence(Rs[:n], Ts[:n], depth[:n], texs[:n])
        eag = build(DenseESDF, **dict(esdf_kw, max_esdf_sweeps=sweeps))
        with eager_sequences():
            eag.recast_depth_sequence(Rs[:n], Ts[:n], depth[:n], texs[:n])
        maps_bit_equal(seq, eag, f"DenseESDF {sweeps} graph vs eager")
        del eag
        ref = build(DenseESDF, **dict(esdf_kw, max_esdf_sweeps=6))
        for f in range(n):
            ref.recast_depth_to_map(Rs[f], Ts[f], depth[f], texs[f])
        out.append((f"DenseESDF {sweeps} sweeps", compare(
            f"DenseESDF {sweeps} sweeps", seq, ref, esdf=True)))
        del seq, ref

    def build_sm():
        sm = SubmapMapping(DenseTSDF, keyframe_step=4, device=dev,
                           sub_opts=dict(tsdf_kw, max_disp_particles=100000),
                           global_opts=tsdf_kw)
        sm.set_dep_camera_intrinsic(KDEPTH)
        sm.set_color_camera_intrinsic(KCOLOR)
        hold_bins(sm.submap_collection, floor)
        hold_seq_bins(sm.submap_collection, floor)
        return sm
    calls = [(f, True, (Rs[f], Ts[f]), EXT, depth[f], texs[f])
             for f in range(n_sub)]
    seq, ref, eag = build_sm(), build_sm(), build_sm()
    seq.recast_depth_sequence(calls)
    with eager_sequences():
        eag.recast_depth_sequence(calls)
    maps_bit_equal(seq.submap_collection, eag.submap_collection,
                   "SubmapMapping collection graph vs eager")
    maps_bit_equal(seq.global_map, eag.global_map,
                   "SubmapMapping global graph vs eager")
    del eag
    for c in calls:
        ref.recast_depth_to_map_by_frame(*c)
    require(seq.submaps == ref.submaps and
            seq.frame_count == ref.frame_count, "SubmapMapping lifecycle")
    out.append(("SubmapMapping collection", compare(
        "SubmapMapping collection", seq.submap_collection,
        ref.submap_collection)))
    out.append(("SubmapMapping global", compare(
        "SubmapMapping global", seq.global_map, ref.global_map)))
    log(f"[phase18] sequences on the card against the per-frame loop "
        f"({n} frames; SubmapMapping {n_sub} frames, keyframe_step 4, "
        f"submaps {sorted(seq.submaps)}): tables and flags exact; max abs "
        + "; ".join(f"{k} {v}" for k, v in out) + "; the graph path equal "
        "to the eager *_ref loop on the same windows bit for bit (DenseTSDF, "
        "DenseESDF at 6 and 32 sweeps, SubmapMapping collection and global)")


# ---------------------------------------------------------------------------
# phase 21: config 3 of the JAX package's benchmark, full size
# ---------------------------------------------------------------------------

# tools/bench_configs.py:119-121 (the map) and :245-276 (config 3: the
# per-call deferred path and the windowed one)
C3_MAP = dict(map_scale=[10.0, 10.0], voxel_scale=0.05, max_ray_length=5.1,
              min_ray_length=0.3, max_blocks=4096, num_voxel_per_blk_axis=16,
              max_bins=32768, max_submap_num=8, max_esdf_sweeps=8,
              esdf_raise_slack_voxels=0.5)
C3_FRAMES = 40
C3_WINDOW = 20
C3_INTERVAL = 8
C3_CPU_FRAMES = 8


@contextlib.contextmanager
def eager_sequences():
    """Run the sequences through their eager ``*_ref`` loop instead of the
    graph path (the models call the module's functions by name)."""
    from taichislam_tpu_torch.ops import sequence as seq
    saved = seq.integrate_depth_sequence, seq.integrate_esdf_sequence
    seq.integrate_depth_sequence = seq.integrate_depth_sequence_ref
    seq.integrate_esdf_sequence = seq.integrate_esdf_sequence_ref
    try:
        yield
    finally:
        seq.integrate_depth_sequence, seq.integrate_esdf_sequence = saved


def c3_model(dev, K, interval):
    """Config 3's DenseESDF as tools/bench_configs.py builds it: the
    per-call row (check interval 8, capacity interval 8) or, at interval
    1, the windowed row's model."""
    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    m = DenseESDF(**C3_MAP, esdf_check_interval=interval, device=dev)
    m.cfg = dataclasses.replace(m.cfg, esdf_converge_eps=2e-3)
    if interval > 1:
        m.capacity_check_interval = C3_INTERVAL
    m.set_dep_camera_intrinsic(K)
    return m


def record_verdicts(m, out):
    """Record each deferred verdict's accumulated maxima [bins_total,
    dropped, live_lanes, esdf_overflow] with the bin and ESDF-cap buckets
    they were taken under."""
    verdict = m._frame_verdict

    def recorded():
        out.append((m._frame_pack.tolist(), m._bin_bucket,
                    m._esdf_cap_bucket))
        verdict()
    m._frame_verdict = recorded


def bits(t):
    """A float tensor as its bit pattern, for bit-for-bit comparisons."""
    import torch
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float16:
        return t.view(torch.int16)
    return t


def maps_bit_equal(a, b, tag):
    """Two port maps bit for bit: the state and, on a DenseESDF, the ESDF
    arrays and the interval accumulators; the buckets and the last
    stats."""
    import torch

    def same(x, y, what):
        require((x is None) == (y is None) and (
            x is None or torch.equal(bits(x), bits(y))), f"{tag}: {what}")
    for m in (a, b):
        if hasattr(m, "_refresh_esdf_observed"):
            m._refresh_esdf_observed()   # the exports' view of the mask
    for f in a.state._fields:
        if f != "channels":
            same(getattr(a.state, f), getattr(b.state, f), f)
    for k in a.state.channels:
        same(a.state.channels[k], b.state.channels[k], k)
    for n in ("esdf", "esdf_fixed", "esdf_observed", "_esdf_pending",
              "_esdf_seen_tsdf", "_esdf_seen_obs", "_frame_pack",
              "_frame_union"):
        same(getattr(a, n, None), getattr(b, n, None), n)
    require(set(a.last_stats) == set(b.last_stats), f"{tag}: stats keys")
    for k in a.last_stats:
        same(a.last_stats[k], b.last_stats[k], f"stats {k}")
    for n in ("_bin_bucket", "_esdf_cap_bucket", "_esdf_frame",
              "_touched_bucket"):
        require(getattr(a, n, None) == getattr(b, n, None), f"{tag}: {n}")


def c3_pass(m, frames, n, window=None):
    """One pass of ``n`` frames through the per-call path or, with
    ``window``, through recast_depth_sequence; returns (event ms, wall
    ms) per frame."""
    import torch
    depth, Rs, Ts = frames
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    if window is None:
        for f in range(n):
            m.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
    else:
        for f in range(0, n, window):
            m.recast_depth_sequence(Rs[f:f + window], Ts[f:f + window],
                                    depth[f:f + window])
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, 1000 * (time.perf_counter() - t0) / n


def c3_host_copy(m):
    """What the card-vs-CPU comparison reads, on the host."""
    m._refresh_esdf_observed()
    st = m.state
    out = {f: getattr(st, f).cpu() for f in ("table", "block_coords",
                                             "num_blocks")}
    out.update({k: st.channels[k].cpu() for k in st.channels})
    out.update(esdf=m.esdf.cpu(), fixed=m.esdf_fixed.cpu(),
               observed=m.esdf_observed.cpu())
    return out


def drain(m, rounds=200):
    """Run updates with an empty touched set until the wavefront queue is
    empty (tests/test_esdf.py's drain); returns the rounds taken."""
    import torch
    m.last_stats = dict(m.last_stats)
    m.last_stats["touched_blocks"] = torch.zeros(
        (m.cfg.max_blocks + 1,), dtype=torch.bool, device=m.device)
    for r in range(rounds):
        if not bool(m._esdf_pending.any()):
            return r
        m.update_esdf()
    raise AssertionError("ESDF wavefront queue never drained")


def c3_interval_run(dev, frames, K, floor, cap, exact):
    """Config 3 at check interval 8 and at 1 over the same frames, both
    drained; with ``exact`` at tests/test_esdf.py:384's settings (raise
    slack 0, seed eps 0, convergence eps 1e-4). The bin buckets are held at
    the settled ``floor``, so both integrate the same TSDF. Returns (ESDF
    max abs on the common observed voxels, their count, TSDF max abs,
    drain rounds of each)."""
    import torch
    depth, Rs, Ts = frames
    models = []
    for interval in (C3_INTERVAL, 1):
        m = c3_model(dev, K, interval)
        if exact:
            m.cfg = dataclasses.replace(m.cfg, esdf_raise_slack_voxels=0.0,
                                        esdf_seed_eps_voxels=0.0,
                                        esdf_converge_eps=1e-4)
        hold_bins(m, floor)
        if interval > 1:
            hold_frame_bins(m, floor)
            m._esdf_cap_bucket = cap
        for f in range(len(depth)):
            m.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
        models.append((m, drain(m)))
    (m8, r8), (m1, r1) = models
    for m in (m8, m1):
        m._refresh_esdf_observed()
    e_tsdf = float((m8.state.channels["TSDF"] -
                    m1.state.channels["TSDF"]).abs().max())
    require(torch.equal(m8.state.table, m1.state.table),
            "interval 8 vs 1: block tables")
    require(torch.equal(m8.esdf_observed, m1.esdf_observed),
            "interval 8 vs 1: observed voxels")
    obs = m8.esdf_observed
    err = float((m8.esdf - m1.esdf)[obs].abs().max())
    return err, int(obs.sum()), e_tsdf, (r8, r1)


def c3_interval_phase(dev, frames, K, floor, cap):
    """Interval 8 against interval 1, both drained: within 5e-3 at
    tests/test_esdf.py:384's exactness settings (its bound); at config 3's
    own 0.5-voxel raise slack the drained field depends on the path taken,
    and the difference is reported."""
    err, n_obs, e_tsdf, rounds = c3_interval_run(dev, frames, K, floor, cap,
                                                 exact=True)
    require(err < 5e-3, f"interval 8 vs 1 drained ESDF max abs {err}")
    err_c3, _, _, rounds_c3 = c3_interval_run(dev, frames, K, floor, cap,
                                              exact=False)
    log(f"[phase21] interval {C3_INTERVAL} vs 1 over {len(frames[0])} "
        f"frames, drained ({rounds[0]} and {rounds[1]} updates) at "
        f"tests/test_esdf.py:384's settings (slack 0, seed eps 0, eps "
        f"1e-4): {n_obs} observed voxels, ESDF max abs {err} (< 5e-3), TSDF "
        f"max abs {e_tsdf}; at config 3's slack 0.5 / eps 2e-3 ({rounds_c3} "
        f"updates) ESDF max abs {err_c3} (reported, not held: a raise "
        f"inside the slack is not propagated, so the drained field depends "
        f"on the path)")


def c3_cpu_phase(dev, frames, K, snap):
    """The first C3_CPU_FRAMES frames of the per-call path on the CPU
    against the card's snapshot after the same frames."""
    import torch
    cpu = torch.device("cpu")
    depth, Rs, Ts = frames
    m = c3_model(cpu, K, C3_INTERVAL)
    for f in range(C3_CPU_FRAMES):
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f].cpu(), None)
    c = c3_host_copy(m)
    for k in ("table", "block_coords", "num_blocks", "TSDF_observed",
              "fixed", "observed"):
        require(torch.equal(snap[k], c[k]), f"config 3 card vs CPU: {k}")
    errs = {k: float((snap[k].float() - c[k].float()).abs().max())
            for k in ("TSDF", "W_TSDF")}
    errs["ESDF"] = float((snap["esdf"] - c["esdf"])[c["observed"]].abs()
                         .max())
    require(max(errs["TSDF"], errs["ESDF"]) <= 4e-3,
            f"config 3 card vs CPU {errs}")
    log(f"[phase21] card vs CPU over {C3_CPU_FRAMES} per-call frames: "
        f"tables, observed and fixed flags exact; max abs {errs}")


def profile_frames(fn, n, out_name):
    """torch.profiler over ``fn()``, which runs ``n`` frames: CUDA kernels
    per frame, device-busy ms per frame, wall ms per frame under the
    profiler, kernel counts by name and the largest device ms per frame by
    name; the table goes to ``build/chip_smoke/<out_name>``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1000.0
    by_name, dev_ms = {}, {}
    for e in kernels:
        k = kernel_name(e.name).split("<")[0]
        by_name[k] = by_name.get(k, 0) + 1
        dev_ms[k] = dev_ms.get(k, 0.0) + e.device_time_total / 1000.0 / n
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / out_name).write_text(prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=60))
    top = dict(sorted(((k, round(v, 4)) for k, v in dev_ms.items()),
                      key=lambda x: -x[1])[:8])
    return len(kernels) / n, busy / n, wall / n, by_name, top


def c3_profile(m, frames, n):
    """torch.profiler over ``n`` per-call frames of ``m`` (graph
    replays): CUDA kernels per frame, by name, and the idle share."""
    depth, Rs, Ts = frames

    def run():
        for f in range(n):
            m.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
    return profile_frames(run, n, "c3_profile.txt")


def hold_frame_bins(m, floor):
    """Hold the ray-bin bucket a deferred verdict leaves at or above
    ``floor`` (hold_bins for the deferred per-frame path)."""
    verdict = m._frame_verdict

    def held():
        verdict()
        m._bin_bucket = max(m._bin_bucket, floor)
    m._frame_verdict = held
    m._bin_bucket = max(m._bin_bucket, floor)


def c3_phase(dev, smi, launches):
    """Phase 21: config 3 at full size, 640x480 orbit frames staged on the
    card once. The per-call deferred path (interval 8, capacity interval
    8) and the windowed path (W = 20) through the graph path, each against
    the same frames through the eager *_ref loop on the card, bit for bit
    after every frame or window. Pass 1 settles the buckets as the JAX
    package's follow-the-load rule moves them; from pass 2 on the bin
    bucket is held at the largest that pass 1 chose (as phases 6, 8 and 18
    hold theirs), and passes 2-3 must drop nothing; pass 3 is timed."""
    import torch
    from taichislam_tpu_torch.ops import sequence as seq
    from taichislam_tpu_torch.utils.synthetic_scene import orbit_sequence
    t0 = time.perf_counter()
    depth_np, Rs, Ts, K = orbit_sequence(n_frames=C3_FRAMES)
    depth = [torch.from_numpy(d.astype(np.int32)).to(dev) for d in depth_np]
    frames = (depth, Rs, Ts)
    log(f"[phase21] rendered and staged {C3_FRAMES} 640x480 frames in "
        f"{time.perf_counter() - t0:.1f} s")

    # per-call deferred path: graph and eager in lockstep in passes 1-2,
    # every frame compared; pass 3 timed for each alone
    seq.graph_cache.reset_counts()
    g, e = c3_model(dev, K, C3_INTERVAL), c3_model(dev, K, C3_INTERVAL)
    verdicts = []
    record_verdicts(g, verdicts)
    snap = None
    for p in (1, 2):
        for f in range(C3_FRAMES):
            g.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
            with eager_sequences():
                e.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
            maps_bit_equal(g, e, f"per-call pass {p} frame {f}")
            if p == 1 and f == C3_CPU_FRAMES - 1:
                snap = c3_host_copy(g)
        if p == 1:
            settling, n1 = list(verdicts), len(verdicts)
            floor = max(b for _, b, _ in settling)
            for m in (g, e):
                hold_frame_bins(m, floor)
            caps = [seq.graph_cache.captures]
            cap_ms = [seq.graph_cache.capture_ms]
    caps.append(seq.graph_cache.captures - caps[0])
    cap_ms.append(seq.graph_cache.capture_ms - cap_ms[0])
    log(f"[phase21] per-call passes 1-2 (graph and eager in lockstep): "
        f"graph == eager bit for bit after each of {2 * C3_FRAMES} frames "
        f"(tables, flags, TSDF, W, ESDF, fixed, pending, stats, "
        f"accumulators, buckets); graph captures {caps[0]} in pass 1 "
        f"({cap_ms[0]:.1f} ms, warm-up included) and {caps[1]} in pass 2 "
        f"({cap_ms[1]:.1f} ms); pass 1's verdicts [bins_total, dropped, "
        f"live_lanes, esdf_overflow], bin bucket, ESDF cap: {settling}; bin "
        f"bucket held at {floor} from pass 2")
    counters = reset_counts()
    seq.graph_cache.reset_counts()
    n2 = len(verdicts)
    ms_g, wall_g = c3_pass(g, frames, C3_FRAMES)
    got, sites = read_counts(counters, launches)
    caps3, reps = seq.graph_cache.captures, seq.graph_cache.replays
    with eager_sequences():
        counters_e = reset_counts()
        ms_e, wall_e = c3_pass(e, frames, C3_FRAMES)
        got_e, _ = read_counts(counters_e, {"K1": 0, "K2": 0, "K3": 0})
    maps_bit_equal(g, e, "per-call pass 3")
    for pack, bucket, ecap in verdicts[n1:]:
        bins_total, dropped, _, ov = pack
        require(dropped == 0 and ov == 0 and bins_total <= bucket,
                f"capacity drop after settling: {pack} under bin bucket "
                f"{bucket}, ESDF cap {ecap}")
    require(got["K1"] > 0 and got["K3"] > 0, "phase 21: K1 / K3 launches")
    require(reps == C3_FRAMES, f"phase 21: {reps} replays")
    log(f"[phase21] per-call pass 3: graph {ms_g:.3f} ms/frame (events; "
        f"wall {wall_g:.3f}), eager *_ref on the card {ms_e:.3f} ms/frame "
        f"(wall {wall_e:.3f}) ({smi}); graph == eager bit for bit; "
        f"captures {caps3}, replays {reps}; launches per frame graph K1 "
        f"{got['K1'] / C3_FRAMES:.2f} K2 {got['K2'] / C3_FRAMES:.2f} K3 "
        f"{got['K3'] / C3_FRAMES:.2f} (K1 by site {sites}), eager K1 "
        f"{got_e['K1'] / C3_FRAMES:.2f} K3 {got_e['K3'] / C3_FRAMES:.2f}; "
        f"passes 2-3 verdicts {verdicts[n1:n2]} / {verdicts[n2:]} (no "
        f"drop); buckets bins {g._bin_bucket} touched "
        f"{getattr(g, '_touched_bucket', None)} ESDF cap "
        f"{g._esdf_cap_bucket}")
    cap = g._esdf_cap_bucket
    del e

    # one frame's kernels, then the idle share of one verdict interval
    k_one, busy1, _, names, _ = c3_profile(g, frames, 1)
    log(f"[phase21] one per-call frame under torch.profiler: {k_one:.0f} "
        f"CUDA kernels (device busy {busy1:.3f} ms): "
        f"{dict(sorted(names.items(), key=lambda x: -x[1]))}")
    k_n, busy, wall, _, top = c3_profile(g, frames, C3_INTERVAL)
    log(f"[phase21] profiled {C3_INTERVAL} per-call frames (one verdict "
        f"interval): {k_n:.0f} CUDA kernels per frame, device busy "
        f"{busy:.3f} ms per frame: idle share {1 - busy / ms_g:.3f} of "
        f"pass 3's unprofiled {ms_g:.3f} ms/frame, {1 - busy / wall:.3f} "
        f"of the {wall:.3f} ms/frame under the profiler; device ms per "
        f"frame by kernel, largest first: {top} ({smi})")
    del g
    seq.graph_cache.clear()

    # windowed path, W = 20: passes 1-2 in lockstep, pass 3 timed
    gw, ew = c3_model(dev, K, 1), c3_model(dev, K, 1)
    seq.graph_cache.reset_counts()
    buckets, floor_w = [], None
    for p in (1, 2):
        for f in range(0, C3_FRAMES, C3_WINDOW):
            sl = slice(f, f + C3_WINDOW)
            gw.recast_depth_sequence(Rs[sl], Ts[sl], depth[sl])
            with eager_sequences():
                ew.recast_depth_sequence(Rs[sl], Ts[sl], depth[sl])
            maps_bit_equal(gw, ew, f"windowed pass {p} window at frame {f}")
            buckets.append(gw._bin_bucket)
            if floor_w is not None:
                require(int(gw.last_stats["max_dropped"]) == 0 and
                        int(gw.last_stats["max_bins_total"]) <= floor_w,
                        f"windowed drop after settling: {gw.last_stats}")
        if p == 1:
            floor_w = max(buckets)
            for m in (gw, ew):
                hold_seq_bins(m, floor_w)
    cap_w = seq.graph_cache.captures
    seq.graph_cache.reset_counts()
    counters = reset_counts()
    msw_g, wallw_g = c3_pass(gw, frames, C3_FRAMES, window=C3_WINDOW)
    got_w, _ = read_counts(counters, launches)
    caps_w, reps_w = seq.graph_cache.captures, seq.graph_cache.replays
    with eager_sequences():
        msw_e, wallw_e = c3_pass(ew, frames, C3_FRAMES, window=C3_WINDOW)
    maps_bit_equal(gw, ew, "windowed pass 3")
    require(int(gw.last_stats["max_dropped"]) == 0 and
            int(gw.last_stats["max_bins_total"]) <= floor_w,
            "windowed drops in the timed pass")
    log(f"[phase21] windowed W = {C3_WINDOW}, pass 3: graph {msw_g:.3f} "
        f"ms/frame (wall {wallw_g:.3f}), eager *_ref {msw_e:.3f} ms/frame "
        f"(wall {wallw_e:.3f}) ({smi}); graph == eager bit for bit after "
        f"each window of passes 1-2 and after pass 3; captures {cap_w} in "
        f"passes 1-2, {caps_w} in pass 3, replays {reps_w}; bin buckets "
        f"{buckets} (held at {floor_w} from pass 2); launches per frame K1 "
        f"{got_w['K1'] / C3_FRAMES:.2f} K2 {got_w['K2'] / C3_FRAMES:.2f} "
        f"K3 {got_w['K3'] / C3_FRAMES:.2f}")
    del gw, ew
    seq.graph_cache.clear()
    torch.cuda.empty_cache()

    c3_interval_phase(dev, frames, K, floor, cap)
    seq.graph_cache.clear()
    c3_cpu_phase(dev, frames, K, snap)
    log(f"[phase21] took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phases 22-23: the measurement entry points
# ---------------------------------------------------------------------------

def states_bit_equal(a, b, tag):
    """Two BenchStates bit for bit: the grid state and the ESDF carries."""
    import torch
    names = ("esdf", "fixed", "pending", "seen_tsdf", "seen_obs")
    pairs = [(f, getattr(a.state, f), getattr(b.state, f))
             for f in a.state._fields if f != "channels"]
    pairs += [(k, a.state.channels[k], b.state.channels[k])
              for k in a.state.channels]
    pairs += list(zip(names, a.carries, b.carries))
    for name, x, y in pairs:
        require(torch.equal(bits(x), bits(y)), f"{tag}: {name}")


def bench_phase(dev, smi, launches, eager_ms):
    """Phase 22: the port's bench.py at full size (50 orbit frames at
    640x480, staged on the card once) through its entry point's
    ``run_bench``: every row sized by the JAX bench's rule and timed over
    graph replays (CUDA events, best of 3; no capture in a timed pass, no
    drop). Then the primary's map after its timed passes against the same
    window through the eager ``integrate_esdf_sequence_ref`` on the card,
    bit for bit at float16 storage; K1 / K3 launches per frame (K2 none);
    the eager ms/frame beside phase 3's for the same configuration; and
    the idle share of one profiled window."""
    import torch
    from taichislam_tpu_torch import bench
    from taichislam_tpu_torch.ops import sequence as seq
    from taichislam_tpu_torch.utils.synthetic_scene import D435_K
    t0 = time.perf_counter()
    depth, Rs, Ts = bench.make_inputs(bench.N_FRAMES)
    frames = bench.stage_frames(depth, Rs, Ts, D435_K, dev)
    n = bench.N_FRAMES
    log(f"[phase22] rendered and staged {n} 640x480 frames in "
        f"{time.perf_counter() - t0:.1f} s")
    seq.graph_cache.clear()
    seq.graph_cache.reset_counts()
    counters = reset_counts()
    t1 = time.perf_counter()
    out, rows = bench.run_bench(frames)
    got, sites = read_counts(counters, launches)
    out["device"] = bench.device_info(dev)
    log(f"[phase22] bench line: {json.dumps(out)}")
    log(f"[phase22] run_bench took {time.perf_counter() - t1:.1f} s; "
        f"graph captures {seq.graph_cache.captures} "
        f"({seq.graph_cache.capture_ms:.1f} ms, warm-up included), replays "
        f"{seq.graph_cache.replays}; launches {got}, K1 by site {sites}")
    want = {"fusion": (2, 0, 0), "primary": (2, 0, 1),
            "drained": (2, 0, 1), "big": (2, 0, 0)}
    for name, r in rows.items():
        lp = r["launches_per_frame"]
        require(r["timed_captures"] == 0, f"{name}: capture in a timed pass")
        w = r["window"]
        require(w["dropped"] == 0 and w["esdf_overflow"] == 0 and
                w["bins_total"] <= r["cfg"].max_bins, f"{name}: drops {w}")
        require((lp["K1"], lp["K2"], lp["K3"]) == want[name],
                f"{name}: launches per frame {lp}")
        log(f"[phase22] {name}: best {r['ms_per_frame']:.3f} ms/frame, "
            f"median {r['median_ms_per_frame']:.3f}, spread "
            f"{r['spread_ms_per_frame']:.3f} (passes {r['passes_ms']} ms "
            f"per window of {n}) ({smi}); sized in {r['rounds']} windows: "
            f"max_bins {r['cfg'].max_bins} max_march_lanes "
            f"{r['cfg'].max_march_lanes} max_touched_blocks "
            f"{r['cfg'].max_touched_blocks} esdf_cap {r['esdf_cap']}; no "
            f"capture and no drop in the timed passes (window {w}); "
            f"launches per frame {lp}")

    # the primary's map after its timed passes against the eager loop
    prim = rows["primary"]
    cfg, cap, bs = prim["cfg"], prim["esdf_cap"], prim["bench_state"]
    require(bs.state.channels["TSDF"].dtype == torch.float16,
            "bench storage is not float16")
    ref = bench.BenchState(cfg, dev)
    counters = reset_counts()
    ms_ref, _ = bench.timed(dev, lambda: seq.integrate_esdf_sequence_ref(
        cfg, 3, cap, ref.state, *ref.carries, frames.depth, None, frames.Rs,
        frames.Ts, frames.K, frames.K, 0))
    got_e, _ = read_counts(counters, {"K1": 0, "K2": 0, "K3": 0})
    states_bit_equal(bs, ref, "bench primary, graph vs eager")
    log(f"[phase22] primary after its timed passes == the same {n} frames "
        f"through the eager integrate_esdf_sequence_ref on the card, bit for "
        f"bit (float16 TSDF and W, flags, ESDF, fixed, pending, snapshots); "
        f"eager {ms_ref / n:.3f} ms/frame (launches per frame K1 "
        f"{got_e['K1'] / n:.2f} K3 {got_e['K3'] / n:.2f}) against the graph's "
        f"{prim['ms_per_frame']:.3f}; phase 3's eager per-frame loop, same "
        f"configuration, {eager_ms:.3f} ms/frame in this call ({smi})")
    del ref

    # one profiled window of the primary
    bs.reset()
    k_n, busy, wall, _, top = profile_frames(
        lambda: bench.run_window(cfg, cap, 3, bs, frames), n,
        "bench_profile.txt")
    idle = 1 - busy / prim["ms_per_frame"]
    why = (" (below 0: the kernels ran longer under the profiler than the "
           "whole unprofiled frame; no idle time is measurable)"
           if idle < 0 else "")
    log(f"[phase22] profiled one primary window ({n} frames, graph "
        f"replays): {k_n:.0f} CUDA kernels per frame, device busy "
        f"{busy:.3f} ms per frame: idle share {idle:.3f} of the unprofiled "
        f"best {prim['ms_per_frame']:.3f} ms/frame{why}, "
        f"{1 - busy / wall:.3f} of the {wall:.3f} ms/frame under the "
        f"profiler; device ms per frame by kernel, largest first: {top} "
        f"({smi})")
    del rows, prim, bs
    seq.graph_cache.clear()
    torch.cuda.empty_cache()
    log(f"[phase22] took {time.perf_counter() - t0:.1f} s")


def tools_phase(smi):
    """Phase 23: the port's tools, each in its own process on the card:
    bench_configs at 40 frames (all five configurations; the fixtures are
    rendered and fused into build/fixtures/ first), bench_secondary,
    compare_vs_reference (must print FIDELITY: PASS) and the viewer's demo
    scene for a few seconds on a free port."""
    pkg = "taichislam_tpu_torch.tools."
    lines, wall = run_tool([pkg + "bench_configs", "--frames", "40"], 900,
                           "== BASELINE.json configs (cuda")
    table = lines[[i for i, ln in enumerate(lines)
                   if ln.startswith("== BASELINE.json configs")][-1]:]
    configs = [ln.split()[0] for ln in table[1:]]
    require(configs == ["1", "2", "3", "3", "4", "4", "5"],
            f"bench_configs rows {configs}")
    log(f"[phase23] bench_configs --frames 40: exit 0 in {wall:.1f} s wall "
        f"({smi})")
    for ln in table:
        log(f"[phase23]   {ln}")
    lines, wall = run_tool([pkg + "bench_secondary"], 300,
                           "marching cubes (full map")
    log(f"[phase23] bench_secondary: exit 0 in {wall:.1f} s wall ({smi})")
    for ln in lines:
        log(f"[phase23]   {ln}")
    lines, wall = run_tool([pkg + "compare_vs_reference"], 300,
                           "FIDELITY: PASS")
    log(f"[phase23] compare_vs_reference on the card: exit 0 in {wall:.1f} "
        f"s: {lines}")
    lines, wall = run_tool([pkg + "viewer_demo_scene", "--port", "0",
                            "--seconds", "3"], 300, "[viewer-demo] serving")
    log(f"[phase23] viewer_demo_scene --port 0 --seconds 3: exit 0 in "
        f"{wall:.1f} s wall; {lines[-1]}")


# ---------------------------------------------------------------------------
# phases 19-20: the multi-card compositions, several ranks on one card
# ---------------------------------------------------------------------------

SHARD_RANKS = 4
DRONES = 4
DRONE_FRAMES = 20
DRONE_SWEEPS = 6
DRONE_ESDF_CAP = 256
DRONE_FUSE_BLOCKS = 256
DRONE_TRIANGLES = 1 << 18
DRONE_MESH_CAP = 128
# the launch file's node (phase 16) without its multicast comm: phase 20's
# ranks stand for the drones
DRONE_PARAMS = dict(LAUNCH_PARAMS, **{"~enable_multi": False})


def sharded_pass(mesh, kw, frames, spy=None):
    """Drive a ShardedDenseTSDF with ``kw`` on ``mesh`` over ``frames``
    (depth, Rs, Ts, K): per frame the wall ms (closed by a synchronize)
    and the sweeps, and ``spy(f, model, touched)`` after each frame when
    given. Returns (model, ms per frame, sweeps per frame)."""
    import torch
    from taichislam_tpu_torch.models.sharded_dense_tsdf import \
        ShardedDenseTSDF
    depth, Rs, Ts, K = frames
    m = ShardedDenseTSDF(mesh=mesh, **kw)
    m.set_dep_camera_intrinsic(K)
    seen = {}
    integrate = m._integrate_fn

    def recorded(*args):
        st, touched = integrate(*args)
        seen["touched"] = touched
        return st, touched
    m._integrate_fn = recorded
    ms, sweeps = [], []
    for f in range(len(depth)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f])
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
        sweeps.append(m.last_esdf_sweeps)
        if spy is not None:
            spy(f, m, seen["touched"])
    return m, np.array(ms), sweeps


def sharded_outputs(m):
    """What a ShardedDenseTSDF holds and exports, gathered and on the host
    (the same on every rank): tables, the allocated rows of every channel
    and of the ESDF field and flags, the re-queue bitmap, the surface
    export (rows sorted) and the incremental mesh patch (vertex rows
    sorted). Each rank's rows past the allocated ones must be zero; only
    the allocated rows are gathered."""
    import torch
    st, mesh = m.state, m.mesh
    nbk = int(st.num_blocks)
    rows = m.esdf.shape[0]
    k = min(rows, nbk)           # rows each rank sends, padded alike
    own = [min(k, max(0, nbk - r * rows)) for r in range(mesh.size)]
    out = {"table": st.table, "block_coords": st.block_coords,
           "num_blocks": st.num_blocks, "pending": m._esdf_pending}
    local = {"esdf": m.esdf, "fixed": m.esdf_fixed, **st.channels}
    for name, v in local.items():
        require(not bool(v[own[mesh.rank]:].any()),
                f"{name}: rows past the allocated {nbk} are not zero")
        g = mesh.all_gather(v[:k])
        out[name] = torch.cat([g[r * k:r * k + own[r]]
                               for r in range(mesh.size)])
    out = {name: v.cpu().numpy() for name, v in out.items()}
    m.cvt_TSDF_surface_to_voxels()
    n = m.num_TSDF_particles
    xyzt = np.concatenate([m.export_TSDF_xyz[:n], m.export_TSDF[:n, None]],
                          axis=1)
    out["surface"] = xyzt[np.lexsort(xyzt.T[::-1])]
    patch = m.extract_mesh(incremental=True)
    nt = int(patch["num_triangles"])
    v = patch["vertices"][:nt * 3].cpu().numpy()
    out["mesh"] = v[np.lexsort(v.T[::-1])]
    return out


def compare_sharded(ref, got, tag):
    """Hold ``got`` against ``ref`` (both from :func:`sharded_outputs`),
    every array exactly: each rank's K1 sums a voxel's lanes in their lane
    order, whichever rank holds them."""
    for k, want in ref.items():
        have = got[k]
        require(want.shape == have.shape, f"{tag}: {k} shape {have.shape} "
                f"for {want.shape}")
        if not np.array_equal(have, want):
            err = np.abs(have.astype(np.float64) - want.astype(np.float64))
            require(False, f"{tag}: {k} differs (max abs {err.max()})")


def count_sharded_lanes():
    """Wrap the sharded integrate's K1 call in this process so that the
    march lanes it hands K1 (keys other than the sentinel) add up on the
    card; returns the one-element list that holds the running count."""
    import torch
    from taichislam_tpu_torch.parallel import block_sharded as bs
    k1 = bs.segmented_block_reduce
    lanes = [torch.zeros((), dtype=torch.int64)]

    def counted(bkey, *args, **kw):
        lanes[0] = lanes[0].to(bkey.device) + (bkey != bs.SENTINEL_BLOCK).sum()
        return k1(bkey, *args, **kw)
    bs.segmented_block_reduce = counted
    return lanes


def time_collectives(mesh):
    """Wrap the mesh's collectives so that their wall time adds up, the
    card synchronised on both sides (queued kernels are not charged to
    them); returns the dict that holds the seconds and the calls."""
    import torch
    spent = {"s": 0.0, "calls": 0, "frames": []}
    for name in ("all_gather", "psum", "any"):
        def timed(t, fn=getattr(mesh, name)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out
        setattr(mesh, name, timed)
    return spent


def frame_split(ms, spent):
    """(frame 0's ms and collective ms, the later frames' mean ms and mean
    collective ms) from per-frame wall ms and the cumulative collective
    seconds recorded after each frame: frame 0 holds the communicators'
    set-up and the first allocations."""
    c = np.diff(np.concatenate([[0.0], spent["frames"]])) * 1000
    return ms[0], c[0], ms[1:].mean(), c[1:].mean()


def record_frames(spent):
    """A sharded_pass spy that records the collective seconds so far."""
    return lambda f, m, touched: spent["frames"].append(spent["s"])


def sharded_rank(mesh, passes, frames):
    """Phase 19's rank: for each (model keywords, one-rank outputs path)
    of ``passes``, the same frames through ShardedDenseTSDF on this rank's
    shard, its launch counts, the march lanes its K1 reduced, the
    allocated blocks its shard holds, per-frame ms, collective bytes and
    peak memory, and its gathered outputs held against the one-rank run.
    Returns one result per pass."""
    import torch
    lanes = count_sharded_lanes()
    spent = time_collectives(mesh)
    out = []
    for kw, ref_path in passes:
        counters = reset_counts()
        lanes[0] = torch.zeros((), dtype=torch.int64)
        spent.update(s=0.0, calls=0, frames=[])
        mesh.bytes_moved = 0
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        m, ms, sweeps = sharded_pass(mesh, kw, frames,
                                     spy=record_frames(spent))
        torch.cuda.synchronize()
        got = dict(zip(("K1", "K2", "K3"), (c.launches for c in counters)))
        moved, peak = mesh.bytes_moved, torch.cuda.max_memory_allocated()
        coll = frame_split(ms, spent)
        rows = m.esdf.shape[0]
        lo = mesh.rank * rows
        table = m.state.table
        held = int(((table >= lo) & (table < lo + rows)).sum())
        with np.load(ref_path) as z:
            ref = dict(z)
        compare_sharded(ref, sharded_outputs(m), f"rank {mesh.rank}")
        del m
        out.append(dict(launches=got, ms=ms.tolist(), sweeps=sweeps,
                        bytes=moved, peak=peak, coll=coll,
                        lanes=int(lanes[0]), held=held))
    return out


def sharded_phase(dev, smi, frames, cfg3, launches):
    """Phase 19: ShardedDenseTSDF at its own defaults (10 x 10 m, 5 cm,
    V = 16, 8192 slots, f32, ESDF 8 sweeps and cap 512, surface cap 512)
    with phase 3's sized bins, over the bench frames: on a one-rank NCCL
    mesh, its ESDF held after every frame against a single-device
    esdf_update chain on its state, and its integrate against the same
    model on the CPU (4 frames); then on 4 gloo ranks sharing the card,
    every rank's gathered map, ESDF, surface export and mesh patch held
    against the one-rank run, exactly; then both again with max_blocks
    cut so that the blocks land in every rank's shard."""
    import torch
    from taichislam_tpu_torch.ops import esdf as esdf_ops
    from taichislam_tpu_torch.parallel.mesh import make_mesh, spawn_mesh
    kw = dict(max_bins=cfg3.max_bins, max_march_lanes=cfg3.max_march_lanes)
    mesh = make_mesh(1, "block", device=dev, backend="nccl")
    counters = reset_counts()
    # earlier phases' unreachable tensors go now, not during the pass,
    # where their release would hide the pass's own peak
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    spent = time_collectives(mesh)
    m, ms, sweeps = sharded_pass(mesh, kw, frames, spy=record_frames(spent))
    torch.cuda.synchronize()
    got, sites = read_counts(counters, launches)
    peak = torch.cuda.max_memory_allocated() - base
    coll = frame_split(ms, spent)
    require(got["K1"] > 0 and got["K2"] > 0 and sites.get("sharded", 0) > 0,
            f"sharded map: K1 or K2 not launched ({got}, {sites})")
    cfg = m.cfg
    V, nb = cfg.grid.V, cfg.grid.max_blocks + 1
    W3 = (V + 2) ** 3
    log(f"[phase19] one-rank NCCL mesh: launches {got}, K1 by site {sites}, "
        f"per frame K1 {got['K1'] / N_FRAMES:.2f} K2 "
        f"{got['K2'] / N_FRAMES:.2f}; sweeps {sweeps}; ms/frame "
        f"{np.round(ms, 3).tolist()}, mean {ms.mean():.3f} ({smi}); "
        f"collectives: frame 0 {coll[1]:.3f} of {coll[0]:.3f} ms, frames "
        f"1-{N_FRAMES - 1} {coll[3]:.3f} of {coll[2]:.3f} ms/frame; peak "
        f"{peak / 2**20:.1f} MiB above what earlier phases hold")

    # K2 at the sharded call site, in the profiler
    esdf_fn = m._esdf_fn(m._esdf_cap_bucket)
    every = m.state.block_active.clone()
    kernels, _ = profile_call(lambda: esdf_fn(
        m.state, m.esdf.clone(), m.esdf_fixed.clone(), 0, every),
        expect=("k2_kernel",))
    k2 = {k: v for k, v in kernels.items() if "k2_kernel" in k}
    require(k2, f"sharded ESDF: no k2_kernel in the profiler ({kernels})")
    nbk = int(m.state.num_blocks)
    log(f"[phase19] profiler, one sharded ESDF update over all {nbk} "
        f"blocks: " + ", ".join(
            f"{kernel_name(k)} {n}x {us / 1000:.4f} ms"
            for k, (n, us) in k2.items()))
    cap = m.esdf_block_cap
    ref = sharded_outputs(m)
    ref_path = OUT_DIR / "sharded_ref.npz"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(ref_path, **ref)
    del m

    # the same frames again, held after every frame against a
    # single-device esdf_update chain on the model's own state
    chain, snap = {}, {}

    def check(f, m, touched):
        if not chain:
            shape = (nb, cfg.grid.voxels_per_block)
            chain.update(e=torch.zeros(shape, device=dev),
                         fx=torch.zeros(shape, dtype=torch.int8, device=dev),
                         p=torch.zeros((nb,), dtype=torch.bool, device=dev))
        e, fx, _, sw, ch, _ = esdf_ops.esdf_update(
            cfg, m.max_esdf_sweeps, m._esdf_cap_bucket, m.state, chain["e"],
            chain["fx"], 0, touched | chain["p"])
        chain["p"] = ch
        require(torch.equal(e, m.esdf) and torch.equal(fx, m.esdf_fixed)
                and int(sw) == m.last_esdf_sweeps and
                torch.equal(ch, m._esdf_pending),
                f"sharded ESDF frame {f}: not the single-device chain's "
                f"(sweeps {m.last_esdf_sweeps} vs {int(sw)}, max abs "
                f"{float((e - m.esdf).abs().max())})")
        if f == CPU_FRAMES - 1:
            snap.update(table=m.state.table.cpu(),
                        obs=m.state.channels["TSDF_observed"].cpu(),
                        occ=m.state.channels["occupy"].cpu(),
                        tsdf=m.state.channels["TSDF"].cpu())
    m, _, sweeps2 = sharded_pass(mesh, kw, frames, spy=check)
    require(sweeps2 == sweeps, "sharded map: a second pass swept otherwise")
    compare_sharded(ref, sharded_outputs(m), "one rank, second pass")
    del m
    log(f"[phase19] one rank against the single-device esdf_update chain "
        f"(K3) after every frame: field, fixed flags, sweeps and re-queue "
        f"bitmap exact over {N_FRAMES} frames")

    cpu = torch.device("cpu")
    cmesh = make_mesh(1, "block", device=cpu, backend="gloo")
    c, _, _ = sharded_pass(cmesh, dict(kw, enable_esdf=False),
                           [x[:CPU_FRAMES] for x in frames[:3]] + [frames[3]])
    require(torch.equal(c.state.table, snap["table"]) and
            torch.equal(c.state.channels["TSDF_observed"], snap["obs"]) and
            torch.equal(c.state.channels["occupy"], snap["occ"]),
            "sharded integrate card vs CPU: tables or flags")
    e_tsdf = float((c.state.channels["TSDF"] - snap["tsdf"]).abs().max())
    # K1 sums f32 values at this site (no f16 rounding, unlike phase 4's)
    require(e_tsdf <= 1e-5, f"sharded integrate card vs CPU: TSDF {e_tsdf}")
    del c
    log(f"[phase19] sharded integrate card vs CPU over {CPU_FRAMES} frames: "
        f"tables and flags exact, TSDF max abs {e_tsdf} (limit 1e-5)")

    # the same frames with the slots cut so that the blocks land in every
    # shard: ranks 1-3 reduce lanes and scatter into their own rows too
    n = SHARD_RANKS
    shard = -(-2 * nbk // (2 * n - 1))      # ceil(nbk / (n - 1/2))
    cut = dict(kw, max_blocks=n * shard - 1)
    m, _, cut_sweeps = sharded_pass(mesh, cut, frames)
    require(int(m.state.num_blocks) == nbk,
            f"cut map: {int(m.state.num_blocks)} blocks for {nbk}")
    cut_path = OUT_DIR / "sharded_cut_ref.npz"
    np.savez(cut_path, **sharded_outputs(m))
    del m

    # both maps on 4 gloo ranks, one spawn
    t0 = time.perf_counter()
    res = spawn_mesh(sharded_rank, n, backend="gloo", device=dev,
                     args=([(kw, str(ref_path)), (cut, str(cut_path))],
                           frames), axis="block", store_dir=OUT_DIR,
                     threads=2)
    wall = time.perf_counter() - t0
    ref_path.unlink()
    cut_path.unlink()
    full, spread = [o[0] for o in res], [o[1] for o in res]
    for got, want in ((full, sweeps), (spread, cut_sweeps)):
        for r, out in enumerate(got):
            for k, v in out["launches"].items():
                launches[k] += v
            require(out["sweeps"] == want, f"rank {r}: sweeps {out['sweeps']}")
        tot = {k: sum(o["launches"][k] for o in got) for k in ("K1", "K2")}
        require(tot["K1"] > 0 and tot["K2"] > 0, f"4 ranks: launches {tot}")
    require(all(o["held"] > 0 and o["lanes"] > 0 for o in spread),
            f"cut map: a shard without blocks or K1 lanes: held "
            f"{[o['held'] for o in spread]}, lanes "
            f"{[o['lanes'] for o in spread]}")
    log(f"[phase19] {n} gloo ranks on one card, both maps in one spawn "
        f"({wall:.1f} s with the spawn)")
    log(f"[phase19] {n} gloo ranks: every rank's gathered channels, ESDF, "
        f"flags, re-queue bitmap, surface export and mesh patch equal the "
        f"one-rank run exactly; launches per rank "
        f"{[o['launches'] for o in full]}; {nbk} blocks, held per rank "
        f"{[o['held'] for o in full]} of {nb // n} slots, march lanes K1 "
        f"reduced per rank {[o['lanes'] for o in full]} (slots are handed "
        f"out in order, so the first shard fills first)")
    rows = -(-(cap + 1) // (8 * n)) * (8 * n)
    for r, out in enumerate(full):
        ms_r = np.array(out["ms"])
        log(f"[phase19] rank {r}: ms/frame mean {ms_r.mean():.3f} "
            f"({np.round(ms_r, 3).tolist()}); collectives: frame 0 "
            f"{out['coll'][1]:.3f} of {out['coll'][0]:.3f} ms, frames "
            f"1-{N_FRAMES - 1} {out['coll'][3]:.3f} of {out['coll'][2]:.3f} "
            f"ms/frame; collective payload "
            f"{out['bytes'] / N_FRAMES / 2**20:.2f} MiB/frame; peak "
            f"{out['peak'] / 2**20:.1f} MiB ({smi})")
    log(f"[phase19] per-sweep all_gather at the largest cap ({cap} rows, "
        f"NROWS {rows}): {rows // n * W3 * 4 / 2**20:.2f} MiB sent and "
        f"{rows * W3 * 4 / 2**20:.2f} MiB received per rank")
    log(f"[phase19] {n} gloo ranks, max_blocks cut to {n * shard - 1} "
        f"({shard} slots a rank; a cut of scale): {nbk} blocks, held per "
        f"rank {[o['held'] for o in spread]}, march lanes K1 reduced per "
        f"rank {[o['lanes'] for o in spread]}; every rank's gathered map, "
        f"ESDF, flags, re-queue bitmap, surface export and mesh patch equal "
        f"a one-rank run at the cut exactly; launches per rank "
        f"{[o['launches'] for o in spread]}; ms/frame mean per rank "
        f"{[round(float(np.mean(o['ms'])), 3) for o in spread]} ({smi})")


def drone_frames(frames, d):
    """Drone ``d``'s flight: 20 of the orbit's frames from its own start
    along the orbit, in a room translated by its own offset (a rigid
    shift of every pose keeps the depth frames consistent)."""
    depth, Rs, Ts = frames
    idx = [(10 * d + f) % len(depth) for f in range(DRONE_FRAMES)]
    off = np.array([0.5 * d, -0.3 * d, 0.0], np.float32)
    return depth[idx], Rs[idx], Ts[idx] + off


def drone_summary(sub_cfg, life, patch, g=None):
    """One drone's lifecycle state, ESDF and last mesh patch on the host,
    allocated rows only, and the global map's totals when given."""
    st = life["state"]
    nbk = int(st.num_blocks)
    table = st.table.cpu().numpy()
    used = np.nonzero(table >= 0)[0]
    out = dict(num_blocks=nbk, table_idx=used, table_val=table[used],
               active=life["active"], base_R=life["base_R"].copy(),
               base_T=life["base_T"].copy(),
               pending=life["pending"].cpu().numpy())
    for k in ("TSDF", "W_TSDF", "TSDF_observed", "occupy"):
        out[k] = st.channels[k][:nbk].cpu().numpy()
    out["esdf"] = life["esdf"][:nbk].cpu().numpy()
    out["fixed"] = life["fixed"][:nbk].cpu().numpy()
    nt = int(patch["counts"][0])
    out["counts"] = patch["counts"].cpu().numpy()
    out["vertices"] = patch["vertices"][:nt * 3].cpu().numpy()
    if g is not None:
        out["global"] = dict(
            num_blocks=int(g.num_blocks),
            tsdf_sum=float(g.channels["TSDF"].double().sum()),
            observed=int((g.channels["TSDF_observed"] > 0).sum()))
    return out


def drone_rank(mesh, sub_cfg, glob_cfg, frames):
    """Phase 20's rank: drone ``rank`` through multi_drone_lifecycle_step
    (ESDF and mesh patch on), then multi_drone_fuse; its launch counts,
    step and fuse ms, the fuse's collective bytes and its summary."""
    import torch
    from taichislam_tpu_torch.ops import tsdf as tsdf_ops
    from taichislam_tpu_torch.parallel.multi_drone import (
        make_lifecycle_states, multi_drone_fuse, multi_drone_lifecycle_step)
    dev = mesh.device
    depth, Rs, Ts = drone_frames(frames, mesh.rank)
    K = torch.from_numpy(KDEPTH).to(dev)
    counters = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    life = make_lifecycle_states(sub_cfg, with_esdf=True, device=dev)
    step = multi_drone_lifecycle_step(
        sub_cfg, KEYFRAME_STEP, mesh, esdf_sweeps=DRONE_SWEEPS,
        esdf_block_cap=DRONE_ESDF_CAP, mesh_triangles=DRONE_TRIANGLES,
        mesh_block_cap=DRONE_MESH_CAP)
    ms, stats = [], []
    for f in range(DRONE_FRAMES):
        d = torch.from_numpy(depth[f].astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        life, patch = step(life, d, Rs[f], Ts[f], True, K)
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
        stats.append(life["esdf_stats"].tolist() +
                     patch["counts"].tolist())
    g = tsdf_ops.make_tsdf_state(glob_cfg, device=dev)
    fuse = multi_drone_fuse(sub_cfg, glob_cfg, DRONE_FUSE_BLOCKS, mesh,
                            with_esdf=True)
    mesh.bytes_moved = 0
    spent = time_collectives(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = fuse(life, g)
    torch.cuda.synchronize()
    fuse_ms = 1000 * (time.perf_counter() - t0)
    got = dict(zip(("K1", "K2", "K3"), (c.launches for c in counters)))
    return dict(launches=got, sites=dict(counters[0].site_launches), ms=ms,
                stats=stats, fuse_ms=fuse_ms, fuse_bytes=mesh.bytes_moved,
                fuse_coll_ms=1000 * spent["s"],
                peak=torch.cuda.max_memory_allocated(),
                summary=drone_summary(sub_cfg, life, patch, g))


def sequential_drones(dev, sub_cfg, glob_cfg, frames):
    """Phase 20's drones one after another through the single-device ops
    (integrate_depth, esdf_update, dilate_blocks + extract_mesh) and
    fuse_submaps into one global map on ``dev``. Returns each drone's
    summary and the global map."""
    import torch
    from taichislam_tpu_torch.ops import esdf as esdf_ops
    from taichislam_tpu_torch.ops import fusion as fusion_ops
    from taichislam_tpu_torch.ops import marching_cubes as mc_ops
    from taichislam_tpu_torch.ops import tsdf as tsdf_ops
    from taichislam_tpu_torch.parallel.multi_drone import (
        lifecycle_pose, make_lifecycle_states)
    K = torch.from_numpy(KDEPTH).to(dev)
    tex = torch.zeros((1, 1, 3), dtype=torch.uint8, device=dev)
    S = sub_cfg.max_submap_num
    g = tsdf_ops.make_tsdf_state(glob_cfg, device=dev)
    out = []
    for d in range(DRONES):
        depth, Rs, Ts = drone_frames(frames, d)
        life = make_lifecycle_states(sub_cfg, with_esdf=True, device=dev)
        st = life["state"]
        for f in range(DRONE_FRAMES):
            act, R_in, T_in = lifecycle_pose(life, KEYFRAME_STEP, S, Rs[f],
                                             Ts[f], True)
            st, stats = tsdf_ops.integrate_depth(
                sub_cfg, st, torch.from_numpy(depth[f].astype(np.int32)).to(
                    dev), tex, torch.from_numpy(R_in).to(dev),
                torch.from_numpy(T_in).to(dev), K, K, act)
            dirty = stats["touched_blocks"] | life["pending"]
            e, fx, _, _, ch, ov = esdf_ops.esdf_update(
                sub_cfg, DRONE_SWEEPS, DRONE_ESDF_CAP, st, life["esdf"],
                life["fixed"], act, dirty)
            life["pending"] = torch.where(ov > 0, ch | dirty, ch)
        life["state"] = st
        dil = mc_ops.dilate_blocks(sub_cfg, st, act, stats["touched_blocks"])
        mo = mc_ops.extract_mesh(sub_cfg, DRONE_TRIANGLES, 1, DRONE_MESH_CAP,
                                 st, act, sub_cfg.tsdf_surface_thres,
                                 block_mask=dil)
        patch = dict(vertices=mo["vertices"], counts=torch.stack(
            [mo["num_triangles"], mo["surface_blocks_dropped"],
             torch.clamp(mo["total_triangles"] - mo["num_triangles"],
                         min=0)]).to(torch.int32))
        out.append(drone_summary(sub_cfg, life, patch))
        g, fst = fusion_ops.fuse_submaps(
            sub_cfg, glob_cfg, DRONE_FUSE_BLOCKS, g, st,
            torch.from_numpy(life["base_R"]).to(dev),
            torch.from_numpy(life["base_T"]).to(dev))
        require(int(fst["fuse_dropped"]) == 0 and
                int(fst["fuse_tiles_dropped"]) == 0, f"drone {d}: fuse drops")
        del life, st
    return out, g


def drones_phase(dev, smi, frames, launches):
    """Phase 20: 4 drones as 4 gloo ranks sharing the card, with the launch
    file's submap and global configurations (untextured, 10 cm, V = 16:
    what SubmapMapping builds from the node's get_submap_opts and
    get_sdf_opts), each flying its own offset orbit for 20 frames through
    the lifecycle step (keyframe_step 10, ESDF budget 6, mesh patch), then
    the all-drone fuse; held against the same drones run one after another
    through the single-device ops and fuse_submaps on the card."""
    import torch
    from taichislam_tpu_torch.parallel.mesh import spawn_mesh
    core, _ = make_node(torch.device("cpu"), DRONE_PARAMS)
    sub_cfg = core.mapping.submap_collection.cfg
    glob_cfg = core.mapping.global_map.cfg
    del core
    gnb = glob_cfg.grid.max_blocks + 1
    V3 = glob_cfg.grid.voxels_per_block
    log(f"[phase20] configurations: submaps {sub_cfg.map_scale} m at "
        f"{sub_cfg.voxel_scale} m, V = {sub_cfg.grid.V}, {sub_cfg.max_blocks} "
        f"blocks x {sub_cfg.max_submap_num} submaps; global "
        f"{glob_cfg.map_scale} m, {glob_cfg.max_blocks} blocks; the fuse "
        f"sums 3 dense accumulators (untextured) of {gnb} x {V3} x 4 B = "
        f"{3 * gnb * V3 * 4 / 2**20:.1f} MiB per rank (reckoned)")
    t0 = time.perf_counter()
    res = spawn_mesh(drone_rank, DRONES, backend="gloo", device=dev,
                     args=(sub_cfg, glob_cfg, frames), axis="drone",
                     store_dir=OUT_DIR, threads=2)
    wall = time.perf_counter() - t0
    tot = {k: sum(o["launches"][k] for o in res) for k in ("K1", "K2", "K3")}
    fusion = sum(o["sites"].get("fusion", 0) for o in res)
    for o in res:
        for k, v in o["launches"].items():
            launches[k] += v
    require(tot["K1"] > 0 and tot["K3"] > 0 and fusion > 0,
            f"drones: launches {tot}, K1 at fusion {fusion}")
    for r, o in enumerate(res):
        st = np.array(o["stats"])
        require(int(st[:, 1].max()) == 0 and int(st[:, 3:].max()) == 0,
                f"drone {r}: ESDF overflow or mesh drops {st.tolist()}")
        require(int(st[:, 0].min()) > 0 and int(st[-1, 2]) > 0,
                f"drone {r}: no sweeps or no triangles")

    # the same drones one after another through the single-device ops
    want, g = sequential_drones(dev, sub_cfg, glob_cfg, frames)
    err = dict(TSDF=0.0, W_TSDF=0.0, esdf=0.0, vertices=0.0)
    for d, o in enumerate(res):
        have = o["summary"]
        for k in ("num_blocks", "active", "table_idx", "table_val",
                  "TSDF_observed", "occupy", "fixed", "pending", "counts",
                  "base_R", "base_T"):
            require(np.array_equal(np.asarray(want[d][k]),
                                   np.asarray(have[k])),
                    f"drone {d}: {k} differs from the sequential run")
        for k in err:
            err[k] = max(err[k], float(np.abs(want[d][k] - have[k]).max(
                initial=0.0)))
    require(all(v == 0.0 for v in err.values()),
            f"drones against the sequential run: max abs {err}")
    gl = res[0]["summary"]["global"]
    require(all(o["summary"]["global"] == gl for o in res),
            "drones: the fused global maps differ between ranks")
    want_sum = float(g.channels["TSDF"].double().sum())
    want_obs = int((g.channels["TSDF_observed"] > 0).sum())
    require(gl["num_blocks"] == int(g.num_blocks) and
            gl["observed"] == want_obs and
            abs(gl["tsdf_sum"] - want_sum) <= 1e-4 * abs(want_sum),
            f"drones: fused {gl} against sequential fuse_submaps "
            f"{int(g.num_blocks)} blocks, {want_obs} observed, TSDF sum "
            f"{want_sum}")
    ms = np.array([o["ms"] for o in res])
    log(f"[phase20] {DRONES} drones as gloo ranks on one card ({wall:.1f} s "
        f"with the spawn): launches summed {tot} (K1 at fusion {fusion}); "
        f"each drone's state, ESDF, flags, pending and mesh patch equal the "
        f"sequential single-device run exactly; fused global {gl} against "
        f"sequential fuse_submaps ({int(g.num_blocks)} blocks, {want_obs} "
        f"observed, TSDF sum {want_sum})")
    log(f"[phase20] lifecycle step ms per drone (mean) "
        f"{np.round(ms.mean(1), 3).tolist()}, over all {ms.mean():.3f}; "
        f"fuse ms {[round(o['fuse_ms'], 3) for o in res]}, of which "
        f"collectives {[round(o['fuse_coll_ms'], 3) for o in res]}; fuse "
        f"collective "
        f"payload {res[0]['fuse_bytes'] / 2**20:.1f} MiB per rank; peak "
        f"{[round(o['peak'] / 2**20, 1) for o in res]} MiB ({smi})")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from taichislam_tpu_torch.ops.kernels import build
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    from taichislam_tpu_torch.utils.synthetic_scene import orbit_sequence

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1 ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[phase1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"[phase1] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    build_report()

    # ---- phase 2 ----------------------------------------------------------
    results = {}
    check_seg_accum(dev, results)
    check_esdf(dev, results)

    # ---- phase 3 ----------------------------------------------------------
    t0 = time.perf_counter()
    depth, Rs, Ts, K = orbit_sequence(n_frames=N_FRAMES, noise_mm=3.0)
    log(f"[phase3] rendered {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")

    def upload(d):
        return ([torch.from_numpy(x.astype(np.int32)).to(d) for x in depth],
                [torch.from_numpy(x).to(d) for x in Rs],
                [torch.from_numpy(x).to(d) for x in Ts],
                torch.from_numpy(K).to(d))
    frames = upload(dev)
    cfg, cap, _ = size_capacities(bench_config(), frames, dev, 256, 3)
    cfg1, cap1, _ = size_capacities(cfg, frames, dev, cap, 1)
    log(f"[phase3] sized: max_bins {cfg.max_bins} max_march_lanes "
        f"{cfg.max_march_lanes} max_touched_blocks {cfg.max_touched_blocks} "
        f"esdf_cap {cap}")
    k1.segmented_block_reduce.launches = 0
    ks.esdf_sweep.launches = 0
    ks.esdf_sweep_loop.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, esdf, fixed, part, pf3 = run_frames(cfg, frames, dev, cap, 3)
    *_, pf1 = run_frames(cfg1, frames, dev, cap1, 1)
    torch.cuda.synchronize()
    launches = {"K1": k1.segmented_block_reduce.launches,
                "K2": ks.esdf_sweep.launches,
                "K3": ks.esdf_sweep_loop.launches}
    log(f"[phase3] launches during the main path: {launches}")
    for k, v in launches.items():
        require(v > 0, f"{k} was not launched on the main path")
    for pf, name in ((pf3, "budget 3"), (pf1, "budget 1")):
        require(int(pf[:, :3].max()) == 0, f"capacity drops ({name})")
    require(bool(torch.isfinite(esdf[part]).all()), "ESDF not finite")
    n_obs = int(part.sum())
    require(n_obs > 0, "empty map")
    log(f"[phase3] blocks {int(state.num_blocks)} observed voxels {n_obs} "
        f"sweeps/frame {pf3[:, 5].tolist()} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    phase3_ms = {}
    for name, c, cp, b in (("fusion+esdf budget 3", cfg, cap, 3),
                           ("fusion+esdf budget 1", cfg1, cap1, 1),
                           ("fusion only", cfg, cap, 0)):
        ms = cuda_ms(lambda: run_frames(c, frames, dev, cp, b), 3) / N_FRAMES
        phase3_ms[name] = ms
        log(f"[phase3] {name}: {ms:.3f} ms/frame ({smi})")
    ev = []
    run_frames(cfg, frames, dev, cap, 3, stages=ev)
    torch.cuda.synchronize()
    per = np.array([a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])])
    per = per[np.arange(len(per)) % 4 != 3].reshape(N_FRAMES, 3).mean(0)
    log(f"[phase3] budget 3 per stage, ms/frame: integrate {per[0]:.3f} "
        f"seed_dirty {per[1]:.3f} esdf_update {per[2]:.3f} ({smi})")

    # ---- phase 4 ----------------------------------------------------------
    torch.set_num_threads(8)
    cpu = torch.device("cpu")
    g_state, g_esdf, _, g_part, g_pf = run_frames(cfg, frames, dev, cap, 3,
                                                  n=CPU_FRAMES)
    c_state, c_esdf, _, c_part, c_pf = run_frames(cfg, upload(cpu), cpu, cap,
                                                  3, n=CPU_FRAMES)
    require(int(g_state.num_blocks) == int(c_state.num_blocks), "num_blocks")
    require(torch.equal(g_state.table.cpu(), c_state.table), "block table")
    require(torch.equal(g_state.channels["TSDF_observed"].cpu(),
                        c_state.channels["TSDF_observed"]), "observed")
    e_tsdf = float((g_state.channels["TSDF"].cpu().float() -
                    c_state.channels["TSDF"].float()).abs().max())
    require(e_tsdf <= 4e-3, f"TSDF card vs CPU {e_tsdf}")
    require(torch.equal(g_part.cpu(), c_part), "ESDF observed mask")
    e_esdf = float((g_esdf.cpu() - c_esdf)[c_part].abs().max())
    require(e_esdf <= 4e-3, f"ESDF card vs CPU {e_esdf}")
    require(np.array_equal(g_pf[:, 5], c_pf[:, 5]), "sweep counts")
    log(f"[phase4] card vs CPU over {CPU_FRAMES} frames: TSDF max abs "
        f"{e_tsdf} ESDF max abs {e_esdf} sweeps {g_pf[:, 5].tolist()}")

    # ---- phase 5 ----------------------------------------------------------
    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    before = (k1.segmented_block_reduce.launches,
              ks.esdf_sweep_loop.launches)
    m = DenseESDF(map_scale=[10, 10], voxel_scale=0.05, max_ray_length=3.0,
                  max_blocks=2048, max_bins=8192, max_submap_num=64,
                  storage_dtype="float16", esdf_dense_max_voxels=0,
                  max_esdf_sweeps=3, esdf_raise_slack_voxels=0.5,
                  device=dev)
    m.set_dep_camera_intrinsic(K)
    for f in range(4):
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
    n_act = m.count_active()
    require(n_act > 0, "model map empty")
    require(bool(torch.isfinite(m.esdf[m.esdf_observed]).all()),
            "model ESDF not finite")
    require(k1.segmented_block_reduce.launches > before[0] and
            ks.esdf_sweep_loop.launches > before[1], "model kernels")
    log(f"[phase5] DenseESDF: {n_act} active voxels, last sweeps "
        f"{m.last_esdf_sweeps}, last dirty {m.last_esdf_dirty}")

    # ---- phases 6-7 ------------------------------------------------------
    depth_n, Rs_n, Ts_n, _ = orbit_sequence(n_frames=N_FRAMES, K=KDEPTH,
                                            noise_mm=3.0)
    texs = textures(N_FRAMES)
    node_map, node_loaded, node_path = node_phase(
        dev, smi, (depth_n, Rs_n, Ts_n), texs, launches)
    node_cpu_phase(dev, (depth_n, Rs_n, Ts_n), texs)

    # ---- phases 8-10 -----------------------------------------------------
    t0 = time.perf_counter()
    sub_frames = orbit_sequence(n_frames=SUB_FRAMES, K=KDEPTH,
                                noise_mm=3.0)[:3]
    sub_texs = textures(SUB_FRAMES)
    log(f"[phase8] rendered {SUB_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    submap_phase(dev, smi, sub_frames, sub_texs, launches, results)
    octo_phase(dev, smi, sub_frames, sub_texs)
    submap_cpu_phase(dev, sub_frames, sub_texs)

    # ---- phases 11-14 ----------------------------------------------------
    seed = topo_phase(dev, smi, node_map)
    topo_cpu_phase(dev, node_loaded, node_path, seed)
    node_path.unlink()
    del node_map, node_loaded
    v24_phase(dev, (depth_n, Rs_n, Ts_n), texs, launches)
    opti_phase(dev, smi)

    # ---- phases 15-18 ----------------------------------------------------
    t0 = time.perf_counter()
    node_core_phase(dev, smi, (depth_n, Rs_n, Ts_n), texs, launches)
    launch_node_phase(dev, smi, sub_frames, launches)
    entry_points_phase(smi)
    sequence_phase(dev, (depth_n, Rs_n, Ts_n), texs)
    log(f"[phase18] phases 15-18 took {time.perf_counter() - t0:.1f} s")

    # ---- phases 19-20 ----------------------------------------------------
    t0 = time.perf_counter()
    sharded_phase(dev, smi, (depth, Rs, Ts, K), cfg, launches)
    drones_phase(dev, smi, sub_frames, launches)
    log(f"[phase20] phases 19-20 took {time.perf_counter() - t0:.1f} s")

    # ---- phase 21 --------------------------------------------------------
    c3_phase(dev, smi, launches)

    # ---- phases 22-23 ----------------------------------------------------
    bench_phase(dev, smi, launches, phase3_ms["fusion+esdf budget 3"])
    t0 = time.perf_counter()
    tools_phase(smi)
    log(f"[phase23] took {time.perf_counter() - t0:.1f} s")

    src = "taichislam_tpu_torch/csrc/"
    table = [("seg_accum (K1)", "K1", src + "seg_accum.cu",
              "taichislam_tpu/ops/pallas/seg_accum.py:153"),
             ("esdf_sweep (K2)", "K2", src + "esdf_sweep.cu",
              "taichislam_tpu/ops/pallas/esdf_sweep.py:588"),
             ("esdf_sweep_loop (K3)", "K3", src + "esdf_sweep.cu",
              "taichislam_tpu/ops/pallas/esdf_sweep.py:489")]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": path, "replaces": rep,
         "launches": launches[key], **results[key]}
        for name, key, path, rep in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
