#!/usr/bin/env python
"""Run the five benchmark configurations of BASELINE.json and print a
table.

Counterpart of the repository's ``tools/bench_configs.py`` over the port's
models, with the same models, options and settings. The fixtures are the
D435-like orbit sequence and its saved map from ``gen_fixtures`` (under
``build/fixtures/``).

  1. marching-cubes mesh extraction from the saved map
  2. octomap-style occupancy fusion on the depth sequence
  3. voxblox-style TSDF fusion + per-frame incremental ESDF on the
     sequence: the per-call deferred path (verdicts every 8 frames) and
     the windowed path (20 frames a window, ``recast_depth_sequence``)
  4. voxgraph-style submap mapping (allocation, fusion, submap finalize on
     a worker thread, the global fuse and its mesh)
  5. the topological skeleton graph on config 3's map

Each timing is host wall time closed by ``torch.cuda.synchronize()`` on
the card. Every configuration first runs its own warm passes: they settle
the capacity buckets and capture the sequences' CUDA graphs, so that the
timed pass is steady state.

Run:  python -m taichislam_tpu_torch.tools.bench_configs [--frames 40]
          [--cpu] [--quick] [--only 3,5]
(--quick takes at most 6 frames at a quarter of the resolution; timing
still prints.)
"""

import argparse
import dataclasses
import time

import numpy as np
import torch


def _run_voxgraph_once(SubmapMapping, DenseTSDF, opts, K, n, depth_dev,
                       Rs, Ts, eye, device=None):
    """One full config-4 pass: a fresh SubmapMapping on ``device``, the
    windowed ingest with async keyframe finalize, full wire delivery
    (sync)."""
    sm = SubmapMapping(DenseTSDF, keyframe_step=max(2, n // 4),
                       async_finalize=True,
                       sub_opts=dict(opts, max_submap_num=64,
                                     max_disp_particles=1 << 18),
                       global_opts=dict(opts, max_blocks=2048,
                                        max_disp_particles=1 << 18),
                       device=device)
    sm.set_dep_camera_intrinsic(K)
    for sub in (sm.submap_collection, sm.global_map):
        sub.capacity_check_interval = 8
    # recorded steady-state bin bucket of this sequence (worst window ~8.8k
    # bins): seeding skips the first window's grow-and-redo; the zero-drop
    # verdicts still correct it if the scene or kernels change
    sm.submap_collection._bin_bucket = min(
        12288, sm.submap_collection.cfg.max_bins)
    sm.recast_depth_sequence(
        (i, True, (eye, Ts[i]), (Rs[i], np.zeros(3, np.float32)),
         depth_dev[i], None) for i in range(n))
    sm.sync()   # the fps row includes full wire delivery
    return sm


def wall(fn, sync, reps=3, warms=1):
    """Best host wall seconds of ``reps`` calls of ``fn`` after ``warms``
    warm calls, each closed by ``sync()``; and the last result."""
    for _ in range(warms):
        fn()
    sync()
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes for a smoke run")
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated config numbers to run "
                    "(e.g. --only 3,5; 5 implies 3: it reuses its map)")
    args = ap.parse_args(argv)
    only = set(int(x) for x in args.only.split(",") if x)
    if 5 in only:
        only.add(3)

    def want(k):
        return not only or k in only

    from taichislam_tpu_torch.core.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else None)
    if args.quick:
        args.frames = min(args.frames, 6)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []

    def row(config, metric, value, detail=""):
        rows.append((config, metric, value, detail))
        print(f"  -> {config}: {metric} = {value} {detail}", flush=True)

    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
    from taichislam_tpu_torch.models.octomap import Octomap
    from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
    from taichislam_tpu_torch.models.topo_graph import TopoGraphGen
    from taichislam_tpu_torch.tools.gen_fixtures import (ensure_map,
                                                         ensure_sequence)

    seq = ensure_sequence(args.frames)
    with np.load(seq) as z:
        depth, Rs, Ts, K = z["depth"], z["Rs"], z["Ts"], z["K"]
    if args.quick:
        depth = depth[:, ::4, ::4]
        K = K / 4.0
        K[8] = 1.0
    n = len(depth)
    base_opts = dict(map_scale=[10.0, 10.0], voxel_scale=0.05,
                     max_ray_length=5.1, min_ray_length=0.3,
                     max_blocks=4096, device=dev)
    opts = dict(base_opts, num_voxel_per_blk_axis=16, max_bins=32768)
    sub_opts = {k: v for k, v in opts.items() if k != "device"}

    # the depth sequence is staged on the device ONCE, outside the timed
    # loops (the reference times bag decoding apart from mapping); the
    # models take device-resident frames without copying
    depth_dev = torch.as_tensor(depth.astype(np.int32), device=dev)
    eye = np.eye(3, dtype=np.float32)

    # ---- config 1: marching cubes from the saved map ------------------------
    if want(1):
        m = DenseTSDF.loadMap(ensure_map(args.frames, device=dev),
                              device=dev)
        mesher = MarchingCubeMesher(m, max_triangles=1 << 19)

        def mesh_full():
            # the incremental mesher no-ops on a clean map; each rep must
            # time a real full extraction
            m._mark_mesh_dirty_full()
            mesher.generate_mesh(1)
        t, _ = wall(mesh_full, sync)
        row("1 marching-cubes (saved map)", "ms/extraction",
            round(t * 1000, 2), f"({mesher.num_facelets} triangles, "
            f"{m.count_active()} voxels)")

    # ---- config 2: octomap occupancy fusion ---------------------------------
    if want(2):
        octo = Octomap(K=2, min_occupy_thres=2, **base_opts)
        octo.set_dep_camera_intrinsic(K)

        def run_octo():
            for i in range(n):
                octo.recast_depth_to_map(Rs[i], Ts[i], depth_dev[i], None)
        t, _ = wall(run_octo, sync, reps=1)
        row("2 octomap fusion (D435-like seq)", "fps", round(n / t, 1),
            f"({n} frames 640x480)" if not args.quick else f"({n} frames)")

    # ---- config 3: TSDF + per-frame incremental ESDF ------------------------
    # deferred verdicts: the per-call path reads its capacity verdicts
    # every 8 frames; production ESDF knobs (bench.py's primary uses the
    # same): budget-bounded sweeps with cross-frame re-queue, 0.5-voxel
    # raise hysteresis, 2 mm convergence eps
    if want(3):
        esdf = DenseESDF(max_submap_num=8, esdf_check_interval=8,
                         max_esdf_sweeps=8, esdf_raise_slack_voxels=0.5,
                         **opts)
        esdf.cfg = dataclasses.replace(esdf.cfg, esdf_converge_eps=2e-3)
        esdf.capacity_check_interval = 8
        esdf.set_dep_camera_intrinsic(K)

        def run_esdf():
            for i in range(n):
                esdf.recast_depth_to_map(Rs[i], Ts[i], depth_dev[i], None)
        # warms=2: pass 1 grows capacity buckets, pass 2 captures the
        # settled shapes; the timed rep must not hide a capture
        t, _ = wall(run_esdf, sync, reps=1, warms=2)
        row("3 TSDF + incremental ESDF (per-call)", "fps", round(n / t, 1),
            f"(per-frame ESDF, last {esdf.last_esdf_sweeps} sweeps)")

        # the same workload through the multi-frame ingest API
        # (ops/sequence.py): a window per call
        esdf_w = DenseESDF(max_submap_num=8, max_esdf_sweeps=8,
                           esdf_raise_slack_voxels=0.5, **opts)
        esdf_w.cfg = dataclasses.replace(esdf_w.cfg,
                                         esdf_converge_eps=2e-3)
        esdf_w.set_dep_camera_intrinsic(K)
        W = max(1, min(20, n))

        def run_esdf_seq():
            for i in range(0, n, W):
                esdf_w.recast_depth_sequence(Rs[i:i + W], Ts[i:i + W],
                                             depth_dev[i:i + W])
        t, _ = wall(run_esdf_seq, sync, reps=1, warms=2)
        row("3 TSDF + incremental ESDF (windowed)", "fps", round(n / t, 1),
            f"(window={W} frames/dispatch)")

    # ---- config 4: voxgraph-style submap mapping -----------------------------
    # incremental fuse: a keyframe finalize splats only the finished submap
    # into the global map; the frames between boundaries go through one
    # window each (ops/sequence.py); each pass builds a FRESH
    # SubmapMapping, whose buckets re-grow the same way
    if want(4):
        def run_voxgraph():
            return _run_voxgraph_once(SubmapMapping, DenseTSDF, sub_opts, K,
                                      n, depth_dev, Rs, Ts, eye, device=dev)
        t_ingest, sm = wall(run_voxgraph, sync, reps=1)
        row("4 voxgraph submap mapping", "fps ingest",
            round(n / t_ingest, 1), f"(submaps={len(sm.submaps)})")
        t_fuse, _ = wall(sm.local_to_global, sync)
        gmesher = MarchingCubeMesher(sm.global_map, max_triangles=1 << 17)

        def gmesh_full():
            sm.global_map._mark_mesh_dirty_full()
            gmesher.generate_mesh(1)
        t_mesh, _ = wall(gmesh_full, sync)
        row("4 voxgraph full fuse + global mesh", "ms",
            round(t_fuse * 1000, 1),
            f"(global mesh {t_mesh * 1000:.1f} ms / {gmesher.num_facelets} "
            "tris)")

    # ---- config 5: topology skeleton graph ----------------------------------
    if want(5):
        topo = TopoGraphGen(esdf, coll_det_num=64, max_raycast_dist=2.5)
        xyz, e = esdf.get_voxels_ESDF_slice(0.0)
        k = esdf.num_export_ESDF_particles
        seed = xyz[:k][np.argmax(e[:k])]

        def run_topo():
            topo.reset()
            return topo.generate_topo_graph(seed, max_nodes=16)
        t, nodes = wall(run_topo, sync, reps=1)
        row("5 topo skeleton graph", "ms", round(t * 1000, 1),
            f"({nodes} nodes, {topo.num_facelets} facelets, "
            f"{len(topo.edges)} edges)")

    print(f"\n== BASELINE.json configs ({dev}) ==")
    wid = max(len(r[0]) for r in rows)
    for c, metric, v, d in rows:
        print(f"{c:<{wid}}  {metric:>12} {v:>10}  {d}")
    return rows


if __name__ == "__main__":
    main()
