#!/usr/bin/env python
"""Secondary benchmarks: fusion + per-frame incremental ESDF, and the
full-map marching cubes.

Counterpart of the repository's ``tools/bench_secondary.py`` over the
port's ops. A 1024-block map (10 x 10 m at 5 cm, V = 16, max ray 3 m) is
built from 10 frames of a sloped 640x480 depth plane (seed 0) swept
sideways, so that the map is much larger than one frustum; then the cold
ESDF (96 sweeps on every block, cap 512). Timed: one frame of fusion plus
a warm ESDF update (8 sweeps) over the full-warm working set (cap 512) and
over the frame's dirty blocks (cap 128), each from the same map and field;
and the full-map marching cubes.

Timing (:func:`timed`): ``k`` back-to-back calls between two CUDA events,
the best of 3 runs, at two values of ``k``; the difference over the
difference in ``k`` is the per-call time, free of the fixed costs around
the calls (the JAX tool's K-scan differencing). Each fusion call first
writes the map and the field back from their copies in place: 63 MB read
and written, about 0.04 ms at the card's HBM rate, inside the per-frame
time.

Run:  python -m taichislam_tpu_torch.tools.bench_secondary [--cpu]
"""

import argparse

import numpy as np
import torch


def timed(fn, dev, k_lo=2, k_hi=6, reps=3):
    """Per-call ms of ``fn()`` by differencing ``k_hi`` and ``k_lo``
    back-to-back calls (CUDA events on the card, the host clock on the
    CPU), the best of ``reps`` runs each after one warm run."""
    from taichislam_tpu_torch.bench import timed as timed_once

    def run(k):
        for _ in range(k):
            fn()

    def best(k):
        timed_once(dev, lambda: run(k))
        return min(timed_once(dev, lambda: run(k))[0] for _ in range(reps))
    return (best(k_hi) - best(k_lo)) / (k_hi - k_lo)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    from taichislam_tpu_torch.core.config import TSDFConfig
    from taichislam_tpu_torch.core.device import resolve_device
    from taichislam_tpu_torch.core.grid import clone_state, copy_state_
    from taichislam_tpu_torch.ops import esdf as esdf_ops
    from taichislam_tpu_torch.ops import marching_cubes as mc_ops
    from taichislam_tpu_torch.ops import tsdf as tsdf_ops
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = TSDFConfig(map_scale=(10., 10.), voxel_scale=0.05,
                     num_voxel_per_blk_axis=16, max_ray_length=3.0,
                     min_ray_length=0.3, recast_step=2, max_blocks=1024,
                     max_bins=5120, max_submap_num=64)
    state = tsdf_ops.make_tsdf_state(cfg, device=dev)
    h, w = 480, 640
    K = torch.tensor([384., 0, 320., 0, 384., 240., 0, 0, 1],
                     dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = torch.as_tensor(np.clip(1500 + 0.6 * ii + 0.3 * jj +
                                    rng.normal(0, 5, (h, w)), 400,
                                    2900).astype(np.uint16).astype(np.int32),
                            device=dev)
    R = torch.eye(3, dtype=torch.float32, device=dev)
    T = torch.zeros(3, dtype=torch.float32, device=dev)
    # sweep the camera sideways so the map is much larger than one frustum
    # (the regime per-frame incremental ESDF exists for)
    for k in range(10):
        Tk = torch.tensor([0.0, 0.8 * k, 0.0], dtype=torch.float32,
                          device=dev)
        tsdf_ops.integrate_depth(cfg, state, depth, None, R, Tk, K, K, 0)
    print(f"map blocks: {int(state.num_blocks)} ({dev})", flush=True)

    shape = (cfg.grid.max_blocks + 1, cfg.grid.voxels_per_block)
    FULL_CAP = 512
    esdf0 = torch.zeros(shape, device=dev)
    fixed0 = torch.zeros(shape, dtype=torch.int8, device=dev)
    _, _, _, sweeps, _, _ = esdf_ops.esdf_update(cfg, 96, FULL_CAP, state,
                                                 esdf0, fixed0, 0)
    print(f"cold ESDF sweeps: {int(sweeps)}", flush=True)

    # fusion + per-frame ESDF: full-warm working set vs dirty-block set,
    # each call from the same map and field
    map0 = clone_state(state)
    work = clone_state(state)
    esdf, fixed = esdf0.clone(), fixed0.clone()

    def make_fused(cap, use_dirty):
        def fused_frame():
            copy_state_(work, map0)
            esdf.copy_(esdf0)
            fixed.copy_(fixed0)
            _, stats = tsdf_ops.integrate_depth(cfg, work, depth, None, R, T,
                                                K, K, 0)
            dirty = stats["touched_blocks"] if use_dirty else None
            esdf_ops.esdf_update(cfg, 8, cap, work, esdf, fixed, 0, dirty)
        return fused_frame

    for label, cap, use_dirty in (("full-warm", FULL_CAP, False),
                                  ("dirty-block", 128, True)):
        ms = timed(make_fused(cap, use_dirty), dev)
        print(f"fusion + warm ESDF [{label}, cap={cap}]: {ms:.2f} ms/frame "
              f"({1000.0 / ms:.1f} fps)", flush=True)

    # marching cubes over the full map (cap bucketed as the model does)
    cap = 64
    while cap < int(state.num_blocks) + 1:
        cap *= 2

    def mesh():
        return mc_ops.extract_mesh(cfg, 1 << 17, 1, cap, state, 0, 0.1)

    ms = timed(mesh, dev, k_lo=1, k_hi=4)
    out = mesh()
    print(f"marching cubes (full map, cap={cap}, "
          f"{int(out['num_triangles'])} triangles): {ms:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
