#!/usr/bin/env python
"""SDF fidelity check: the port's fusion against the reference's math.

Counterpart of the repository's ``tools/compare_vs_reference.py``. Replays
a synthetic depth sequence (64 x 48 frames, a 6.4 m map at 0.1 m, V = 8)
through (a) the port's ``DenseTSDF`` and (b) ``reference_math.RefTSDF``, an
independent numpy model of the reference's sequential voxblox update, and
reports SDF agreement: the benchmark's "SDF values comparable to the
reference" requirement. PASS when the mean error is under 1e-4, the 99th
percentile under 1e-3, the largest under half a centimetre and the
observed sets differ in at most 1 % of the reference's voxels.

Run:  python -m taichislam_tpu_torch.tools.compare_vs_reference
          [--frames 3] [--cpu]
Exit code 0 on PASS, 1 on FAIL.
"""

import argparse
import sys

import numpy as np

K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
MAP_OPTS = dict(map_scale=[6.4, 6.4], voxel_scale=0.1,
                num_voxel_per_blk_axis=8, max_ray_length=2.0,
                min_ray_length=0.3, max_blocks=512, max_bins=8192,
                max_disp_particles=65536, max_submap_num=8)


def frames(n_frames):
    """The sequence: (depth u16 (48, 64), R, T) per frame, with the pixels
    that sit on a voxel-rounding boundary zeroed."""
    from taichislam_tpu_torch.tools.reference_math import \
        mask_boundary_pixels
    jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    R = np.eye(3, dtype=np.float32)
    out = []
    for t in range(n_frames):
        depth = (1000 + 15 * t + 4.0 * ii + 2.0 * jj).astype(np.uint16)
        depth = mask_boundary_pixels(depth, K, R)
        T = np.array([0.053 * t, -0.017, 0.111], np.float32)
        out.append((depth, R, T))
    return out


def port_sdf(seq, device=None):
    """{voxel index tuple: SDF} of the port's DenseTSDF over ``seq``."""
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    m = DenseTSDF(**MAP_OPTS, device=device)
    m.set_dep_camera_intrinsic(K)
    for depth, R, T in seq:
        m.recast_depth_to_map(R, T, depth, None)
    idx, tsdf, _, _, _ = m.to_numpy()
    return {tuple(int(x) for x in i): float(v) for i, v in zip(idx, tsdf)}


def reference_sdf(seq):
    """{voxel index tuple: SDF} of the reference math over ``seq``."""
    from taichislam_tpu_torch.tools.reference_math import RefTSDF
    ref = RefTSDF(voxel=0.1, max_ray=2.0, min_ray=0.3, internal=10,
                  recast_step=2)
    for depth, R, T in seq:
        ref.integrate_depth(depth, K, R, T)
    return {tuple(int(x) for x in k): float(v) for k, v in ref.D.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    from taichislam_tpu_torch.core.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else None)

    seq = frames(args.frames)
    D = port_sdf(seq, dev)
    refD = reference_sdf(seq)
    common = set(D) & set(refD)
    sym = set(D) ^ set(refD)
    errs = np.array([abs(D[k] - refD[k]) for k in common])
    print(f"frames:            {args.frames} ({dev})")
    print(f"observed voxels:   ours {len(D)}, reference {len(refD)}, "
          f"symmetric diff {len(sym)} "
          f"({100.0 * len(sym) / max(len(refD), 1):.2f}%)")
    print(f"SDF abs error on common voxels: max {errs.max():.2e}  "
          f"mean {errs.mean():.2e}  p99 {np.percentile(errs, 99):.2e}")
    # mean/p99 must be fp-tight; the max tolerates the known ±1-voxel
    # ray-tail rounding flips (a single update's worth on a boundary voxel)
    ok = (errs.mean() < 1e-4 and np.percentile(errs, 99) < 1e-3 and
          errs.max() < 0.05 * 0.1 and len(sym) <= 0.01 * len(refD))
    print("FIDELITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
