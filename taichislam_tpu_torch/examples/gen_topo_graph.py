#!/usr/bin/env python
"""Topology skeleton-graph generation harness + benchmark over the port.

Counterpart of the JAX package's ``examples/gen_topo_graph.py``: load a
saved TSDF map (``--map path/to/map.npy``, the DenseTSDF.saveMap format) or
synthesize a box room, generate the skeleton graph, and optionally
micro-benchmark node expansion (``--benchmark --run_num N``), timing
detect_collisions and convex-hull generation. Runs on the CUDA card unless
``--cpu`` asks for the CPU.

Run:  python -m taichislam_tpu_torch.examples.gen_topo_graph [--benchmark]
          [--run_num N] [--cpu]
"""

import argparse
import time

import numpy as np


def synthetic_room(voxel=0.1, half_m=1.2, device=None):
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    m = DenseTSDF(map_scale=[6.4, 6.4], voxel_scale=voxel,
                  num_voxel_per_blk_axis=8, max_blocks=2048,
                  max_submap_num=4, max_ray_length=3.0, device=device)
    half = int(half_m / voxel)
    r = np.arange(-half, half + 1)
    ii, jj, kk = np.meshgrid(r, r, r, indexing="ij")
    ijk = np.stack([ii, jj, kk], -1).reshape(-1, 3)
    p = ijk * voxel
    tsdf = (half_m - np.max(np.abs(p), axis=-1)).astype(np.float32)
    m.load_numpy(0, ijk, tsdf, np.ones_like(tsdf), np.zeros(len(tsdf)),
                 np.array([]))
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", type=str, default="",
                    help="saved map npy (DenseTSDF.saveMap format)")
    ap.add_argument("--start", nargs=3, type=float, default=[0.0, 0.0, 0.0])
    ap.add_argument("--max_nodes", type=int, default=100)
    ap.add_argument("--coll_det_num", type=int, default=128)
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--run_num", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    np.random.seed(1)
    device = "cpu" if args.cpu else None

    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.topo_graph import TopoGraphGen

    if args.map:
        mapping = DenseTSDF.loadMap(args.map, device=device)
    else:
        print("no --map given; using the synthetic box room")
        mapping = synthetic_room(device=device)

    topo = TopoGraphGen(mapping, coll_det_num=args.coll_det_num,
                        max_raycast_dist=2.0)
    if args.benchmark:
        topo.node_expansion_benchmark(args.start, run_num=args.run_num)
        return topo

    s = time.time()
    n = topo.generate_topo_graph(np.asarray(args.start, np.float32),
                                 max_nodes=args.max_nodes)
    print(f"[Topo] {n} nodes, {topo.num_facelets} facelets, "
          f"{len(topo.edges)} edges in {(time.time()-s)*1000:.1f}ms")
    return topo


if __name__ == "__main__":
    main()
