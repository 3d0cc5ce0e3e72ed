#!/usr/bin/env python
"""Serve a deterministic demo scene through the interactive viewer: a
particle ring, a sphere mesh from the real mesher, a drone triad, its
trajectory and one skeleton edge. It drives the WebGL page in a browser.

Counterpart of the repository's ``tools/viewer_demo_scene.py``, over the
port's ``utils/viewer_server.py``. The sphere map lives on the CUDA card
unless ``--cpu`` asks for the CPU; ``--port 0`` takes a free port.

Run:  python -m taichislam_tpu_torch.tools.viewer_demo_scene [--port 8765]
          [--seconds 600] [--cpu]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--seconds", type=float, default=600)
    ap.add_argument("--cpu", action="store_true",
                    help="build the sphere map on the CPU (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)

    from taichislam_tpu_torch.core.device import resolve_device
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
    from taichislam_tpu_torch.utils.viewer_server import InteractiveRender

    dev = resolve_device("cpu" if args.cpu else None)
    # sphere-fixture mesh through the real mesher
    m = DenseTSDF(map_scale=[6.4, 6.4], voxel_scale=0.1,
                  num_voxel_per_blk_axis=8, max_blocks=256,
                  max_disp_particles=65536, max_submap_num=4, device=dev)
    m.init_sphere()
    mesher = MarchingCubeMesher(m, max_triangles=1 << 15)
    mesher.generate_mesh(1)

    # particle ring around the sphere, jet-colored by angle
    th = np.linspace(0, 2 * np.pi, 4096, endpoint=False)
    par = np.stack([1.5 * np.cos(th), 1.5 * np.sin(th),
                    0.3 * np.sin(3 * th)], -1).astype(np.float32)
    col = np.stack([0.5 + 0.5 * np.cos(th), 0.5 + 0.5 * np.sin(th),
                    np.linspace(0, 1, len(th))], -1).astype(np.float32)

    r = InteractiveRender(port=args.port)
    try:
        r.set_particles(par, col)
        n = mesher.num_facelets * 3
        r.set_mesh(mesher.mesh_vertices[:n], mesher.mesh_colors[:n],
                   mesher.mesh_normals[:n])
        r.set_drone_pose(0, np.eye(3, dtype=np.float32),
                         np.array([0, -2.0, 0.5], np.float32))
        traj = np.stack([np.linspace(-2, 0, 50),
                         np.full(50, -2.0), np.full(50, 0.5)], -1)
        r.set_drone_trajectory(0, traj.astype(np.float32))
        r.skeleton_edges[0] = np.array([[0, 0, 1.5], [1.5, 0, 0]],
                                       np.float32)
        r.rendering()
        print(f"[viewer-demo] serving {r.server.url} "
              f"(mesh tris {mesher.num_facelets}, particles {len(par)})",
              flush=True)
        time.sleep(args.seconds)
    finally:
        r.close()


if __name__ == "__main__":
    main()
