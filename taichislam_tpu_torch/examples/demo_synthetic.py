#!/usr/bin/env python
"""End-to-end synthetic demo over the PyTorch port, without ROS.

Counterpart of the JAX package's ``examples/demo_synthetic.py``: simulates a
depth camera inside a box room, feeds frames through SubmapMapping (TSDF
submaps + voxgraph-style global fusion + PGO chaining), extracts a mesh,
computes the ESDF, optionally runs the topological skeleton generator, and
(two-drone mode) exchanges submaps over the loopback comm. Runs on the CUDA
card unless ``--cpu`` asks for the CPU.

Run:  python -m taichislam_tpu_torch.examples.demo_synthetic [--frames 12]
          [--topo] [--two-drones] [--cpu]
"""

import argparse
import time

import numpy as np


def render_depth_box(R, T, K, h, w, room=3.0, step=1):
    """Ray-march a depth image of an axis-aligned box room of half-size
    ``room`` centered at the origin (camera looks along +z of its frame)."""
    fx, cx, fy, cy = K[0], K[2], K[4], K[5]
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs = np.stack([(ii - cx) / fx, (jj - cy) / fy, np.ones_like(ii)], -1)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_w = dirs @ R.T
    # distance to each wall plane x=±room, y=±room, z=±room
    t_best = np.full((h, w), np.inf)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            denom = dirs_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sign * room - T[axis]) / denom
            ok = (t > 0.05) & np.isfinite(t)
            p = T + dirs_w * t[..., None]
            other = [a for a in range(3) if a != axis]
            inside = (np.abs(p[..., other[0]]) <= room + 1e-6) & \
                     (np.abs(p[..., other[1]]) <= room + 1e-6)
            cand = np.where(ok & inside, t, np.inf)
            t_best = np.minimum(t_best, cand)
    depth_z = t_best * dirs[..., 2]  # project onto camera z (pinhole depth)
    mm = np.where(np.isfinite(depth_z), depth_z * 1000.0, 0.0)
    return np.clip(mm, 0, 65535).astype(np.uint16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--topo", action="store_true")
    ap.add_argument("--two-drones", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
    from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
    from taichislam_tpu_torch.utils.comm import (
        CHANNEL_SUBMAP, CHANNEL_TRAJ, LoopbackTransport, SLAMComm)

    h, w = 120, 160
    K = np.array([100.0, 0, 80.0, 0, 100.0, 60.0, 0, 0, 1], np.float32)
    sub_opts = dict(map_scale=[10, 10], voxel_scale=0.1,
                    num_voxel_per_blk_axis=8, max_ray_length=4.5,
                    min_ray_length=0.3, max_blocks=4096, max_bins=16384,
                    max_disp_particles=1 << 18, max_submap_num=64,
                    max_fuse_voxels=1 << 18)
    glob_opts = dict(map_scale=[12.8, 12.8], voxel_scale=0.1,
                     num_voxel_per_blk_axis=8, max_blocks=8192,
                     max_disp_particles=1 << 18, is_global_map=True,
                     max_fuse_voxels=1 << 18)

    def make_sm():
        sm = SubmapMapping(DenseTSDF, keyframe_step=4, sub_opts=sub_opts,
                           global_opts=glob_opts, device=device)
        sm.set_dep_camera_intrinsic(K)
        return sm

    sm = make_sm()
    comm_a = comm_b = sm_b = None
    if args.two_drones:
        hub = LoopbackTransport.Hub()
        comm_a = SLAMComm(0, transport=LoopbackTransport(hub))
        comm_b = SLAMComm(1, transport=LoopbackTransport(hub))
        sm_b = make_sm()
        sm.map_send_handle = lambda buf: comm_a.publishBuffer(
            buf, CHANNEL_SUBMAP)
        sm.traj_send_handle = lambda buf: comm_a.publishBuffer(
            buf, CHANNEL_TRAJ)
        comm_b.on_submap = sm_b.input_remote_submap
        comm_b.on_traj = sm_b.input_remote_traj

    eye = np.eye(3, dtype=np.float32)
    t_all = time.time()
    for f in range(args.frames):
        th = 2 * np.pi * f / max(args.frames, 1) * 0.5
        Rz = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0],
                       [0, 0, 1]], np.float32)
        # camera z-axis looks along world x rotated by theta
        Rcam = Rz @ np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32).T
        T = np.array([0.3 * np.cos(th), 0.3 * np.sin(th), 0.0], np.float32)
        s = time.time()
        depth = render_depth_box(Rcam, T, K, h, w)
        t_render = time.time() - s
        s = time.time()
        sm.recast_depth_to_map_by_frame(f, True, (eye, T),
                                        (Rcam, np.zeros(3, np.float32)),
                                        depth, None)
        t_recast = time.time() - s
        print(f"[demo] frame {f} render {t_render*1000:.1f}ms "
              f"recast {t_recast*1000:.1f}ms "
              f"active voxels {sm.submap_collection.count_active()}")

    print(f"[demo] integrated {args.frames} frames in "
          f"{(time.time()-t_all)*1000:.0f}ms; "
          f"submaps={len(sm.submaps)}")

    sm.local_to_global()
    s = time.time()
    sm.set_exporting_global()
    sm.cvt_TSDF_surface_to_voxels()
    print(f"[demo] global surface export {((time.time()-s))*1000:.1f}ms, "
          f"{sm.num_TSDF_particles} surface voxels")
    assert sm.num_TSDF_particles > 0

    s = time.time()
    mesher = MarchingCubeMesher(sm.global_map, max_triangles=1 << 18)
    mesher.generate_mesh(1)
    print(f"[demo] marching cubes {((time.time()-s))*1000:.1f}ms, "
          f"{mesher.num_facelets} triangles")
    assert mesher.num_facelets > 0

    # ESDF on a standalone DenseESDF map fed the same first frame
    esdf_map = DenseESDF(**{**sub_opts, "max_esdf_sweeps": 64},
                         device=device)
    esdf_map.set_dep_camera_intrinsic(K)
    Rcam0 = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32).T
    s = time.time()
    esdf_map.recast_depth_to_map(
        Rcam0, np.zeros(3, np.float32),
        render_depth_box(Rcam0, np.zeros(3, np.float32), K, h, w), None)
    print(f"[demo] TSDF+ESDF frame {((time.time()-s))*1000:.1f}ms "
          f"({esdf_map.last_esdf_sweeps} sweeps)")
    xyz, esdf = esdf_map.get_voxels_ESDF_slice(0.0)
    print(f"[demo] ESDF slice voxels: {esdf_map.num_export_ESDF_particles}, "
          f"range [{esdf[:esdf_map.num_export_ESDF_particles].min():.2f}, "
          f"{esdf[:esdf_map.num_export_ESDF_particles].max():.2f}]m")

    if args.topo:
        from taichislam_tpu_torch.models.topo_graph import TopoGraphGen
        s = time.time()
        topo = TopoGraphGen(esdf_map, coll_det_num=64, max_raycast_dist=3.0)
        # seed in observed free space: the voxel with the largest ESDF
        k = esdf_map.num_export_ESDF_particles
        seed = xyz[:k][np.argmax(esdf[:k])]
        print(f"[demo] topo seed {seed} (esdf {esdf[:k].max():.2f}m)")
        n = topo.generate_topo_graph(seed, max_nodes=12)
        print(f"[demo] topo graph {((time.time()-s))*1000:.1f}ms: "
              f"{n} nodes, {topo.num_facelets} facelets, "
              f"{len(topo.edges)} edges")
        assert n > 0

    if args.two_drones:
        # ship the trailing (still-active) submap so short runs whose only
        # submap never hit a keyframe boundary still reach drone B
        sm.flush()
        comm_b.handle()
        print(f"[demo] drone B received "
              f"{sm_b.submap_collection.remote_submap_num} remote submaps, "
              f"global active {sm_b.global_map.count_active()}")
        assert sm_b.submap_collection.remote_submap_num > 0

    print("[demo] OK")


if __name__ == "__main__":
    main()
