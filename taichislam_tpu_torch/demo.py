#!/usr/bin/env python
"""Offline demo CLI over the PyTorch port.

Counterpart of the JAX package's ``taichislam_demo.py``: replays a rosbag
(when rosbag and a bag file are available) or falls back to the data-free
smoke fill (``random_init_octo`` for the octomap, ``init_sphere`` for the
TSDF/ESDF maps) and renders the result headless. The maps live on the CUDA
card unless ``--cpu`` asks for the CPU.

Run:  python -m taichislam_tpu_torch.demo [-m octo|tsdf|esdf] [--cpu]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="TaichiSLAM offline demo")
    ap.add_argument("-b", "--bag", type=str, default="",
                    help="path of rosbag to replay")
    ap.add_argument("-m", "--method", type=str, default="octo",
                    choices=["octo", "tsdf", "esdf"])
    ap.add_argument("-r", "--resolution", nargs=2, type=int,
                    default=[640, 480])
    ap.add_argument("--voxel-size", type=float, default=0.05)
    ap.add_argument("--map-size", nargs=2, type=float, default=[100.0, 10.0])
    ap.add_argument("--blk", type=int, default=16,
                    help="num voxels per block per axis")
    ap.add_argument("--texture-enabled", action="store_true")
    ap.add_argument("--viewer", action="store_true",
                    help="serve the interactive WebGL viewer "
                         "(orbit/pan/zoom + options panel) on --viewer-port")
    ap.add_argument("--viewer-port", type=int, default=8765)
    ap.add_argument("--record", action="store_true",
                    help="save rendered frames as PNGs to ./frames/")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    from taichislam_tpu_torch.models.octomap import Octomap
    from taichislam_tpu_torch.utils.ros_pcl_transfer import (
        iteration_over_bag, pointcloud2_to_xyz_rgb_array, pose_msg_to_numpy)
    from taichislam_tpu_torch.utils.visualization import TaichiSLAMRender

    if args.method == "octo":
        mapping = Octomap(map_scale=args.map_size,
                          voxel_scale=args.voxel_size,
                          texture_enabled=args.texture_enabled,
                          device=device)
    elif args.method == "tsdf":
        mapping = DenseTSDF(map_scale=args.map_size,
                            voxel_scale=args.voxel_size,
                            num_voxel_per_blk_axis=args.blk,
                            texture_enabled=args.texture_enabled,
                            device=device)
    else:
        mapping = DenseESDF(map_scale=args.map_size,
                            voxel_scale=args.voxel_size,
                            num_voxel_per_blk_axis=args.blk,
                            texture_enabled=args.texture_enabled,
                            device=device)

    save_path = None
    if args.record:
        import os
        os.makedirs("frames", exist_ok=True)
        save_path = "frames"
    if args.viewer:
        from taichislam_tpu_torch.utils.viewer_server import \
            InteractiveRender
        render = InteractiveRender(port=args.viewer_port)
    else:
        render = TaichiSLAMRender(1280, 720, save_path=save_path)

    if args.bag:
        def cb(pose_msg, cloud_msg):
            R, T = pose_msg_to_numpy(pose_msg.pose)
            xyz, rgb = pointcloud2_to_xyz_rgb_array(cloud_msg)
            if isinstance(mapping, Octomap):
                mapping.recast_pcl_to_map(R, T, xyz, rgb, len(xyz))
            else:
                mapping.recast_pcl_to_map(R, T, xyz, rgb)
        iteration_over_bag(args.bag, cb)
    else:
        print("No bag path is provided — running the random smoke fill")
        if isinstance(mapping, Octomap):
            mapping.random_init_octo(1000)
        else:
            mapping.init_sphere()

    if isinstance(mapping, Octomap):
        xyz, color = mapping.get_occupy_voxels(0)
        n = mapping.num_export_particles
    else:
        xyz, _, color = mapping.get_voxels_TSDF_surface()
        n = mapping.num_TSDF_particles
    print(f"map voxels exported: {n}")
    render.set_particles(xyz[:n], color[:n] if color is not None else None)
    render.rendering()
    render.close()
    print("demo done")
    return n


if __name__ == "__main__":
    main()
