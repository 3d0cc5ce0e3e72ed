"""ROS-free node core: the application logic of the TaichiSLAM node.

Counterpart of the JAX package's ``node/core.py`` over the port's models,
with its methods, parameters and defaults. It holds ALL of the node's logic
(param plumbing, option helpers, frame staging, the recast/output/render
loop, networking, the topology worker) behind two seams:

- ``get_param(name, default)`` — parameter lookup (rospy.get_param in the
  shell, a dict in tests);
- ``publish_pointcloud(xyz, colors, has_rgb)`` — the /dense_mapping output
  (a rospy Publisher in the shell, a list in tests).

Message objects are duck-typed to the sensor_msgs shapes actually read
(depth: .width/.height/.data; frame: .frame_id/.is_keyframe/.odom.pose.pose/
.extrinsics; traj: .drone_id/.frame_ids/.poses), so tests drive the full
staging → recast → output pipeline with SimpleNamespace fakes.

It differs from the JAX class in two ways:

- ``device``: the maps, the mesher and the topology worker keep their state
  on the CUDA card unless the caller passes another device
  (``device="cpu"``); with no card and no device it raises.
- The topology worker runs in a ``spawn`` process with a ``spawn`` Manager:
  CUDA cannot start in a forked child.

``node/ros_node.py`` is the thin rospy shell over this class.
"""

from __future__ import annotations

from math import nan

import numpy as np

from taichislam_tpu_torch.core.device import resolve_device
from taichislam_tpu_torch.models.dense_esdf import DenseESDF
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
from taichislam_tpu_torch.models.mesher import MarchingCubeMesher
from taichislam_tpu_torch.models.octomap import Octomap
from taichislam_tpu_torch.models.submap_mapping import SubmapMapping
from taichislam_tpu_torch.utils import profiling
from taichislam_tpu_torch.utils.comm import (CHANNEL_SUBMAP, CHANNEL_TRAJ,
                                             SLAMComm)
from taichislam_tpu_torch.utils.ros_pcl_transfer import (
    pointcloud2_to_xyz_rgb_array,
    pose_msg_to_numpy,
)


class TaichiSLAMNodeCore:
    """Everything the node does except talk to rospy."""

    def __init__(self, get_param, publish_pointcloud=None, render=None,
                 comm=None, topo_process_factory=None, device=None):
        self.get_param = get_param
        self.publish_pointcloud = publish_pointcloud or (lambda *a: None)
        self.topo_process_factory = topo_process_factory
        self.device = resolve_device(device)

        self.init_params()
        self.init_topology_generator()
        self.disp_level = 0
        self.count = 0
        self.cur_frame = None
        self.updated = False
        self.updated_pcl = False
        self.post_submap_fusion_count = 0

        self.render = render
        if self.render is not None:
            self.render.enable_mesher = self.enable_mesher
            self.render.particle_radius = get_param("~voxel_scale", 0.05) / 2
        self.enable_rendering = self.render is not None

        self.comm = comm
        self.initial_networking()
        self.initial_mapping()

    # -- params (the JAX core's init_params) ---------------------------------
    def init_params(self):
        g = self.get_param
        self.texture_compressed = g("~texture_compressed", False)
        self.enable_mesher = g("~enable_mesher", True)
        self.output_map = g("~output_map", False)
        self.enable_submap = g("~enable_submap", False)
        self.enable_multi = g("~enable_multi", True)
        self.drone_id = g("~drone_id", 1)
        self.keyframe_step = g("~keyframe_step", 10)

        self.Kdep = np.array([
            g("Kdepth/fx", 384.2377014160156), 0.0,
            g("Kdepth/cx", 323.4873046875), 0.0,
            g("Kdepth/fy", 384.2377014160156),
            g("Kdepth/cy", 235.0628204345703), 0.0, 0.0, 1.0])
        self.Kcolor = np.array([
            g("Kcolor/fx", 384.2377014160156), 0.0,
            g("Kcolor/cx", 323.4873046875), 0.0,
            g("Kcolor/fy", 384.2377014160156),
            g("Kcolor/cy", 235.0628204345703), 0.0, 0.0, 1.0])
        self.mapping_type = g("~mapping_type", "tsdf")
        # esdf type only: publish a jet-colored distance-field z-slice on
        # /dense_mapping (planner/viz consumers) after each frame
        self.esdf_publish_slice_z = g("~esdf/publish_slice_z", None)
        self.texture_enabled = g("~texture_enabled", True)
        self.max_mesh = g("~disp/max_mesh", 1000000)

        self.skeleton_graph_gen = g("~enable_skeleton_graph_gen", False)
        self.skeleton_graph_gen_opts = {
            "max_raycast_dist": g("~skeleton_graph_gen/max_raycast_dist",
                                  2.5),
            "coll_det_num": g("~skeleton_graph_gen/coll_det_num", 64),
            "frontier_combine_angle_threshold": g(
                "~skeleton_graph_gen/frontier_combine_angle_threshold", 20),
        }

    # -- option helpers ------------------------------------------------------
    def get_general_mapping_opts(self):
        g = self.get_param
        self.voxel_scale = voxel_scale = g("~voxel_scale", 0.05)
        return {
            "texture_enabled": self.texture_enabled,
            "max_disp_particles": g("~disp/max_disp_particles", 1024 * 1024),
            "map_scale": [g("~map_size_xy", 100), g("~map_size_z", 10)],
            "voxel_scale": voxel_scale,
            "max_ray_length": g("~max_ray_length", 5.1),
            "min_ray_length": g("~min_ray_length", 0.3),
            "disp_ceiling": g("~disp_ceiling", 1.8),
            "disp_floor": g("~disp_floor", -0.3),
            "color_same_proj": g("~color_same_proj", False),
        }

    def get_octo_opts(self):
        opts = self.get_general_mapping_opts()
        opts["K"] = self.get_param("K", 2)
        opts["min_occupy_thres"] = self.get_param("min_occupy_thres", 2)
        return opts

    def get_sdf_opts(self):
        opts = self.get_general_mapping_opts()
        opts["num_voxel_per_blk_axis"] = self.get_param(
            "~num_voxel_per_blk_axis", 16)
        return opts

    def get_esdf_opts(self):
        """mapping_type="esdf" knobs: DenseESDF with its per-frame
        incremental ESDF (TaichiSLAM's node degrades this type to plain
        TSDF)."""
        g = self.get_param
        opts = self.get_sdf_opts()
        opts["max_esdf_sweeps"] = g("~esdf/max_sweeps", 64)
        opts["esdf_check_interval"] = g("~esdf/check_interval", 1)
        return opts

    def get_submap_opts(self):
        opts = self.get_octo_opts() if self.mapping_type == "octo" \
            else self.get_sdf_opts()
        opts["max_disp_particles"] = self.get_param(
            "~submap_max_disp_particles", 100000)
        return opts

    def initial_mapping(self):
        dev = self.device
        if self.enable_submap:
            print(f"Initializing submap with {self.mapping_type}...")
            map_type = Octomap if self.mapping_type == "octo" else DenseTSDF
            self.mapping = SubmapMapping(
                map_type, global_opts=(self.get_octo_opts()
                                       if map_type is Octomap
                                       else self.get_sdf_opts()),
                sub_opts=self.get_submap_opts(),
                keyframe_step=self.keyframe_step, device=dev)
            self.mapping.post_local_to_global_callback = \
                self.post_submapfusion_callback
            if map_type is DenseTSDF and self.enable_mesher:
                self.mesher = MarchingCubeMesher(
                    self.mapping.global_map, self.max_mesh,
                    tsdf_surface_thres=self.voxel_scale * 5)
            self.mapping.map_send_handle = self.send_submap_handle
            self.mapping.traj_send_handle = self.traj_send_handle
        else:
            if self.mapping_type == "octo":
                self.mapping = Octomap(**self.get_octo_opts(), device=dev)
            else:
                if self.mapping_type == "esdf":
                    self.mapping = DenseESDF(**self.get_esdf_opts(),
                                             device=dev)
                else:
                    self.mapping = DenseTSDF(**self.get_sdf_opts(),
                                             device=dev)
                if self.enable_mesher:
                    self.mesher = MarchingCubeMesher(
                        self.mapping, self.max_mesh,
                        tsdf_surface_thres=self.voxel_scale * 5)
        self.mapping.set_color_camera_intrinsic(self.Kcolor)
        self.mapping.set_dep_camera_intrinsic(self.Kdep)

    # -- networking -----------------------------------------------------------
    def send_submap_handle(self, buf):
        if self.comm is not None:
            self.comm.publishBuffer(buf, CHANNEL_SUBMAP)

    def traj_send_handle(self, traj):
        if self.comm is not None:
            self.comm.publishBuffer(traj, CHANNEL_TRAJ)

    def initial_networking(self):
        if not self.enable_multi:
            self.comm = None
            return
        if self.comm is None:
            self.comm = SLAMComm(self.drone_id)
        self.comm.on_submap = self.on_remote_submap
        self.comm.on_traj = self.on_remote_traj

    def handle_comm(self):
        if self.comm is not None:
            with profiling.span("node.comm"):
                self.comm.handle()

    def on_remote_submap(self, buf):
        self.mapping.input_remote_submap(buf)

    def on_remote_traj(self, buf):
        self.mapping.input_remote_traj(buf)

    # -- topology worker ------------------------------------------------------
    def init_topology_generator(self):
        self.topo = None
        self.shared_map_d = None
        if not self.skeleton_graph_gen:
            return
        print("Initializing skeleton graph generator thread...")
        params = {
            "sdf_params": self.get_sdf_opts(),
            "skeleton_graph_gen_opts": self.skeleton_graph_gen_opts,
            "device": str(self.device),
        }
        if self.topo_process_factory is not None:
            self.topo, self.shared_map_d = self.topo_process_factory(params)
            return
        import multiprocessing
        from taichislam_tpu_torch.node.topo_worker import TopoGenThread
        ctx = multiprocessing.get_context("spawn")
        self.share_map_man = ctx.Manager()
        self.shared_map_d = self.share_map_man.dict()
        self.shared_map_d["exit"] = False
        self.shared_map_d["update"] = False
        self.shared_map_d["topo_graph_viz"] = None
        self.topo = ctx.Process(target=TopoGenThread,
                                args=[params, self.shared_map_d])
        self.topo.start()

    def end_topo_thread(self):
        if self.topo:
            print("Ending topology thread...")
            self.shared_map_d["exit"] = True
            self.topo.terminate()
            self.topo.join()
            self.topo = None
            man = getattr(self, "share_map_man", None)
            if man is not None:
                man.shutdown()
                self.share_map_man = None

    # -- frame staging: callbacks stage the LATEST frame; the main loop
    # -- consumes it (latest-wins queue) --------------------------------------
    def stage_depth(self, frame, depth_msg, texture=np.array([], dtype=int)):
        with profiling.span("node.stage"):
            self.depth_msg = depth_msg
            self.cur_frame = frame
            self.texture = texture
            self.updated = True

    def stage_pcl(self, frame, cloud_msg):
        with profiling.span("node.stage"):
            self.cloud_msg = cloud_msg
            self.cur_frame = frame
            self.updated = True
            self.updated_pcl = True

    def decode_image(self, image, compressed: bool):
        with profiling.span("node.stage"):
            if compressed:
                import cv2
                np_arr = np.frombuffer(image.data, np.uint8)
                rgb = cv2.imdecode(np_arr, cv2.IMREAD_COLOR)
                return cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
            np_arr = np.frombuffer(image.data, np.uint8)
            return np_arr.reshape((image.height, image.width, -1))

    # -- recast / output / render loop ----------------------------------------
    # the times below are the spans' host ms (``utils/profiling``): nan
    # while tracing is off (``TAICHISLAM_TRACE=1`` turns it on)
    def recast(self):
        frame = self.cur_frame
        mapping = self.mapping
        with profiling.span("node.recast") as t_recast:
            if self.updated_pcl:
                self.updated_pcl = False
                with profiling.span("node.decode") as t_pcl2npy:
                    xyz_array, rgb_array = pointcloud2_to_xyz_rgb_array(
                        self.cloud_msg)
                pose = pose_msg_to_numpy(frame.odom.pose.pose)
                ext = np.eye(3), np.zeros(3)
                mapping.recast_pcl_to_map_by_frame(frame.frame_id,
                                                   frame.is_keyframe, pose,
                                                   ext, xyz_array, rgb_array)
            else:
                with profiling.span("node.decode") as t_pcl2npy:
                    w, h = self.depth_msg.width, self.depth_msg.height
                    depthmap = np.frombuffer(self.depth_msg.data,
                                             dtype=np.uint16).reshape((h, w))
                pose = pose_msg_to_numpy(frame.odom.pose.pose)
                ext = pose_msg_to_numpy(frame.extrinsics[0])
                mapping.recast_depth_to_map_by_frame(frame.frame_id,
                                                     frame.is_keyframe, pose,
                                                     ext, depthmap,
                                                     self.texture)
        return pose, t_pcl2npy.ms, t_recast.ms

    def output(self, R, T):
        mapping = self.mapping
        t_mesh = t_export = t_pubros = nan
        if self.mapping_type == "octo":
            with profiling.span("node.export_occupy"):
                mapping.cvt_occupy_to_voxels(self.disp_level)
            n = mapping.num_export_particles
            if self.output_map:
                with profiling.span("node.publish"):
                    self.publish_pointcloud(mapping.export_x[:n],
                                            mapping.export_color[:n],
                                            mapping.enable_texture)
        else:
            if self.enable_rendering and self.render.enable_mesher:
                with profiling.span("node.mesh") as sp:
                    self.mesher.generate_mesh(1)
                t_mesh = sp.ms
                self.render.set_mesh(self.mesher.mesh_vertices,
                                     self.mesher.mesh_colors,
                                     self.mesher.mesh_normals,
                                     mesh_num=self.mesher.num_facelets)
            elif self.output_map:
                with profiling.span("node.export_surface") as sp:
                    mapping.cvt_TSDF_surface_to_voxels()
                t_export = sp.ms
                n = mapping.num_TSDF_particles
                with profiling.span("node.publish") as sp:
                    self.publish_pointcloud(mapping.export_TSDF_xyz[:n],
                                            mapping.export_color[:n],
                                            mapping.enable_texture)
                t_pubros = sp.ms
            if self.mapping_type == "esdf" and self.output_map and \
                    self.esdf_publish_slice_z is not None:
                with profiling.span("node.export_slice"):
                    mapping.cvt_ESDF_to_voxels_slice(
                        float(self.esdf_publish_slice_z))
                n = mapping.num_export_ESDF_particles
                with profiling.span("node.publish"):
                    self.publish_pointcloud(mapping.export_ESDF_xyz[:n],
                                            mapping.export_color[:n], True)
        if self.enable_rendering and self.render.lock_pos_drone:
            self.render.camera_lookat = T
        return t_mesh, t_export, t_pubros

    def process_taichi(self):
        if not self.updated:
            return
        self.updated = False
        profiling.frame_begin(self.count)
        try:
            pose, t_pcl2npy, t_recast = self.recast()
            if self.enable_rendering:
                self.render.set_drone_pose(0, pose[0], pose[1])
            t_mesh, t_export, t_pubros = self.output(pose[0], pose[1])
            self.count += 1
            with profiling.span("node.report"):
                print(f"[TaichiSLAM] Time: pcl2npy {t_pcl2npy:.1f}ms "
                      f"t_recast {t_recast:.1f}ms t_export {t_export:.1f}ms "
                      f"t_mesh {t_mesh:.1f}ms t_pubros {t_pubros:.1f}ms")
        finally:
            profiling.frame_end(self.mapping._trace_scalars)

    def rendering(self):
        with profiling.span("node.render") as sp:
            self._rendering()
        return sp.ms

    def _rendering(self):
        mapping = self.mapping
        if self.enable_rendering:
            if self.mapping_type == "tsdf":
                # slice view toggle
                if getattr(self.render, "enable_slice_z", False):
                    mapping.cvt_TSDF_to_voxels_slice(self.render.slice_z)
                else:
                    mapping.cvt_TSDF_surface_to_voxels()
                self.render.set_particles(mapping.export_TSDF_xyz,
                                          mapping.export_color,
                                          mapping.num_TSDF_particles)
            if self.mapping_type == "esdf":
                # distance-field slice view
                if getattr(self.render, "enable_slice_z", False):
                    mapping.cvt_ESDF_to_voxels_slice(self.render.slice_z)
                    self.render.set_particles(
                        mapping.export_ESDF_xyz, mapping.export_color,
                        mapping.num_export_ESDF_particles)
                else:
                    mapping.cvt_TSDF_surface_to_voxels()
                    self.render.set_particles(mapping.export_TSDF_xyz,
                                              mapping.export_color,
                                              mapping.num_TSDF_particles)
            if self.mapping_type == "octo":
                mapping.cvt_occupy_to_voxels(self.disp_level)
                self.render.set_particles(mapping.export_x,
                                          mapping.export_color,
                                          mapping.num_export_particles)
            self.render.rendering()

    def traj_callback(self, traj):
        if traj.drone_id != self.drone_id:
            return
        frame_poses = {}
        positions = np.zeros((len(traj.poses), 3))
        for i in range(len(traj.frame_ids)):
            R, T = pose_msg_to_numpy(traj.poses[i])
            frame_poses[traj.frame_ids[i]] = (R, T)
            positions[i] = T
        self.mapping.set_frame_poses(frame_poses)
        if self.enable_rendering:
            self.render.set_drone_trajectory(0, positions)

    def post_submapfusion_callback(self, global_map):
        self.post_submap_fusion_count += 1
        if self.topo:
            self.shared_map_d["map_data"] = global_map.export_submap()
            self.shared_map_d["update"] = True
            viz = self.shared_map_d["topo_graph_viz"]
            if viz is not None and self.enable_rendering:
                self.render.set_skeleton_graph_edges(viz["lines"])
