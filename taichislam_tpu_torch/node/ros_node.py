#!/usr/bin/env python3
"""ROS node: the thin rospy shell over the port's node core.

Counterpart of the JAX package's ``scripts/taichislam_node.py``, with the
same topic names (``~depth``, ``~image``, ``~frame_local``, ``~traj``,
``~pointcloud``, ``~pose``, ``/dense_mapping``), rosparams, message-filter
synchronization and 100 Hz main loop (recast → comm → render). All
application logic lives in ``node/core.py`` (testable without ROS); this
module only wires rospy subscribers/publishers/params onto it. The maps
live on the CUDA card unless ``TaichiSLAMNode(device="cpu")`` asks for the
CPU.

Run it under ROS with the launch files' parameters::

    python -m taichislam_tpu_torch.node.ros_node __name:=taichislam_node \\
        _mapping_type:=tsdf _enable_submap:=true ...
"""

import numpy as np

from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore
from taichislam_tpu_torch.utils.ros_pcl_transfer import point_cloud
from taichislam_tpu_torch.utils.visualization import TaichiSLAMRender

import rospy  # noqa: E402  (this shell needs a ROS environment)
import message_filters
from sensor_msgs.msg import CompressedImage, Image, PointCloud2
from geometry_msgs.msg import PoseStamped

try:
    from swarm_msgs.msg import DroneTraj, VIOFrame
except ImportError:
    DroneTraj = VIOFrame = None


class TaichiSLAMNode(TaichiSLAMNodeCore):
    def __init__(self, device=None):
        enable_rendering = rospy.get_param("~enable_rendering", True)
        render = None
        if enable_rendering:
            RES_X = rospy.get_param("~disp/res_x", 1920)
            RES_Y = rospy.get_param("~disp/res_y", 1080)
            if rospy.get_param("~disp/interactive_viewer", False):
                from taichislam_tpu_torch.utils.viewer_server import \
                    InteractiveRender
                render = InteractiveRender(
                    port=rospy.get_param("~disp/viewer_port", 8765))
            else:
                render = TaichiSLAMRender(RES_X, RES_Y)

        self.pub_occ = rospy.Publisher("/dense_mapping", PointCloud2,
                                       queue_size=10)
        super().__init__(get_param=rospy.get_param,
                         publish_pointcloud=self.pub_to_ros,
                         render=render, device=device)
        self.init_subscribers()

    # -- subscriber wiring ----------------------------------------------------
    def init_subscribers(self):
        self.depth_sub = message_filters.Subscriber("~depth", Image,
                                                    queue_size=10)
        self.pointcloud_sub = message_filters.Subscriber(
            "~pointcloud", PointCloud2, queue_size=10)

        if self.enable_submap:
            self.frame_sub = message_filters.Subscriber("~frame_local",
                                                        VIOFrame)
            self.traj_sub = rospy.Subscriber("~traj", DroneTraj,
                                             self.traj_callback,
                                             queue_size=10, tcp_nodelay=True)
            if self.texture_enabled:
                img_type = CompressedImage if self.texture_compressed \
                    else Image
                self.image_sub = message_filters.Subscriber("~image",
                                                            img_type,
                                                            queue_size=10)
                self.ts = message_filters.ApproximateTimeSynchronizer(
                    [self.depth_sub, self.image_sub, self.frame_sub], 10,
                    slop=0.03)
                self.ts.registerCallback(self.process_depth_image_frame)
            else:
                self.ts = message_filters.ApproximateTimeSynchronizer(
                    [self.depth_sub, self.frame_sub], 10, slop=0.03)
                self.ts.registerCallback(self.process_depth_frame)
            self.ts_pcl = message_filters.ApproximateTimeSynchronizer(
                [self.pointcloud_sub, self.frame_sub], 10, slop=0.03)
            self.ts_pcl.registerCallback(self.process_pcl_frame)
        else:
            self.pose_sub = message_filters.Subscriber("~pose", PoseStamped)
            if self.texture_enabled:
                img_type = CompressedImage if self.texture_compressed \
                    else Image
                self.image_sub = message_filters.Subscriber("~image",
                                                            img_type,
                                                            queue_size=10)
                self.ts = message_filters.ApproximateTimeSynchronizer(
                    [self.depth_sub, self.image_sub, self.pose_sub], 10,
                    slop=0.03)
                self.ts.registerCallback(self.process_depth_image_pose)
            else:
                self.ts = message_filters.ApproximateTimeSynchronizer(
                    [self.depth_sub, self.pose_sub], 10, slop=0.03)
                self.ts.registerCallback(self.process_depth_pose)

    # -- message callbacks: decode + stage through the core ------------------
    def process_depth_frame(self, depth_msg, frame):
        self.stage_depth(frame, depth_msg)

    def process_depth_image_frame(self, depth_msg, image, frame):
        tex = self.decode_image(image, isinstance(image, CompressedImage))
        self.stage_depth(frame, depth_msg, tex)

    def process_pcl_frame(self, cloud_msg, frame):
        self.stage_pcl(frame, cloud_msg)

    def process_depth_pose(self, depth_msg, pose):
        pass  # a TODO in TaichiSLAM's node too

    def process_depth_image_pose(self, depth_msg, image, pose):
        pass

    def pub_to_ros(self, pos_, colors_, enable_texture):
        if enable_texture:
            pts = np.concatenate((pos_, colors_.astype(float)), axis=1)
            self.pub_occ.publish(point_cloud(pts, "world", has_rgb=True))
        else:
            self.pub_occ.publish(point_cloud(pos_, "world", has_rgb=False))


def slam_main(device=None):
    rospy.init_node("taichislam_node")
    node = TaichiSLAMNode(device=device)
    print("TaichiSLAMNode initialized")
    rate = rospy.Rate(100)
    while not rospy.is_shutdown():
        try:
            node.process_taichi()
            node.handle_comm()
            if node.enable_rendering:
                node.rendering()
            rate.sleep()
        except KeyboardInterrupt:
            break
    node.end_topo_thread()


if __name__ == "__main__":
    slam_main()
