"""ROS <-> numpy interop, usable with or without a ROS install.

Counterpart of the JAX package's ``utils/ros_pcl_transfer.py`` (a rebuild of
TaichiSLAM's ``taichi_slam/utils/ros_pcl_transfer.py``), over the port's
``opti/transformations.py``. The
PointCloud2 codec is implemented directly on the wire format (pure numpy, no
ros_numpy), so it also services the LCM/offline paths; message-object
accessors (pose/transform converters, bag iteration) import rospy/rosbag
lazily and degrade gracefully when ROS is absent.
"""

from __future__ import annotations

import numpy as np

from taichislam_tpu_torch.opti.transformations import quaternion_matrix_np


# ---------------------------------------------------------------------------
# PointCloud2 wire codec
# ---------------------------------------------------------------------------

_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def _cloud_dtype(cloud_msg):
    names, formats, offsets = [], [], []
    for f in cloud_msg.fields:
        names.append(f.name)
        formats.append(_PF_DTYPES[f.datatype])
        offsets.append(f.offset)
    return np.dtype({"names": names, "formats": formats, "offsets": offsets,
                     "itemsize": cloud_msg.point_step})


def pointcloud2_to_array(cloud_msg):
    """Decode a sensor_msgs/PointCloud2 into a structured numpy array."""
    dtype = _cloud_dtype(cloud_msg)
    arr = np.frombuffer(bytes(cloud_msg.data), dtype=dtype)
    return arr.reshape(cloud_msg.height * cloud_msg.width)


def get_xyz_rgb_points(cloud_array, remove_nans=True, dtype=float):
    """Structured cloud -> (xyz (N,3), rgb (N,3) or None)
    (ros_pcl_transfer.py:13-34): drops NaNs; unpacks packed float rgb."""
    if remove_nans:
        mask = (np.isfinite(cloud_array["x"]) &
                np.isfinite(cloud_array["y"]) &
                np.isfinite(cloud_array["z"]))
        cloud_array = cloud_array[mask]
    points = np.zeros((len(cloud_array), 3), dtype=dtype)
    points[:, 0] = cloud_array["x"]
    points[:, 1] = cloud_array["y"]
    points[:, 2] = cloud_array["z"]
    rgb = None
    if "rgb" in cloud_array.dtype.names:
        packed = cloud_array["rgb"].copy().view(np.uint32)
        rgb = np.zeros((len(cloud_array), 3), np.uint8)
        rgb[:, 0] = (packed >> 16) & 0xFF
        rgb[:, 1] = (packed >> 8) & 0xFF
        rgb[:, 2] = packed & 0xFF
    return points, rgb


def pointcloud2_to_xyz_rgb_array(cloud_msg, remove_nans=True):
    return get_xyz_rgb_points(pointcloud2_to_array(cloud_msg), remove_nans)


def point_cloud(points, parent_frame, has_rgb=False):
    """numpy (N,3[,6]) -> sensor_msgs/PointCloud2
    (ros_pcl_transfer.py:96-136). Requires ROS message packages."""
    from sensor_msgs.msg import PointCloud2, PointField
    from std_msgs.msg import Header
    import rospy

    ros_dtype = PointField.FLOAT32
    itemsize = 4
    fields_names = ["x", "y", "z"] + (["r", "g", "b"] if has_rgb else [])
    data = np.asarray(points, np.float32)
    nfields = len(fields_names)
    fields = [PointField(name=n, offset=i * itemsize, datatype=ros_dtype,
                         count=1) for i, n in enumerate(fields_names)]
    header = Header(frame_id=parent_frame, stamp=rospy.Time.now())
    return PointCloud2(
        header=header, height=1, width=data.shape[0], is_dense=False,
        is_bigendian=False, fields=fields, point_step=itemsize * nfields,
        row_step=itemsize * nfields * data.shape[0],
        data=data.astype(np.float32).tobytes())


# ---------------------------------------------------------------------------
# pose / transform conversion (ros_pcl_transfer.py:39-94)
# ---------------------------------------------------------------------------

def quaternion_matrix(quaternion):
    """(x, y, z, w) -> 4x4 homogeneous rotation matrix."""
    M = np.eye(4)
    M[:3, :3] = quaternion_matrix_np(np.asarray(quaternion, np.float64))
    return M


def transform_msg_to_numpy(cur_trans, Rdb=None):
    """geometry_msgs/TransformStamped -> (R, T) with optional body-frame
    offset Rdb (ros_pcl_transfer.py:60-78)."""
    q = cur_trans.transform.rotation
    T = np.array([cur_trans.transform.translation.x,
                  cur_trans.transform.translation.y,
                  cur_trans.transform.translation.z])
    R = quaternion_matrix([q.x, q.y, q.z, q.w])[:3, :3]
    if Rdb is not None:
        R = R @ Rdb
    return R, T


def pose_msg_to_numpy(pose):
    """geometry_msgs/Pose -> (R, T) (ros_pcl_transfer.py:80-94)."""
    q = pose.orientation
    T = np.array([pose.position.x, pose.position.y, pose.position.z])
    R = quaternion_matrix([q.x, q.y, q.z, q.w])[:3, :3]
    return R, T


def sync_error(msg1, msg2, use_abs=False):
    dt = msg1.header.stamp.to_sec() - msg2.header.stamp.to_sec()
    return abs(dt) if use_abs else dt


def iteration_over_bag(path, callback, depth_topic="/camera/depth/image_rect_raw",
                       pose_topic="/vins_estimator/camera_pose", slop=0.03):
    """Replay a rosbag, pairing depth/pose messages by timestamp
    (ros_pcl_transfer.py:170-201). Requires rosbag."""
    import rosbag

    bag = rosbag.Bag(path)
    pending_pose = None
    for topic, msg, t in bag.read_messages():
        if topic == pose_topic:
            pending_pose = msg
        elif topic == depth_topic and pending_pose is not None:
            if abs(sync_error(msg, pending_pose, True)) < slop:
                callback(pending_pose, msg)
    bag.close()
