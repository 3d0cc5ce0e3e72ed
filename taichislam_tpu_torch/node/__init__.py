"""The node: the ROS-free core, its rospy shell and the topology worker."""

# ros_node is not imported here: it needs rospy
from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore  # noqa: F401
