"""The node: the ROS-free core, its rospy shell and the topology worker."""
