"""Host-side helpers: comm, codecs, ROS interop, viewers, profiling."""
