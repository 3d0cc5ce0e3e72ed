"""Configs, coordinate math and the block voxel grid."""
