"""Configs, coordinate math and the block voxel grid."""

from taichislam_tpu_torch.core.config import (GridSpec, OctomapConfig,
                                              TSDFConfig)
from taichislam_tpu_torch.core.grid import (GridState, allocate_blocks,
                                            lookup_slots, make_grid_state)
from taichislam_tpu_torch.core import geometry

__all__ = [
    "GridSpec",
    "TSDFConfig",
    "OctomapConfig",
    "GridState",
    "make_grid_state",
    "allocate_blocks",
    "lookup_slots",
    "geometry",
]
