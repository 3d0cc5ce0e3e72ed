"""Fusion and ESDF operations on PyTorch tensors."""

from taichislam_tpu_torch.ops import (exports, fusion,  # noqa: F401
                                      occupancy, tsdf)
