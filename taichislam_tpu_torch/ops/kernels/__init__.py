"""Hand-written CUDA kernels (csrc/) with their plain PyTorch twins."""

from taichislam_tpu_torch.ops.kernels import seg_accum  # noqa: F401
