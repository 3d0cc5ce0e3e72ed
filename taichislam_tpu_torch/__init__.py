"""PyTorch/CUDA port of the JAX package ``taichislam_tpu/``.

Same layout and names as the JAX package (``core/ ops/ models/ node/
opti/ utils/``); the hand-written Hopper kernels live in ``csrc/`` and are
bound in ``ops/kernels/``. This package imports neither JAX nor
``taichislam_tpu``.
"""

__version__ = "0.1.0"

from taichislam_tpu_torch.core.config import (OctomapConfig,  # noqa: F401
                                              TSDFConfig)
