"""PyTorch/CUDA port of taichislam_tpu (per-frame fusion + incremental ESDF).

Same layout and names as the JAX package (``core/ ops/ models/ utils/``);
the hand-written Hopper kernels live in ``csrc/`` and are bound in
``ops/kernels/``. This package imports neither JAX nor ``taichislam_tpu``.
"""
