"""CUDA kernels launched in the traced span per traced frame."""

from benchmark.trace import count_per_frame


def read(run):
    return count_per_frame(run, ("kernel",))
