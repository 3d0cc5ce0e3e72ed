"""Device ms per traced frame of the segmented reduction K1
(``ops/kernels/seg_accum.py``; its CUDA kernels are named ``k1_*``)."""

from benchmark.trace import device_ms


def read(run):
    return device_ms(run, r"\bk1_")
