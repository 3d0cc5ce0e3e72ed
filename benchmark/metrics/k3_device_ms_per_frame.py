"""Device ms per traced frame of the ESDF sweep loop K3
(``ops/kernels/esdf_sweep.py``; its builds are named ``k3_loop_kernel*``)."""

from benchmark.trace import device_ms


def read(run):
    return device_ms(run, r"\bk3_loop_kernel")
