"""Device-to-host copies in the traced span per traced frame: each one is
a point where the host waits for the device."""

from benchmark.trace import count_per_frame


def read(run):
    return count_per_frame(run, ("memcpy_dtoh",))
