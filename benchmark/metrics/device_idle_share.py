"""1 - (union of the kernel, memcpy and memset intervals inside the traced
frames' windows) / (the windows' length): the share of the node's own
frame time, from each call's start to the end of its device work, in
which nothing ran on the device (``trace.frame_windows``)."""

from benchmark.trace import idle_share


def read(run):
    return idle_share(run)
