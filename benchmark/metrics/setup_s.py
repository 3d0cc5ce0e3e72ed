"""Seconds from the start of the process to the first due frame of the
window: CUDA start, the kernel library's build or load, the scene, the
node's maps and the warm-up frames."""


def read(run):
    return run["setup_s"]
