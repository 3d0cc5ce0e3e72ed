"""CUDA graph captures the program made during the window, by its own
counters (``ops/graphs.counts()`` per unit and the sequences' cache), read
before and after the window."""


def read(run):
    before, after = run["counters"]
    if not after:
        return None
    n = sum(after["graphs"].values()) - sum(before["graphs"].values())
    return float(n + after["sequence_captures"] -
                 before["sequence_captures"])
