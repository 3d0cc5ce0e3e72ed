"""Peak device memory allocated over the whole run, set-up included, read
once the window has closed (GiB)."""


def read(run):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
