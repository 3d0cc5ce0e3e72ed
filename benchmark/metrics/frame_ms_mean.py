"""Mean latency (ms) of the window's processed frames, from when each was
due to when the device had finished its call's work."""

from benchmark import stats


def read(run):
    return stats.mean(r["latency"] for r in run["frames"])
