"""95th percentile (nearest rank) of the latencies of all the window's
processed frames."""

from benchmark import stats


def read(run):
    return stats.p95([r["latency"] for r in run["frames"]])
