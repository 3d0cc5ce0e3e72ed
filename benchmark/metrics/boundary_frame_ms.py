"""Mean latency (ms) of the window's submap-boundary frames (the node's
processed frame count a multiple of its keyframe step), of the frames
before a traced span starts; None where there were none."""

from benchmark import stats


def read(run):
    return stats.mean(r["latency"] for r in run["frames"]
                      if r["boundary"] and not r.get("traced"))
