"""Mean CUDA-event self time (ms) of the node's ``node.recast`` span over
the traced frames, less the ``submap.*`` spans nested in it (a boundary's
finalize and the new submap's creation): decode, integrate, the ESDF
update and their host reads (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    recs = spans.records(run)
    if recs is None:
        return None
    ms = [spans.self_ms(s, i, "submap.")
          for s, i in spans.named(recs, "node.recast")]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(recs)
