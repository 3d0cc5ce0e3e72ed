"""CUDA-event ms per traced submap boundary (``submap.finalize`` span) of
its ``submap.export`` (the finished submap's gather and host copy) and
``submap.send`` (encode and publish) spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    recs = spans.records(run)
    if recs is None:
        return None
    bounds = spans.named(recs, "submap.finalize")
    parts = [(s, j) for s, i in bounds for j in spans.descendants(s, i)
             if s[j]["name"] in ("submap.export", "submap.send")]
    total = spans.event_sum(parts)
    return None if not bounds or total is None else total / len(bounds)
