"""CUDA-event ms per traced frame of the node's two exports, the spans
``node.export_surface`` (the surface cloud) and ``node.export_slice``
(the ESDF slice), their host copies included (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    recs = spans.records(run)
    if recs is None:
        return None
    pairs = (spans.named(recs, "node.export_surface") +
             spans.named(recs, "node.export_slice"))
    total = spans.event_sum(pairs)
    return None if not pairs or total is None else total / len(recs)
