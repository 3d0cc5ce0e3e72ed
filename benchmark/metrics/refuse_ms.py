"""Mean CUDA-event ms of the ``submap.refuse`` spans of the traced frames:
the global map's refuse at a submap boundary (``DenseTSDF.fuse_submaps``,
K1's fusion site), its host reads included (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    recs = spans.records(run)
    if recs is None:
        return None
    pairs = spans.named(recs, "submap.refuse")
    total = spans.event_sum(pairs)
    return None if not pairs or total is None else total / len(pairs)
