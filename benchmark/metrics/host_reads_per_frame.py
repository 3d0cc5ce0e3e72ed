"""Device-to-host reads per traced frame by the program's own count: the
``host_read/<site>`` counters of ``utils/profiling.host_read``, summed
over the traced frames' records (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    recs = spans.records(run)
    if recs is None:
        return None
    return sum(spans.counted(recs, "host_read/").values()) / len(recs)
