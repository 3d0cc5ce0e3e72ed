"""K1's share of its roofline, in %: the bytes of the work its launches
were counted with over the traced frames (``k1/*`` counters; each input
read once, each output written once, ``benchmark/spans.py``) at 3.35 TB/s,
over the device time of the ``k1_*`` kernels in the traced span."""

from benchmark import spans


def read(run):
    return spans.roofline(run, "k1/", spans.k1_bytes, r"\bk1_")
