"""K3's share of its roofline, in %: the bytes of the work its launches
were counted with over the traced frames (``k3/*`` counters; field,
encoded channel, neighbour table and row mask read once, field written
once, ``benchmark/spans.py``) at 3.35 TB/s, over the device time of the
``k3_loop_kernel*`` builds in the traced span."""

from benchmark import spans


def read(run):
    return spans.roofline(run, "k3/", spans.k3_bytes, r"\bk3_loop_kernel")
