"""The share of the device-idle time inside the traced frames' windows
(``trace.frame_windows``) that no ``tsl/`` range of the program's spans
covers, by an interval sweep over the whole span: how much of the idle
time the spans leave unnamed (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.idle_unspanned(run)
