"""The program's own spans and counters in a traced run.

The port records, while a torch profiler records, a frame record per call
of ``process_taichi`` (``taichislam_tpu_torch/utils/profiling.py``,
``frames()``): the frame's spans (name, parent, host ns and CUDA-event ms
from the record's first event), the deltas of its counters over the frame
and ``profiled``. Its spans also sit on the profiler's timeline as host
ranges named ``tsl/<span>``. The readers here take the records of the
traced span's frames, and give None where the program keeps no records
(a version without them) or where their number differs from the trace's
``frames``.

Byte counts of the kernels, each input read once and each output written
once, from the sizes the wrappers count per launch:

- K1 (``k1/*``): block keys and intra indices (int32) and the values (f32)
  of every lane read; the touched list (int32), the accumulator tiles
  (f32, ``max_touched x n_vals x V3``) and two counts written.
- K3 (``k3/*``): the field and the encoded channel (f32, ``rows x (V+2)^3``
  each), the 27-neighbour table and the updatable-row mask (int32) read;
  the field and four stats written.
"""

from __future__ import annotations

from benchmark import stats
from benchmark.trace import device_ms, frame_windows

PREFIX = "tsl/"
HBM_BYTES_S = 3.35e12       # one H100 SXM's HBM3, NVIDIA's data sheet


def records(run):
    """The program's records of the traced frames, or None."""
    t = run.get("trace")
    if not t or not t["frames"]:
        return None
    try:
        from taichislam_tpu_torch.utils import profiling
    except ImportError:
        return None
    frames = getattr(profiling, "frames", None)
    if frames is None:
        return None
    recs = [r for r in frames() if r.get("profiled")]
    return recs if len(recs) == t["frames"] else None


def event_ms(span):
    """A span's CUDA-event ms, or None without events."""
    if span["e0"] is None or span["e1"] is None:
        return None
    return span["e1"] - span["e0"]


def descendants(spans, i):
    """Indices of the spans nested in span ``i``."""
    out, todo = [], [i]
    kids = {}
    for j, s in enumerate(spans):
        kids.setdefault(s["parent"], []).append(j)
    while todo:
        for j in kids.get(todo.pop(), ()):
            out.append(j)
            todo.append(j)
    return out


def self_ms(spans, i, less):
    """Span ``i``'s event ms less the part its nested spans whose name
    starts with ``less`` cover; None without events."""
    s = spans[i]
    total = event_ms(s)
    if total is None:
        return None
    iv = [(spans[j]["e0"], spans[j]["e1"]) for j in descendants(spans, i)
          if spans[j]["name"].startswith(less)]
    if any(a is None or b is None for a, b in iv):
        return None
    return total - stats.union_length(iv, s["e0"], s["e1"])


def named(recs, name):
    """(record's spans, index) of every span called ``name``."""
    return [(r["spans"], i) for r in recs
            for i, s in enumerate(r["spans"]) if s["name"] == name]


def event_sum(pairs):
    """The summed event ms of the spans (None where one lacks events)."""
    ms = [event_ms(spans[i]) for spans, i in pairs]
    return None if any(m is None for m in ms) else sum(ms)


def counted(recs, prefix):
    """The counters starting with ``prefix``, summed over the records."""
    out = {}
    for r in recs:
        for k, v in r["counts"].items():
            if k.startswith(prefix):
                out[k] = out.get(k, 0) + v
    return out


def k1_bytes(c):
    return (4 * (2 * c.get("k1/lanes", 0) + c.get("k1/lane_vals", 0)) +
            4 * (c.get("k1/max_touched", 0) + c.get("k1/tile_vals", 0)) +
            8 * c.get("k1/launches", 0))


def k3_bytes(c):
    return (12 * c.get("k3/cells", 0) + 4 * 28 * c.get("k3/rows", 0) +
            16 * c.get("k3/launches", 0))


def roofline(run, prefix, bytes_of, kernels):
    """100 x (the counted bytes at ``HBM_BYTES_S``) / (the device time of
    the kernels matching ``kernels`` in the span), in %: None without
    records, counted work or such kernels."""
    recs = records(run)
    if recs is None:
        return None
    moved = bytes_of(counted(recs, prefix))
    per_frame = device_ms(run, kernels)
    if not moved or not per_frame:
        return None
    return 100.0 * moved / HBM_BYTES_S / (per_frame * len(recs) / 1e3)


def idle_unspanned(run):
    """The share of the device-idle time inside the traced frames' windows
    that no ``tsl/`` host range covers (an interval sweep over the whole
    span); None without records or idle time."""
    if records(run) is None:
        return None
    t = run["trace"]
    lo, hi = t["span"]
    busy = stats.merge(((s, e) for _, _, s, e in t["device"]), lo, hi)
    idle = stats.intersect(stats.gaps(busy, lo, hi), frame_windows(t))
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    spanned = stats.merge((s, e) for name, s, e in t["host"]
                          if name.startswith(PREFIX))
    covered = sum(e - s for s, e in stats.intersect(idle, spanned))
    return (total - covered) / total
