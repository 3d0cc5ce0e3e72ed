"""The device trace of a fixed span of the window's frames.

``Tracer`` starts ``torch.profiler`` (host and CUDA activity) before the
first frame processed after ``skip_ms`` into the window and stops it
``frames`` frames later, closing the span with a device synchronisation
inside a ``benchmark_span`` range, so the span holds all the work of its
frames. While it runs, the driver puts each frame's call to the node in a
``benchmark_frame`` range. The trace is kept in memory and reduced, once
the window has closed, to:

- ``device``: (kind, name, start_us, end_us) of every kernel, memcpy and
  memset, kind ``kernel``, ``memcpy_dtoh``, ``memcpy`` or ``memset``;
- ``host``: (name, start_us, end_us) of the host-side ranges (operators,
  runtime calls), for naming the idle gaps;
- ``calls``: (start_us, end_us) of the ``benchmark_frame`` ranges;
- ``span``: (start_us, end_us) of the ``benchmark_span`` range and
  ``frames``, the frames inside it.

A frame is busy from the start of its call until the later of the call's
return and the end of the last device operation that started before the
next call (``frame_windows``); the idle share is taken over those windows,
so the time an open loop waits for the next frame is not in it.
"""

from __future__ import annotations

import bisect
import re

from benchmark import stats

SPAN = "benchmark_span"
FRAME = "benchmark_frame"


class Tracer:
    def __init__(self, torch, skip_ms: float, frames: int, clock, driver):
        self.torch = torch
        self.driver = driver            # its ``frame_range`` is set here
        self.skip_ms = skip_ms
        self.frames = frames
        self.clock = clock
        self.prof = self.rf = None
        self.first = None
        self.done = False
        self.n = 0

    def warm(self):
        """Start and stop the profiler once in set-up: its first start
        loads and initialises the tracing library."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    @property
    def started(self) -> bool:
        return self.first is not None

    def on_frame(self, k, n_done):
        if self.done:
            return
        if self.prof is None:
            if self.clock.now_ms() >= self.skip_ms:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.rf = record_function(SPAN)
                self.rf.__enter__()
                self.driver.frame_range = lambda: record_function(FRAME)
                self.first = n_done
        elif n_done - self.first >= self.frames:
            self.stop(n_done)

    def stop(self, n_done):
        if self.prof is None or self.done:
            return
        self.driver.frame_range = None
        self.torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.done = True
        self.n = n_done - self.first

    def result(self):
        """The reduced trace (after the window), or None."""
        return reduce(self.torch, self.prof, self.n) if self.done else None


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy_dtoh" if "DtoH" in name else "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def reduce(torch, prof, frames: int) -> dict:
    device, host, calls, span = [], [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name in (SPAN, FRAME):
            if e.device_type != cuda:
                if e.name == SPAN:
                    span = (s, t)
                else:
                    calls.append((s, t))
        elif e.device_type == cuda:
            device.append((_kind(e.name), e.name, s, t))
        else:
            host.append((e.name, s, t))
    return {"device": device, "host": host, "calls": sorted(calls),
            "span": span, "frames": frames}


def frame_windows(t):
    """Each traced frame's busy window, merged: from its call's start to
    the later of the call's end and the end of the last device operation
    that started before the next call (or the span's end)."""
    lo, hi = t["span"]
    calls = t["calls"]
    ops = sorted((s, e) for _, _, s, e in t["device"])
    starts = [s for s, _ in ops]
    out = []
    for i, (s, e) in enumerate(calls):
        nxt = calls[i + 1][0] if i + 1 < len(calls) else hi
        a, b = bisect.bisect_left(starts, s), bisect.bisect_left(starts, nxt)
        end = max([e] + [ops[j][1] for j in range(a, b)])
        out.append((s, end))
    return stats.merge(out, lo, hi)

def device_ms(run, pattern):
    """Device ms inside the traced span of kernels whose name matches
    ``pattern`` (a regular expression), per traced frame; None without a
    trace, or where no such kernel ran."""
    t = run.get("trace")
    if not t or not t["frames"]:
        return None
    lo, hi = t["span"]
    rx = re.compile(pattern)
    iv = [(max(s, lo), min(e, hi)) for kind, name, s, e in t["device"]
          if kind == "kernel" and rx.search(name)]
    if not iv:
        return None
    return sum(e - s for s, e in iv if e > s) / 1000.0 / t["frames"]


def count_per_frame(run, kinds):
    """Device operations of ``kinds`` inside the span, per traced frame."""
    t = run.get("trace")
    if not t or not t["frames"]:
        return None
    lo, hi = t["span"]
    n = sum(1 for kind, _, s, e in t["device"]
            if kind in kinds and s < hi and e > lo)
    return n / t["frames"]


def busy_s(t):
    """(seconds in which some device operation ran, seconds of the span)."""
    lo, hi = t["span"]
    busy = stats.union_length([(s, e) for _, _, s, e in t["device"]], lo, hi)
    return busy / 1e6, (hi - lo) / 1e6


def idle_share(run):
    """1 - (device-busy time inside the frames' windows) / (their length):
    the share of the node's own frame time in which the device sat idle."""
    t = run.get("trace")
    if not t or not t["span"] or not t.get("calls"):
        return None
    win = frame_windows(t)
    total = sum(e - s for s, e in win)
    if total <= 0:
        return None
    dev = stats.merge((s, e) for _, _, s, e in t["device"])
    busy = sum(e - s for s, e in stats.intersect(dev, win))
    return 1.0 - busy / total
