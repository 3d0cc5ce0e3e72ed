"""The traffic loops: frames arrive, the node's latest-wins staging takes
them, and the node's main-loop call processes the latest one.

- ``open``: frame ``k`` of the window is due at ``k / rate`` s whatever the
  node does; a frame staged over one the node has not taken is lost
  (``dropped``). Its latency runs from when it was due.
- ``closed``: the next frame is staged as soon as the node's call returns
  (its due time), until the window's seconds are up.

A frame is done when the device has finished what its call enqueued; the
``clock`` marks that after the call and resolves every mark once the window
has closed, so the loop adds no synchronisation of its own.
"""

from __future__ import annotations

import time


class HostClock:
    """Marks on the host clock, for a node whose work is done when its call
    returns (the CPU)."""

    def start(self):
        self.t0 = time.perf_counter()

    def now_ms(self):
        return (time.perf_counter() - self.t0) * 1000.0

    def mark(self):
        return self.now_ms()

    def finish(self):
        pass

    def ms(self, mark):
        return mark


class DeviceClock(HostClock):
    """Marks as CUDA events on the current stream, read against an event
    recorded when the window started on an idle device."""

    def __init__(self, torch):
        self.torch = torch

    def start(self):
        self.torch.cuda.synchronize()
        self.ref = self.torch.cuda.Event(enable_timing=True)
        self.ref.record()
        super().start()

    def mark(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def finish(self):
        self.torch.cuda.synchronize()

    def ms(self, mark):
        return self.ref.elapsed_time(mark)


def run_window(node, clock, loop: str, rate_hz: float, seconds: float,
               on_frame=None, sleep=time.sleep):
    """Drive ``node`` (``stage(k)``, ``process()`` returning whether it
    raised) for one window. ``on_frame(k, n_done)`` is called before each
    processed frame (the tracer's hook). Returns (records, attempted,
    dropped): a record per processed frame with its window index ``k``, its
    ``due`` ms, its ``mark`` and ``raised``."""
    recs, dropped = [], 0
    clock.start()
    if loop == "open":
        period_ms = 1000.0 / rate_hz
        n_due = int(round(rate_hz * seconds))
        nxt, pending = 0, None
        while True:
            now = clock.now_ms()
            while nxt < n_due and nxt * period_ms <= now:
                if pending is not None:
                    dropped += 1
                node.stage(nxt)
                pending = nxt
                nxt += 1
            if pending is not None:
                k, pending = pending, None
                if on_frame is not None:
                    on_frame(k, len(recs))
                raised = node.process()
                recs.append({"k": k, "due": k * period_ms,
                             "mark": clock.mark(), "raised": raised})
                continue
            if nxt >= n_due:
                break
            sleep(max(0.0, (nxt * period_ms - clock.now_ms()) / 1000.0))
        attempted = n_due
    elif loop == "closed":
        due, k = 0.0, 0
        while due < seconds * 1000.0:
            node.stage(k)
            if on_frame is not None:
                on_frame(k, len(recs))
            raised = node.process()
            mark = clock.mark()
            recs.append({"k": k, "due": due, "mark": mark, "raised": raised})
            due = clock.now_ms()
            k += 1
        attempted = k
    else:
        raise ValueError(f"loop: want open or closed, got {loop!r}")
    clock.finish()
    for r in recs:
        r["done"] = clock.ms(r["mark"])
        r["latency"] = r["done"] - r["due"]
        del r["mark"]
    return recs, attempted, dropped
