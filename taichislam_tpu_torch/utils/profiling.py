"""Tracing / profiling: the port's one timing system.

Counterpart of the JAX package's ``utils/profiling.py`` over PyTorch, with
its names (``StageTimer``, ``trace``, ``device_trace``), and the spans and
counters the port places where its work happens:

- ``span(name)``: a context manager around a stage. Off, it is one shared
  no-op object (``ms`` reads nan). On, it opens the profiler range
  ``"tsl/" + name`` (so it sits on ``torch.profiler``'s timeline, on the
  device operations' clock; a host range of the operator kind, which the
  profiler does not mirror onto the device's timeline as it does a
  ``record_function`` annotation), takes ``perf_counter_ns`` at both ends
  (``ms``) and records a CUDA event pair on the current stream, from a
  reused pool, once CUDA has started. It never synchronises. Spans nest:
  each knows its parent, so a span's self time is its duration less what
  its children cover. No span wraps a whole frame, and none goes inside a
  body a CUDA graph captures.
- Tracing is on while ``TAICHISLAM_TRACE=1`` was set at import, after
  ``enable(True)``, or while a torch profiler records.
- ``count(name, n)``: host counters in one dict, always on (``counts()``).
  ``host_read(site, t)`` copies ``t`` to the host (into pinned memory
  with ``pinned=True``), counts it under ``host_read/<site>`` and, while
  tracing, opens the span ``sync/<site>``. ``host_read_start(site, t)``
  queues the same pinned copy without waiting and returns the wait, which
  any thread may call.
  The kernels' wrappers count the work of each launch (``ops/kernels/
  build.count``), graph replays included.
- Frame records: the node calls ``frame_begin(frame)`` / ``frame_end()``
  around each ``process_taichi``. While tracing, a record holds the
  frame's spans (spans outside a frame, such as staging, join the next
  frame's record), the counters' deltas, whether a torch profiler was
  recording (``profiled``) and device scalars the caller hands
  ``frame_end``, kept unread. Records live in a ring of ``RING`` frames.
  Once ``BATCH`` records hold unread events, the next ``frame_begin``
  reads the times of those whose events have completed (no wait, under
  the span ``trace.resolve``) and returns their events to the pool.
  ``frames()`` resolves every record, waiting on the card once and copying
  the scalars once: call it outside any timed window.

Only the thread that runs the frames writes records; a span in another
thread sits on the profiler's timeline alone.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from math import nan
from typing import Dict

import torch

PREFIX = "tsl/"
RING = 4096
BATCH = 64

_enabled = os.environ.get("TAICHISLAM_TRACE", "") == "1"
_profiler_on = torch._C._autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast


class StageTimer:
    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema: Dict[str, float] = {}
        self.last: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def start(self, name: str):
        self._t0[name] = time.perf_counter()
        return self

    def stop(self, name: str, sync=None) -> float:
        """Stop a stage; ``sync`` (a tensor) first waits for the CUDA device
        it lives on, so the measurement includes device execution."""
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        ms = (time.perf_counter() - self._t0.pop(name)) * 1000.0
        self.last[name] = ms
        self.ema[name] = ms if name not in self.ema else \
            (1 - self.alpha) * self.ema[name] + self.alpha * ms
        return ms

    @contextlib.contextmanager
    def stage(self, name: str, sync_fn=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, sync=sync_fn() if sync_fn else None)

    def report(self, prefix: str = "[TaichiSLAM]") -> str:
        """The node's per-frame timing line format."""
        parts = " ".join(f"{k} {v:.1f}ms" for k, v in self.last.items())
        return f"{prefix} Time: {parts}"


@contextlib.contextmanager
def trace(name: str):
    """torch.profiler annotation around a host-side stage."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the CPU and the CUDA card (when present) and write a Chrome
    trace to ``<log_dir>/trace.json``, creating ``log_dir`` if missing
    (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- switch and counters -----------------------------------------------------

def enable(on: bool = True) -> None:
    """Turn tracing on or off (``TAICHISLAM_TRACE=1`` at import turns it
    on; a recording torch profiler turns it on while it records)."""
    global _enabled
    _enabled = bool(on)


_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of every counter."""
    with _counts_lock:
        return dict(_counts)


def host_read(site: str, t: torch.Tensor, pinned: bool = False
              ) -> torch.Tensor:
    """``t`` on the host (``t.cpu()``): the one way the port's paths read
    the device, counted under ``host_read/<site>`` (an empty tensor moves
    nothing and is not counted) and, while tracing, under the span
    ``sync/<site>``. ``pinned``: a CUDA ``t`` lands in a block of
    PyTorch's caching host allocator, by one non-blocking copy and a wait
    on the stream; the block goes back to the allocator only once nothing
    refers to it (a numpy view of it included)."""
    if t.numel() == 0:
        return t.cpu()
    count("host_read/" + site)
    if not (_enabled or _profiler_on()):
        return _read(t, pinned)
    with span("sync/" + site):
        return _read(t, pinned)


def host_read_start(site: str, t: torch.Tensor):
    """``host_read(site, t, pinned=True)`` split in two: the copy into a
    pinned block is queued now on the current stream, behind whatever that
    stream already holds, and counted now; the returned function (callable
    from any thread) waits for it, under the span ``sync/<site>``, and
    returns the host tensor. A CPU or empty ``t`` is read at once."""
    if not (t.is_cuda and t.numel()):
        h = host_read(site, t)
        return lambda: h
    count("host_read/" + site)
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    done = torch.cuda.Event(blocking=True)
    done.record(torch.cuda.current_stream(t.device))

    def wait():
        with span("sync/" + site):
            done.synchronize()
        return h
    return wait


def _read(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    if not (pinned and t.is_cuda):
        return t.cpu()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


# -- spans --------------------------------------------------------------------

class _Off:
    """What ``span`` returns while tracing is off."""

    __slots__ = ()
    ms = nan

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "parent", "t0", "t1", "ev0", "ev1", "e0",
                 "e1", "rf")

    def __init__(self, name, rec):
        self.name, self.rec = name, rec
        self.parent = self.ev0 = self.ev1 = self.e0 = self.e1 = None
        self.t0 = self.t1 = 0

    @property
    def ms(self) -> float:
        """Host milliseconds from enter to exit."""
        return (self.t1 - self.t0) / 1e6

    def __enter__(self):
        self.rf = _host_range(PREFIX + self.name)
        self.rf.__enter__()
        rec = self.rec
        if rec is not None:
            if rec.stack:
                self.parent = rec.stack[-1]
            rec.stack.append(len(rec.spans))
            rec.spans.append(self)
            if rec.cuda:
                self.ev0 = _event()
                self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            if self.ev0 is not None:
                self.ev1 = _event()
                self.ev1.record()
                rec.last = self.ev1
            rec.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` (see the module docstring)."""
    if not (_enabled or _profiler_on()):
        return _OFF
    return _Span(name, _state.record_for_span())


_pool = []


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


# -- frame records ------------------------------------------------------------

class _Record:
    __slots__ = ("frame", "profiled", "t0", "t1", "spans", "stack", "base",
                 "deltas", "cuda", "last", "names", "values", "scalars")

    def __init__(self, base):
        self.frame, self.profiled, self.t0, self.t1 = None, False, 0, 0
        self.spans, self.stack = [], []
        self.base, self.deltas = base, {}
        self.cuda = torch.cuda.is_initialized()
        self.last = None            # the last event recorded
        self.names, self.values, self.scalars = (), None, {}

    def resolve_events(self):
        """Event times in ms from the record's first event; the events go
        back to the pool. Every event must have completed."""
        ref = next((s.ev0 for s in self.spans if s.ev0 is not None), None)
        for s in self.spans:
            if s.ev0 is not None and s.ev1 is not None:
                s.e0, s.e1 = ref.elapsed_time(s.ev0), ref.elapsed_time(s.ev1)
            for ev in (s.ev0, s.ev1):
                if ev is not None:
                    _pool.append(ev)
            s.ev0 = s.ev1 = None
        self.last = None

    def as_dict(self):
        return {"frame": self.frame, "profiled": self.profiled,
                "t0": self.t0, "t1": self.t1,
                "spans": [{"name": s.name, "parent": s.parent, "t0": s.t0,
                           "t1": s.t1, "e0": s.e0, "e1": s.e1}
                          for s in self.spans],
                "counts": dict(self.deltas), "scalars": dict(self.scalars)}


class _State:
    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.unresolved = collections.deque()
        self.open = None            # the record spans go into
        self.begun = False          # whether ``open``'s frame has begun
        # the thread that runs the frames (the main one until a frame
        # begins elsewhere)
        self.owner = threading.main_thread().ident
        self.base = None            # counters at the last frame's end

    def record_for_span(self):
        if threading.get_ident() != self.owner:
            return None
        if self.open is None:
            self.open = _Record(self.base if self.base is not None
                                else counts())
            self.begun = False
        return self.open


_state = _State()


def frame_begin(frame) -> None:
    """Open frame ``frame``'s record while tracing (the spans since the
    last frame join it); while not, drop them."""
    st = _state
    if not (_enabled or _profiler_on()):
        st.open, st.base = None, None
        return
    st.owner = threading.get_ident()
    if len(st.unresolved) >= BATCH:
        with span("trace.resolve"):
            while st.unresolved and st.unresolved[0].last.query():
                st.unresolved.popleft().resolve_events()
    rec = st.record_for_span()
    rec.frame, rec.profiled = frame, _profiler_on()
    rec.t0 = time.perf_counter_ns()
    st.begun = True


def frame_end(scalars=None) -> None:
    """Close the open frame's record: the counters' deltas and, from
    ``scalars()`` (a dict of 0-d device tensors, called only while a
    record is open), the scalars stacked on the device, unread, under the
    span ``trace.scalars``."""
    st = _state
    rec = st.open
    if rec is None or not st.begun or threading.get_ident() != st.owner:
        return
    if scalars is not None:
        with span("trace.scalars"):
            vals = scalars()
            if vals:
                rec.names = tuple(vals)
                rec.values = torch.stack([v.reshape(())
                                          for v in vals.values()])
    st.open, st.begun = None, False
    rec.t1 = time.perf_counter_ns()
    now = counts()
    rec.deltas = {k: v - rec.base.get(k, 0) for k, v in now.items()
                  if v != rec.base.get(k, 0)}
    rec.base, st.base = None, now
    st.ring.append(rec)
    if rec.last is not None:
        st.unresolved.append(rec)


def frames():
    """Every kept record, resolved, oldest first: ``frame``, ``profiled``,
    ``t0`` / ``t1`` (host ns), ``spans`` (``name``, ``parent`` (an index
    into ``spans``, or None), host ``t0`` / ``t1`` in ns, event times
    ``e0`` / ``e1`` in ms from the record's first event, or None without
    CUDA), ``counts`` (the counters' deltas) and ``scalars``. Waits on the
    card once and copies the scalars once."""
    st = _state
    if st.unresolved:
        torch.cuda.synchronize()
        while st.unresolved:
            st.unresolved.popleft().resolve_events()
    todo = [r for r in st.ring if r.values is not None]
    if todo:
        flat = iter(torch.cat([r.values.to(torch.float64) for r in todo]
                              ).cpu().tolist())
        for r in todo:
            r.scalars = {k: next(flat) for k in r.names}
            r.values = None
    return [r.as_dict() for r in st.ring]


def reset() -> None:
    """Drop every record and zero every counter."""
    global _state
    _state = _State()
    with _counts_lock:
        _counts.clear()
