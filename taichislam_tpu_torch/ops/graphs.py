"""Per-call CUDA graphs: the counterpart of the JAX package's jitted units.

In the JAX package every operation the node calls per frame is one
compiled XLA program (``integrate_depth``, ``esdf_seed_dirty``,
``esdf_update``, ``esdf_update_dense``, the exports, ``dilate_blocks``,
``extract_mesh``), keyed by its static arguments and input shapes; the
host reads only between programs. On the card the port runs each such unit
as one replay of a captured CUDA graph (the dense ESDF as three: before,
inside and after its sweep loop), and ``ops/sequence.py`` runs each frame
of a window as one call of its unit. This module holds what they share:

- a unit keeps a cache of its own (:class:`UnitCache`, listed in
  ``UNITS``), so that the units of one frame do not evict each other; a
  cache holds ``size`` entries, the least recently used evicted first (its
  graphs reset, their memory back in the device's shared graph pool), and
  drops an entry whose tensors died;
- an entry's key (:func:`key`) is the unit's static key (cfg, static
  arguments, active submap), the device, the addresses of the caller's
  tensors the body reads or writes in place, and the name, shape and dtype
  of each staged input; the ops write their state in place and the models
  never rebind their state tensors, so that keys stay valid;
- inputs that change from call to call (a frame, a pose, a bitmap another
  unit produced) are copied into the entry's static slots in stream order
  (:func:`stage`): host data through pinned memory, a tensor on the card
  device to device; a capture holds no host-to-device copy;
- every unit, the sequences included, runs the body eagerly on the real
  tensors at a key's first call: the kernels build and set their one-time
  attributes outside any capture, and a key seen once costs no capture
  (JAX compiles a key once); its second call captures, and every later
  call replays;
- captures use ``capture_error_mode="thread_local"`` (a submap finalize
  thread or the topo worker may use CUDA meanwhile); a failed capture or
  replay raises, nothing falls back to the eager body;
- every replay adds the launches its capture recorded to the kernels'
  counters (``build.capture_tally`` / ``build.add_counts``); each capture
  is the span ``unit.capture/<unit>`` of ``utils/profiling``;
- a replay's outputs live in the device's graph memory pool, which the
  next replay (of any graph) may overwrite: :meth:`UnitCache.call` hands
  the caller clones of them and its own objects (the state it passed) as
  they are. A cached graph keeps no reference to the caller's objects, so
  an entry dies with the model whose tensors it holds.

While a body runs eagerly or is captured, every op runs its eager body
(:func:`eager`), so a unit's body may call other units' ops. CPU tensors
always take the eager bodies; nothing here starts CUDA at import.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref

import numpy as np
import torch

from taichislam_tpu_torch.core.grid import GridState
from taichislam_tpu_torch.ops.kernels import build
from taichislam_tpu_torch.utils import profiling

_NP_DTYPE = {torch.int32: np.int32, torch.uint8: np.uint8,
             torch.float32: np.float32, torch.bool: np.bool_,
             torch.int8: np.int8}

_tls = threading.local()

# every unit's cache by name (counts and clearing across units)
UNITS = {}


def eager(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` runs its eager body: ``t`` is not on the
    card, or this thread is running a unit's body eagerly or capturing
    it."""
    return (t.device.type != "cuda" or getattr(_tls, "bodies", 0) > 0 or
            torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def bodies():
    """Run the ops called inside as eager bodies (a unit's body run
    eagerly or captured)."""
    _tls.bodies = getattr(_tls, "bodies", 0) + 1
    try:
        yield
    finally:
        _tls.bodies -= 1


def leaves(objs):
    """The tensors of ``objs``: a GridState's fields and channels (sorted
    by name), tensors as they are, None skipped."""
    out = []
    for o in objs:
        if isinstance(o, GridState):
            out += [getattr(o, f) for f in o._fields if f != "channels"]
            out += [o.channels[k] for k in sorted(o.channels)]
        elif o is not None:
            out.append(o)
    return out


def key(static, tensors, inputs, dev):
    """An entry's key: ``static``, the device, the addresses of
    ``tensors`` and each input's (name, shape, slot dtype)."""
    return (static, str(dev), tuple(t.data_ptr() for t in tensors),
            tuple((n, tuple(v.shape), dt) for n, (v, dt) in inputs.items()))


def to_device(x, dev, dtype=None):
    """``x`` (host array, or tensor on any device) as a tensor on ``dev``;
    a host array takes the numpy ``dtype`` first."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    return torch.as_tensor(np.asarray(x, dtype), device=dev)


def on_host(x) -> bool:
    return not (isinstance(x, torch.Tensor) and x.device.type != "cpu")


def params(xs, dev):
    """The f32 values of ``xs`` (each flattened) in one vector: numpy when
    every one is on the host (staged with one copy), else a tensor on
    ``dev``."""
    if all(on_host(x) for x in xs):
        return np.concatenate([np.asarray(
            x.numpy() if isinstance(x, torch.Tensor) else x,
            np.float32).reshape(-1) for x in xs])
    return torch.cat([torch.as_tensor(x, dtype=torch.float32,
                                      device=dev).reshape(-1) for x in xs])


def stage(slot, x):
    """Copy ``x`` into a static slot in stream order: a tensor on the card
    device to device, host data through pinned memory (into a slot on the
    card). The pinned block comes from PyTorch's caching host allocator,
    which records the copy's event and hands the block out again only once
    the copy has completed, so no staging buffer is overwritten early."""
    if tuple(x.shape) != tuple(slot.shape):
        raise ValueError(f"input shape {tuple(x.shape)}: this graph takes "
                         f"{tuple(slot.shape)}")
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        slot.copy_(x)
        return
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    host = torch.from_numpy(np.ascontiguousarray(
        x, dtype=_NP_DTYPE[slot.dtype]))
    slot.copy_(host.pin_memory() if slot.is_cuda else host,
               non_blocking=True)


class _Own:
    """Stands for the caller's ``own[i]`` in a captured body's outputs, so
    that a cached graph holds no reference to the caller's state (which
    would keep a dead model's tensors, and with them the entry, alive)."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


_DESCEND = object()


def _map(x, fn):
    """``x`` rebuilt with ``fn`` applied top down: where ``fn`` returns
    ``_DESCEND`` dicts, lists, tuples and named tuples are traversed and
    other leaves kept."""
    y = fn(x)
    if y is not _DESCEND:
        return y
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_map(v, fn) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    return x


def strip(out, own):
    """``out`` with each of the caller's objects ``own`` (matched by
    identity) replaced by a placeholder; :func:`detach` puts them back."""
    ids = {id(o): i for i, o in enumerate(own)}
    return _map(out, lambda x: _Own(ids[id(x)]) if id(x) in ids
                else _DESCEND)


def detach(out, own):
    """What a replay hands its caller: every tensor of ``out`` cloned out
    of the graph's pool, and each placeholder of :func:`strip` the
    caller's object ``own[i]``."""
    def node(x):
        if isinstance(x, _Own):
            return own[x.i]
        if isinstance(x, torch.Tensor):
            return x.clone()
        return _DESCEND
    return _map(out, node)


# device index -> (memory pool, the graph that holds it, capture stream)
_POOLS = {}


def _capture(graph, fn, pool, side):
    """Capture ``fn()`` into ``graph`` on the stream ``side``, which first
    waits for the current one, allocating from ``pool``; returns its
    output."""
    cur = torch.cuda.current_stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    return out


def _pool(device):
    """(pool, stream): the one memory pool every graph on ``device``
    captures into, and the one stream it captures on (the allocator hands
    a freed block only to allocations on the stream it was made on, so
    one stream lets each capture reuse what earlier captures freed). A
    one-kernel graph kept for the life of the process holds the pool: a
    pool whose graphs have all been freed cannot be captured into
    again."""
    if device.index not in _POOLS:
        with torch.cuda.device(device):
            pool = torch.cuda.graph_pool_handle()
            side = torch.cuda.Stream(device=device)
            anchor = torch.cuda.CUDAGraph()
            _capture(anchor, lambda: torch.zeros(1, device=device), pool,
                     side)
            _POOLS[device.index] = (pool, anchor, side)
    pool, _, side = _POOLS[device.index]
    return pool, side


class Captured:
    """One captured CUDA graph: the body's outputs (in the pool, the
    caller's objects ``own`` among them replaced by placeholders), the
    launches the capture recorded and its replays. The capture runs on the
    device's capture stream, which first waits for the current one; unlike
    ``torch.cuda.graph`` it neither synchronizes the device nor empties
    the allocator's cache, which would cost every later eager allocation a
    fresh ``cudaMalloc``. All graphs of a device share one memory pool
    (each pool a graph kept to itself stayed reserved after the graph was
    freed): replays run one at a time on the caller's stream, and every
    graph's outputs are read before the next replay, so one graph's
    temporaries may reuse another's."""

    def __init__(self, fn, own=()):
        graph = torch.cuda.CUDAGraph()
        pool, side = _pool(torch.cuda.current_stream().device)
        with bodies(), build.capture_tally() as tally:
            out = _capture(graph, fn, pool, side)
        self.out = strip(out, own)
        self.graph, self.tally, self.replays = graph, tally, 0

    def replay(self):
        self.graph.replay()
        build.add_counts(self.tally)
        self.replays += 1
        return self.out

    def release(self):
        self.graph.reset()


def slot_specs(inputs):
    """{name: (shape, dtype)} of staged ``inputs`` ({name: (value,
    dtype)})."""
    return {n: (tuple(v.shape), dt) for n, (v, dt) in inputs.items()}


class Entry:
    """One key of a unit: weak references to the caller's tensors it
    reads or writes, its static input slots (``specs``: {name: (shape,
    dtype)}), its call count and its captured graphs by name."""

    def __init__(self, tensors, specs, dev):
        self.refs = [weakref.ref(t) for t in tensors]
        self.slots = {n: torch.zeros(shape, dtype=dt, device=dev)
                      for n, (shape, dt) in specs.items()}
        self.calls = 0
        self.graphs = {}

    def holds(self, tensors):
        """Whether the entry reads or writes exactly these (live)
        tensors."""
        return len(tensors) == len(self.refs) and all(
            r() is t for r, t in zip(self.refs, tensors))

    def alive(self):
        return all(r() is not None for r in self.refs)

    def stage(self, inputs):
        for n, (v, _) in inputs.items():
            stage(self.slots[n], v)

    def release(self):
        for g in self.graphs.values():
            g.release()
        self.graphs.clear()


class UnitCache:
    """A unit's entries by key, at most ``size``, the least recently used
    evicted first, entries whose tensors died dropped. ``captures``,
    ``capture_ms`` (host wall time of the captures), ``replays`` and
    ``eager_calls`` (a key's first call) count since :meth:`reset_counts`."""

    def __init__(self, name: str, size: int = 4):
        self.name, self.size = name, size
        self.entries = collections.OrderedDict()
        self.lock = threading.RLock()
        self.reset_counts()
        UNITS[name] = self

    def reset_counts(self):
        self.captures = self.replays = self.eager_calls = 0
        self.capture_ms = 0.0

    def clear(self):
        with self.lock:
            while self.entries:
                self.entries.popitem(last=False)[1].release()

    def _drop(self, k):
        self.entries.pop(k).release()

    def _get(self, k, tensors, make):
        """The entry under ``k`` (made by ``make()`` when there is none, or
        when it holds other tensors at the same addresses)."""
        for dead in [d for d, e in self.entries.items() if not e.alive()]:
            self._drop(dead)
        entry = self.entries.get(k)
        if entry is not None and not entry.holds(tensors):
            self._drop(k)
            entry = None
        if entry is None:
            entry = make()
            self.entries[k] = entry
            while len(self.entries) > self.size:
                self._drop(next(iter(self.entries)))
        self.entries.move_to_end(k)
        return entry

    def enter(self, static, tensors, inputs):
        """(entry, first): the entry of this call's key with ``inputs``
        staged into its slots, and whether this is the key's first call,
        which runs the body eagerly (and counts it)."""
        dev = tensors[0].device
        entry = self._get(key(static, tensors, inputs, dev), tensors,
                          lambda: Entry(tensors, slot_specs(inputs), dev))
        entry.stage(inputs)
        entry.calls += 1
        first = entry.calls == 1
        self.eager_calls += first
        return entry, first

    def capture(self, entry, name, fn, own=()):
        """Capture ``fn`` as the entry's graph ``name`` (its outputs hold
        no reference to the caller's objects ``own``)."""
        t0 = time.perf_counter()
        with profiling.span("unit.capture/" + self.name):
            entry.graphs[name] = Captured(fn, own)
        self.captures += 1
        self.capture_ms += 1000 * (time.perf_counter() - t0)
        return entry.graphs[name]

    def _replay(self, entry, name):
        self.replays += 1
        return entry.graphs[name].replay()

    def run(self, entry, name, fn, own=()):
        """Replay the entry's graph ``name``, captured from ``fn`` first
        when the entry has none by that name."""
        if name not in entry.graphs:
            self.capture(entry, name, fn, own=own)
        return self._replay(entry, name)

    def call(self, static, body, written=(), bound=(), inputs=None):
        """One call of a unit on the card: ``body(written, slots)`` run
        eagerly at its key's first call, else as one graph replay (captured
        at the second), where ``written`` (GridStates and tensors the body
        updates in place) and ``bound`` (tensors it reads in place) are the
        caller's and ``slots`` holds ``inputs`` ({name: (value, dtype)})
        staged into the entry's static slots. Returns the body's outputs,
        cloned out of the graph's pool but for the caller's own objects."""
        inputs = inputs or {}
        tensors = leaves(written) + list(bound)
        own = list(written) + tensors
        with self.lock:
            entry, first = self.enter(static, tensors, inputs)
            if first:
                with bodies():
                    return body(written, entry.slots)
            out = self.run(entry, "body", lambda: body(written, entry.slots),
                           own)
            return detach(out, own)


def clear():
    """Reset every unit's graphs (their memory back in the shared pool)."""
    for c in UNITS.values():
        c.clear()


def reset_counts():
    for c in UNITS.values():
        c.reset_counts()


def counts():
    """{unit: (captures, capture_ms, replays, eager_calls)}."""
    return {n: (c.captures, c.capture_ms, c.replays, c.eager_calls)
            for n, c in UNITS.items()}
