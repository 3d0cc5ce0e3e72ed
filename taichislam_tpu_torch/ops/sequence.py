"""Multi-frame ingest: a window of depth frames fused (and, with the ESDF,
updated) frame by frame, its capacity stats reduced to window maxima so
that one host read decides the verdict.

Counterpart of the JAX package's ``ops/sequence.py``, whose ``lax.scan``
runs a window in one dispatch. ``integrate_depth_sequence``,
``integrate_esdf_sequence`` and ``accumulate_frame_verdict`` take its
signatures and return its keys. ``depths`` / ``textures`` are an
(F, h, w[, 3]) tensor or a tuple or list of per-frame tensors or arrays,
on any device (``textures`` may be None, or hold one frame that every
frame uses, when the map is untextured); ``Rs`` (F, 3, 3), ``Ts`` (F, 3),
``K_dep`` and ``K_color`` (9,) are tensors or arrays; ``active_submap`` is
a Python int. As everywhere in this package the state is updated IN PLACE
and returned, and so are ``esdf``, ``fixed``, ``pending``, ``seen_tsdf``
and ``seen_obs``.

Two ways to run the same frame body (``ops/tsdf.integrate_depth``, then
with the ESDF ``ops/esdf.esdf_seed_dirty`` and ``ops/esdf.esdf_update`` on
the dirty set and the pending wavefront, the JAX scan body):

- ``*_ref``: the plain eager loop over the frames. CPU tensors take it.
- CUDA tensors take a captured CUDA graph of one frame body, the
  counterpart of the jitted dispatch: the frame's depth, texture, pose and
  intrinsics are copied into the graph's static slots in stream order (a
  host frame through pinned memory, a device frame device to device) and
  the graph is replayed, once per frame, with no host sync; the replay
  updates the state in place and folds the frame's stats into the graph's
  window accumulators (running maxima and the union of touched blocks),
  which the caller reads once per window. The kernels inside are K1 (bins
  and march sites) and K3, or K2 at a budget of 1.

Graphs live in ``graph_cache`` (an ``ops/graphs.UnitCache`` of
:class:`FrameGraph` entries), keyed as JAX keys its jit cache (the cfg
with its buckets, the ESDF budget and block cap, the active submap, the
frame shapes, the device) and also on the addresses of the state tensors
the graph writes; a few entries, least recently used first out, an
evicted graph's memory back in the device's shared graph pool. Before its
capture a graph's body runs once eagerly on a scratch clone of the state,
so that the kernels build and set their one-time attributes outside the
capture while the map is written once. The capture uses
``capture_error_mode="thread_local"`` (a submap finalize thread may use
CUDA meanwhile). A failed capture or replay raises: nothing falls back to
the eager loop, which only the ``*_ref`` names reach. The frame body calls
the ops' eager bodies (``integrate_depth_ref``, ``esdf_seed_dirty_ref``,
``esdf_update_ref``), so that the plain loop is eager on the card too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.grid import GridState
from taichislam_tpu_torch.ops import esdf as esdf_ops
from taichislam_tpu_torch.ops import graphs
from taichislam_tpu_torch.ops import tsdf as tsdf_ops

_I32 = torch.int32
_PARAMS = 30   # per frame: R (9), T (3), K_dep (9), K_color (9)
_NP_DTYPE = {torch.int32: np.int32, torch.uint8: np.uint8}


# ---------------------------------------------------------------------------
# the frame body, shared by both paths
# ---------------------------------------------------------------------------

def _frame_step(cfg: TSDFConfig, budget, block_cap, state: GridState, es,
                depth, tex, par, active_submap: int):
    """One frame: integrate and, when ``es`` (esdf, fixed, pending,
    seen_tsdf, seen_obs) is given, seed the dirty set and update the ESDF
    in block mode; ``par`` holds the frame's R, T, K_dep, K_color. Returns
    the frame's stats row [bins_total, dropped, live_lanes(, esdf
    overflow)] (int32) and its touched blocks."""
    state, st = tsdf_ops.integrate_depth_ref(
        cfg, state, depth, tex, par[0:9].view(3, 3), par[9:12],
        par[12:21], par[21:30], active_submap)
    row = [st["num_bins"].to(_I32) + st["bins_dropped"].to(_I32),
           st["alloc_overflow"].to(_I32) + st["touched_dropped"].to(_I32) +
           st["lanes_dropped"].to(_I32),
           st["live_lanes"].to(_I32)]
    if es is not None:
        esdf, fixed, pending, seen_t, seen_o = es
        dirty, _, _ = esdf_ops.esdf_seed_dirty_ref(cfg, state, seen_t,
                                                   seen_o,
                                                   st["touched_blocks"])
        # consume-once snapshot seeds (see ops/esdf.py esdf_update)
        _, _, _, _, changed, overflow = esdf_ops.esdf_update_ref(
            cfg, budget, block_cap, state, esdf, fixed, active_submap,
            dirty | pending, tsdf_src=seen_t, obs_src=seen_o)
        pending.copy_(changed)
        row.append(overflow.to(_I32))
    return torch.stack(row), st["touched_blocks"]


def _stats(pack, union):
    keys = ("max_bins_total", "max_dropped", "max_live_lanes",
            "max_esdf_overflow")
    out = {k: pack[i] for i, k in enumerate(keys[:pack.shape[0]])}
    out["touched_blocks"] = union
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _frames(x):
    """Per-frame items of an (F, ...) tensor / array or a tuple / list."""
    return list(x) if isinstance(x, (tuple, list)) else [x[f] for f in
                                                          range(len(x))]


def _textures(cfg, textures, F):
    """Per-frame textures: the frames when the map is textured, else None
    (the body reads a (1, 1, 3) dummy)."""
    if not cfg.texture_enabled or textures is None:
        return None
    tex = _frames(textures)
    if len(tex) == 1 and F > 1:
        tex = tex * F
    if len(tex) != F:
        raise ValueError(f"textures: want {F} frames, got {len(tex)}")
    return tex


def _params(Rs, Ts, K_dep, K_color, F, dev):
    """(F, 30) f32 on ``dev``: each frame's R, T, K_dep, K_color. Host
    inputs go up in one copy through pinned memory."""
    if all(graphs.on_host(x) for x in (Rs, Ts, K_dep, K_color)):
        def h(x):
            return np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                              else x, np.float32)
        par = np.concatenate([
            h(Rs).reshape(F, 9), h(Ts).reshape(F, 3),
            np.broadcast_to(h(K_dep).reshape(1, 9), (F, 9)),
            np.broadcast_to(h(K_color).reshape(1, 9), (F, 9))], axis=1)
        return _upload(np.ascontiguousarray(par), dev)
    t = [torch.as_tensor(x, dtype=torch.float32, device=dev)
         for x in (Rs, Ts, K_dep, K_color)]
    return torch.cat([t[0].reshape(F, 9), t[1].reshape(F, 3),
                      t[2].reshape(1, 9).expand(F, 9),
                      t[3].reshape(1, 9).expand(F, 9)], dim=1)


def _upload(arr, dev):
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _frame_tensor(frame, dtype, dev):
    """One frame as a ``dtype`` tensor on ``dev`` (the eager path)."""
    if isinstance(frame, torch.Tensor):
        return frame.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(frame, _NP_DTYPE[dtype]), device=dev)


def _dummy_texture(dev):
    return torch.zeros((1, 1, 3), dtype=torch.uint8, device=dev)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _window_ref(cfg, budget, block_cap, state, es, depths, textures, Rs, Ts,
                K_dep, K_color, active_submap):
    dev = state.table.device
    frames = _frames(depths)
    F = len(frames)
    tex = _textures(cfg, textures, F)
    par = _params(Rs, Ts, K_dep, K_color, F, dev)
    rows, union = [], None
    for f in range(F):
        t = _dummy_texture(dev) if tex is None else \
            _frame_tensor(tex[f], torch.uint8, dev)
        row, touched = _frame_step(
            cfg, budget, block_cap, state, es,
            _frame_tensor(frames[f], _I32, dev), t, par[f],
            int(active_submap))
        rows.append(row)
        union = touched.clone() if union is None else union | touched
    return _stats(torch.stack(rows).amax(0), union)


def integrate_depth_sequence_ref(cfg: TSDFConfig, state: GridState, depths,
                                 textures, Rs, Ts, K_dep, K_color,
                                 active_submap: int):
    """Plain version of :func:`integrate_depth_sequence`: the eager loop
    of ``integrate_depth`` over the frames."""
    stats = _window_ref(cfg, 0, 0, state, None, depths, textures, Rs, Ts,
                        K_dep, K_color, active_submap)
    return state, stats


def integrate_esdf_sequence_ref(cfg: TSDFConfig, esdf_budget: int,
                                esdf_block_cap: int, state: GridState, esdf,
                                fixed, pending, seen_tsdf, seen_obs, depths,
                                textures, Rs, Ts, K_dep, K_color,
                                active_submap: int):
    """Plain version of :func:`integrate_esdf_sequence`: the eager loop of
    ``integrate_depth``, ``esdf_seed_dirty`` and ``esdf_update``."""
    es = (esdf, fixed, pending, seen_tsdf, seen_obs)
    stats = _window_ref(cfg, esdf_budget, esdf_block_cap, state, es, depths,
                        textures, Rs, Ts, K_dep, K_color, active_submap)
    return (state, esdf, fixed, pending, seen_tsdf, seen_obs, stats)


def accumulate_frame_verdict(pack_prev, union_prev, stats):
    """Fold one frame's capacity stats into the interval accumulators of
    the deferred per-frame path (models/dense_esdf.py): running maxima of
    [bins_total, dropped, live_lanes, esdf_overflow] and the union of
    touched blocks. Returns new tensors; plain tensor ops on every
    device."""
    pack = torch.stack([stats["max_bins_total"], stats["max_dropped"],
                        stats["max_live_lanes"],
                        stats["max_esdf_overflow"]]).to(_I32)
    return (torch.maximum(pack_prev, pack),
            union_prev | stats["touched_blocks"])


# the fold is the same plain tensor ops on every device
accumulate_frame_verdict_ref = accumulate_frame_verdict


# ---------------------------------------------------------------------------
# the graph path
# ---------------------------------------------------------------------------

class FrameGraph(graphs.Entry):
    """One key's captured frame body: the static input slots (depth,
    texture, the 30 pose and intrinsics floats), the window accumulators
    (``pack``, the running maxima, and ``union``, the touched blocks) and
    the graph ``"frame"``, whose replays add its launch tally to the
    kernels' counters."""

    def __init__(self, cfg, budget, block_cap, active_submap, tensors,
                 depth_shape, tex_shape, n_stats, dev):
        super().__init__(tensors, {
            "depth": (depth_shape, torch.int32),
            "tex": (tex_shape, torch.uint8),
            "par": ((_PARAMS,), torch.float32)}, dev)
        self.cfg, self.budget, self.block_cap = cfg, budget, block_cap
        self.active_submap = active_submap
        self.pack = torch.zeros((n_stats,), dtype=_I32, device=dev)
        self.union = torch.zeros((cfg.grid.max_blocks + 1,),
                                 dtype=torch.bool, device=dev)

    def _body(self, written, slots):
        state, pack, union, *es = written
        row, touched = _frame_step(self.cfg, self.budget, self.block_cap,
                                   state, tuple(es) or None, slots["depth"],
                                   slots["tex"], slots["par"],
                                   self.active_submap)
        torch.maximum(pack, row, out=pack)
        union.logical_or_(touched)

    def capture(self, cache, state, es):
        """Warm up on a scratch clone of the state and the accumulators
        (kernels built, their first-call attributes set), then capture the
        body on the real tensors. Raises when the capture fails."""
        t0 = time.perf_counter()
        written = (state, self.pack, self.union) + tuple(es or ())
        cache.warm_up(self._body, written, self.slots, self.pack.device)
        cache.capture(self, "frame", lambda: self._body(written, self.slots),
                      t0)


graph_cache = graphs.UnitCache("sequence", size=4)


def _window_graph(cfg, budget, block_cap, state, es, depths, textures, Rs,
                  Ts, K_dep, K_color, active_submap):
    dev = state.table.device
    frames = _frames(depths)
    F = len(frames)
    tex = _textures(cfg, textures, F)
    depth_shape = tuple(frames[0].shape)
    tex_shape = (1, 1, 3) if tex is None else tuple(tex[0].shape)
    tensors = graphs.leaves((state,) + (tuple(es) if es is not None else ()))
    active = int(active_submap)
    key = (cfg, budget, block_cap, active, depth_shape, tex_shape, str(dev),
           tuple(t.data_ptr() for t in tensors))
    n_stats = 3 if es is None else 4
    g = graph_cache.get(key, tensors, lambda: FrameGraph(
        cfg, budget, block_cap, active, tensors, depth_shape, tex_shape,
        n_stats, dev))
    par = _params(Rs, Ts, K_dep, K_color, F, dev)
    g.pack.zero_()
    g.union.zero_()
    for f in range(F):
        graphs.stage(g.slots["depth"], frames[f])
        if tex is not None:
            graphs.stage(g.slots["tex"], tex[f])
        g.slots["par"].copy_(par[f])
        if "frame" not in g.graphs:
            g.capture(graph_cache, state, es)
        graph_cache.replay(g, "frame")
    return _stats(g.pack.clone(), g.union.clone())


def _window(cfg, budget, block_cap, state, es, *inputs):
    dev = state.table.device
    if dev.type == "cpu":
        return _window_ref(cfg, budget, block_cap, state, es, *inputs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _window_graph(cfg, budget, block_cap, state, es, *inputs)


def integrate_depth_sequence(cfg: TSDFConfig, state: GridState, depths,
                             textures, Rs, Ts, K_dep, K_color,
                             active_submap: int):
    """Fuse a window of ``depths`` with per-frame submap-frame poses
    ``Rs``, ``Ts``. Returns (state, stats) with ``max_bins_total``,
    ``max_dropped``, ``max_live_lanes`` (0-d int32) and ``touched_blocks``
    (the window's union). CUDA state: one graph replay per frame; CPU
    state: :func:`integrate_depth_sequence_ref`."""
    stats = _window(cfg, 0, 0, state, None, depths, textures, Rs, Ts,
                    K_dep, K_color, active_submap)
    return state, stats


def integrate_esdf_sequence(cfg: TSDFConfig, esdf_budget: int,
                            esdf_block_cap: int, state: GridState, esdf,
                            fixed, pending, seen_tsdf, seen_obs, depths,
                            textures, Rs, Ts, K_dep, K_color,
                            active_submap: int):
    """Fusion and the per-frame gated incremental ESDF over a window:
    per frame ``integrate_depth``, ``esdf_seed_dirty``, and
    ``esdf_update`` in block mode at ``esdf_budget`` sweeps and
    ``esdf_block_cap`` rows on the dirty set and the ``pending``
    wavefront, which it re-queues. Returns (state, esdf, fixed, pending,
    seen_tsdf, seen_obs, stats), stats as :func:`integrate_depth_sequence`
    with ``max_esdf_overflow``. CUDA state: one graph replay per frame;
    CPU state: :func:`integrate_esdf_sequence_ref`."""
    es = (esdf, fixed, pending, seen_tsdf, seen_obs)
    stats = _window(cfg, esdf_budget, esdf_block_cap, state, es, depths,
                    textures, Rs, Ts, K_dep, K_color, active_submap)
    return (state, esdf, fixed, pending, seen_tsdf, seen_obs, stats)
