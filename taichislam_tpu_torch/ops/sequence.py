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

One frame body (``ops/tsdf.integrate_depth``, then with the ESDF
``ops/esdf.esdf_seed_dirty`` and ``ops/esdf.esdf_update`` on the dirty set
and the pending wavefront, the JAX scan body) and one loop over the
window, which folds each frame's stats row into the window maxima and its
touched blocks into their union. CPU state runs the body eagerly, and so
do the ``*_ref`` names on every device. State on the card runs each frame
as one call of the unit ``graph_cache`` (``ops/graphs.py``), the
counterpart of the jitted dispatch: the frame's depth, texture and 30
pose and intrinsics floats are staged into the entry's slots in stream
order, and the body runs eagerly at the key's first call, is captured at
its second and replayed after that, with no host sync. The static key is
the cfg with its buckets, the ESDF budget and block cap and the active
submap; the unit adds the state's addresses, the frame shapes and the
device, as JAX keys its jit cache. The kernels inside are K1 (bins and
march sites) and K3, or K2 at a budget of 1. The frame body calls the
ops' eager bodies (``integrate_depth_ref``, ``esdf_seed_dirty_ref``,
``esdf_update_ref``), so that the plain loop is eager on the card too.
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.grid import GridState
from taichislam_tpu_torch.ops import esdf as esdf_ops
from taichislam_tpu_torch.ops import graphs
from taichislam_tpu_torch.ops import tsdf as tsdf_ops

_I32 = torch.int32


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


def _textures(cfg, textures, F, dev):
    """Per-frame textures: the frames when the map is textured (a
    (1, 1, 3) zero texture when none is given), else None."""
    if not cfg.texture_enabled:
        return None
    if textures is None:
        return [torch.zeros((1, 1, 3), dtype=torch.uint8, device=dev)] * F
    tex = _frames(textures)
    if len(tex) == 1 and F > 1:
        tex = tex * F
    if len(tex) != F:
        raise ValueError(f"textures: want {F} frames, got {len(tex)}")
    return tex


def _params(Rs, Ts, K_dep, K_color, F, dev):
    """(F, 30) f32 on ``dev``: each frame's R, T, K_dep, K_color. Host
    inputs go up in one staged copy."""
    v = graphs.params((Rs, Ts, K_dep, K_color), dev)
    if isinstance(v, np.ndarray):
        t = torch.empty(v.shape, dtype=torch.float32, device=dev)
        graphs.stage(t, v)
        v = t
    k = 12 * F
    return torch.cat([v[:9 * F].view(F, 9), v[9 * F:k].view(F, 3),
                      v[k:k + 9].expand(F, 9), v[k + 9:].expand(F, 9)],
                     dim=1)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

graph_cache = graphs.UnitCache("sequence", size=4)


def _window(cfg, budget, block_cap, state, es, depths, textures, Rs, Ts,
            K_dep, K_color, active_submap):
    """The frames in order, each the frame body run eagerly
    (:func:`graphs.eager`) or one call of ``graph_cache``; returns the
    window's stats."""
    dev = state.table.device
    frames = _frames(depths)
    F = len(frames)
    tex = _textures(cfg, textures, F, dev)
    par = _params(Rs, Ts, K_dep, K_color, F, dev)
    active = int(active_submap)
    written = (state,) + tuple(es or ())

    def body(w, s):
        return _frame_step(cfg, budget, block_cap, w[0], tuple(w[1:]) or None,
                           s["depth"], s.get("tex"), s["par"], active)
    eager = graphs.eager(state.table)
    rows, union = [], None
    for f in range(F):
        inputs = {"depth": (frames[f], _I32), "par": (par[f], torch.float32)}
        if tex is not None:
            inputs["tex"] = (tex[f], torch.uint8)
        if eager:
            row, touched = body(written, {n: v for n, (v, _) in
                                          inputs.items()})
        else:
            row, touched = graph_cache.call(
                ("sequence", cfg, budget, block_cap, active), body,
                written=written, inputs=inputs)
        rows.append(row)
        union = touched if union is None else union | touched
    return _stats(rows[0] if F == 1 else torch.stack(rows).amax(0), union)


def integrate_depth_sequence(cfg: TSDFConfig, state: GridState, depths,
                             textures, Rs, Ts, K_dep, K_color,
                             active_submap: int):
    """Fuse a window of ``depths`` with per-frame submap-frame poses
    ``Rs``, ``Ts``. Returns (state, stats) with ``max_bins_total``,
    ``max_dropped``, ``max_live_lanes`` (0-d int32) and ``touched_blocks``
    (the window's union). State on the card: one call of ``graph_cache``
    per frame; CPU state: :func:`integrate_depth_sequence_ref`."""
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
    with ``max_esdf_overflow``. State on the card: one call of
    ``graph_cache`` per frame; CPU state:
    :func:`integrate_esdf_sequence_ref`."""
    es = (esdf, fixed, pending, seen_tsdf, seen_obs)
    stats = _window(cfg, esdf_budget, esdf_block_cap, state, es, depths,
                    textures, Rs, Ts, K_dep, K_color, active_submap)
    return (state, esdf, fixed, pending, seen_tsdf, seen_obs, stats)


def integrate_depth_sequence_ref(cfg: TSDFConfig, state: GridState, depths,
                                 textures, Rs, Ts, K_dep, K_color,
                                 active_submap: int):
    """Plain version of :func:`integrate_depth_sequence`: the eager loop
    of ``integrate_depth`` over the frames, on every device."""
    with graphs.bodies():
        stats = _window(cfg, 0, 0, state, None, depths, textures, Rs, Ts,
                        K_dep, K_color, active_submap)
    return state, stats


def integrate_esdf_sequence_ref(cfg: TSDFConfig, esdf_budget: int,
                                esdf_block_cap: int, state: GridState, esdf,
                                fixed, pending, seen_tsdf, seen_obs, depths,
                                textures, Rs, Ts, K_dep, K_color,
                                active_submap: int):
    """Plain version of :func:`integrate_esdf_sequence`: the eager loop of
    ``integrate_depth``, ``esdf_seed_dirty`` and ``esdf_update``, on every
    device."""
    es = (esdf, fixed, pending, seen_tsdf, seen_obs)
    with graphs.bodies():
        stats = _window(cfg, esdf_budget, esdf_block_cap, state, es, depths,
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
