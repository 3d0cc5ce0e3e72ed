#!/usr/bin/env python
"""Benchmark: the north-star metric of the port on one CUDA card.

Counterpart of the repository's ``bench.py`` (the JAX package's headline).
Primary metric (the printed JSON line): 640x480 depth frames fused into a
5 cm TSDF **with the per-frame incremental ESDF** (block mode, 3 sweeps a
frame), in frames per second. Secondary fields of the same object:
fusion only, the ESDF drained every frame (32 sweeps), full-map marching
cubes, the incremental re-mesh of one frame's dirty blocks, and fusion on
an 8192-block map (40 x 10 m), so that the headline does not rest on a
scene-sized capacity. ``device`` names the card and its power limit.

How a window runs: the JAX bench scans all 50 frames inside one jit; here
the same window goes through ``ops/sequence.py``, which on the card
replays one captured CUDA graph per frame with no host sync inside the
window (``integrate_esdf_sequence``; ``integrate_depth_sequence`` without
the ESDF). Every pass starts from the same entry state and zeroed ESDF
carries, written back in place outside the timed region (a graph's key
holds the addresses of the tensors it writes). A pass is timed with CUDA
events around the whole window; a row reports the best of 3 passes, as the
JAX bench does, and logs their median and spread. A timed pass must
capture no graph.

Honesty guards: capacities grow by the JAX bench's rule
(:func:`next_capacities`) until the window's worst frame drops nothing,
and every timed pass must drop nothing: no fusion drop (allocation,
touched blocks, march lanes), no ESDF working-set overflow and no ray bin
past the bin bucket.

Run:  python -m taichislam_tpu_torch.bench [--cpu]
Progress goes to stderr, the JSON line to stdout. On the CPU (``--cpu``)
the passes are timed with the host clock and the kernels' plain versions
run.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

N_FRAMES = 50
PASSES = 3
SIZE_ROUNDS = 7


def note(msg, _t0=[time.time()]):
    print(f"[bench +{time.time() - _t0[0]:.0f}s] {msg}", file=sys.stderr,
          flush=True)


def make_inputs(n_frames=N_FRAMES):
    """The bench's D435-like sequence: a static office room observed by an
    orbiting camera with 3 mm sensor noise (``utils/synthetic_scene.py``,
    seed 0). Returns (depth u16 (n, 480, 640), Rs, Ts); the render is
    cached under the fixtures directory (``tools/gen_fixtures.py``)."""
    from taichislam_tpu_torch.tools import gen_fixtures as fx
    from taichislam_tpu_torch.utils.synthetic_scene import orbit_sequence
    path = fx.fixture_root() / f"bench_scene_v2_{n_frames}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["depth"], z["Rs"], z["Ts"]
    depth, Rs, Ts, _ = orbit_sequence(n_frames=n_frames, noise_mm=3.0)
    fx.write_whole(path, lambda f: np.savez(f, depth=depth, Rs=Rs, Ts=Ts))
    return depth, Rs, Ts


def bench_config():
    """The JAX bench's map (``bench.py:104-109``): 10 x 10 m at 5 cm, V =
    16, max ray 3 m, 2048 blocks, float16 storage; the capacities start at
    the scene's recorded steady state and are re-sized by the run."""
    from taichislam_tpu_torch.core.config import TSDFConfig
    return TSDFConfig(
        map_scale=(10.0, 10.0), voxel_scale=0.05, num_voxel_per_blk_axis=16,
        max_ray_length=3.0, min_ray_length=0.3, recast_step=2,
        max_blocks=2048, max_bins=8192, max_submap_num=64,
        max_touched_blocks=256, max_march_lanes=524288,
        storage_dtype="float16")


class Frames(NamedTuple):
    """A window staged on one device: depth (F, h, w) int32, Rs (F, 3, 3),
    Ts (F, 3) and K (9,) f32."""
    depth: torch.Tensor
    Rs: torch.Tensor
    Ts: torch.Tensor
    K: torch.Tensor


def stage_frames(depth, Rs, Ts, K, device) -> Frames:
    """Copy a window to ``device`` once, outside every timed region."""
    dev = torch.device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return Frames(torch.as_tensor(np.asarray(depth, np.int32), device=dev),
                  f32(Rs), f32(Ts), f32(K))


class BenchState:
    """The state a window writes, its entry state and the ESDF carries
    (esdf, fixed, pending, seen_tsdf, seen_obs). :meth:`reset` writes the
    entry state back and zeroes the carries in place, so that every pass
    replays the same graphs."""

    def __init__(self, cfg, device):
        from taichislam_tpu_torch.core.grid import clone_state
        from taichislam_tpu_torch.ops.tsdf import make_tsdf_state
        dev = torch.device(device)
        self.state = make_tsdf_state(cfg, device=dev)
        self.entry = clone_state(self.state)
        nb, V3 = cfg.max_blocks + 1, cfg.grid.voxels_per_block
        self.carries = (
            torch.zeros((nb, V3), device=dev),
            torch.zeros((nb, V3), dtype=torch.int8, device=dev),
            torch.zeros((nb,), dtype=torch.bool, device=dev),
            torch.zeros((nb, V3), device=dev),
            torch.zeros((nb, V3), dtype=torch.bool, device=dev))

    def reset(self):
        from taichislam_tpu_torch.core.grid import copy_state_
        copy_state_(self.state, self.entry)
        for t in self.carries:
            t.zero_()


def run_window(cfg, esdf_cap, budget, bs: BenchState, frames: Frames):
    """The JAX bench's ``run_all`` (``bench.py:122-175``): every frame of
    the window integrated and, with ``esdf_cap``, the gated incremental
    ESDF at ``budget`` sweeps on a working set of ``esdf_cap`` blocks;
    from ``bs`` as it stands. Returns 0-d tensors: ``checksum`` (the sum
    of the TSDF and the ESDF) and the window maxima ``dropped``,
    ``esdf_overflow``, ``bins_total`` and ``live_lanes``."""
    from taichislam_tpu_torch.ops import sequence as seq
    inputs = (frames.depth, None, frames.Rs, frames.Ts, frames.K, frames.K,
              0)
    if esdf_cap:
        *_, stats = seq.integrate_esdf_sequence(
            cfg, budget, esdf_cap, bs.state, *bs.carries, *inputs)
        overflow = stats["max_esdf_overflow"]
    else:
        _, stats = seq.integrate_depth_sequence(cfg, bs.state, *inputs)
        overflow = torch.zeros((), dtype=torch.int32,
                               device=stats["max_dropped"].device)
    checksum = (bs.state.channels["TSDF"].float().sum() +
                bs.carries[0].sum())
    return {"checksum": checksum, "dropped": stats["max_dropped"],
            "esdf_overflow": overflow, "bins_total": stats["max_bins_total"],
            "live_lanes": stats["max_live_lanes"]}


def read_window(w):
    """A window's results on the host: ints, the checksum a float."""
    return {k: float(v) if k == "checksum" else int(v) for k, v in w.items()}


def next_capacities(cfg, esdf_cap, w):
    """One step of the JAX bench's grow rule (``bench.py:187-213``) from a
    window's maxima ``w`` (:func:`read_window`). Returns (cfg, esdf_cap,
    done): an ESDF overflow doubles the block cap until it covers it; a
    fusion drop grows the bins (never below the bucket of the worst
    frame), re-buckets the march lanes and doubles the touched blocks;
    without a drop the bins shrink to the worst frame's bucket and the
    lanes follow the worst frame's live count; done when neither moves."""
    from taichislam_tpu_torch.models.dense_tsdf import bin_bucket_for
    want = bin_bucket_for(w["bins_total"])
    want_lanes = bin_bucket_for(w["live_lanes"])
    if w["esdf_overflow"] > 0:
        need = esdf_cap + w["esdf_overflow"]
        while esdf_cap < need:
            esdf_cap *= 2
        return cfg, esdf_cap, False
    if w["dropped"] == 0 and want >= cfg.max_bins and \
            cfg.max_march_lanes == want_lanes:
        return cfg, esdf_cap, True
    if w["dropped"] == 0 and want < cfg.max_bins:
        cfg = dataclasses.replace(cfg, max_bins=want,
                                  max_march_lanes=want_lanes)
    elif w["dropped"] == 0:
        cfg = dataclasses.replace(cfg, max_march_lanes=want_lanes)
    else:
        cfg = dataclasses.replace(
            cfg, max_bins=max(want, cfg.max_bins),
            max_march_lanes=want_lanes,
            max_touched_blocks=cfg.max_touched_blocks * 2)
    return cfg, esdf_cap, False


def timed(dev, fn):
    """(ms, result) of ``fn()``: CUDA events around it on the card, the
    host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return 1000.0 * (time.perf_counter() - t0), out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b), out


def launch_counts():
    """The kernels' launch counters: K1, K2, K3."""
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1
    return {"K1": k1.segmented_block_reduce.launches,
            "K2": ks.esdf_sweep.launches,
            "K3": ks.esdf_sweep_loop.launches}


def assert_no_drop(cfg, w, when):
    if w["dropped"] or w["esdf_overflow"] or w["bins_total"] > cfg.max_bins:
        raise AssertionError(f"capacity drops {when}: {w} (bin bucket "
                             f"{cfg.max_bins})")


def size_and_time(cfg, esdf_cap, budget, bs: BenchState, frames: Frames):
    """Grow capacities until the window drops nothing, then time
    :data:`PASSES` passes. Returns a dict: ``ms_per_frame`` (the best
    pass), ``median_ms_per_frame``, ``spread_ms_per_frame`` (largest less
    smallest), ``passes_ms``, ``cfg``, ``esdf_cap``, ``rounds`` (windows
    run to size), ``timed_captures`` (graphs captured during the timed
    passes: 0), ``launches_per_frame`` of the timed passes, ``window``
    (the last pass's maxima and checksum) and the :class:`BenchState`."""
    from taichislam_tpu_torch.ops import sequence as seq
    dev = bs.state.table.device
    n = frames.depth.shape[0]

    def window():
        bs.reset()
        return read_window(run_window(cfg, esdf_cap, budget, bs, frames))
    w = window()
    rounds = 1
    for _ in range(SIZE_ROUNDS):
        cfg, esdf_cap, done = next_capacities(cfg, esdf_cap, w)
        if done:
            break
        w = window()
        rounds += 1
    assert_no_drop(cfg, w, "after sizing")

    captures0, launches0 = seq.graph_cache.captures, launch_counts()
    passes, sums = [], set()
    for _ in range(PASSES):
        bs.reset()
        ms, out = timed(dev, lambda: run_window(cfg, esdf_cap, budget, bs,
                                                frames))
        w = read_window(out)
        assert_no_drop(cfg, w, "in a timed pass")
        passes.append(ms)
        sums.add(w["checksum"])
    captures = seq.graph_cache.captures - captures0
    if captures:
        raise AssertionError(f"{captures} graph captures in the timed "
                             f"passes")
    if len(sums) != 1:
        raise AssertionError(f"timed passes disagree: checksums {sums}")
    launches1 = launch_counts()
    return {"ms_per_frame": min(passes) / n,
            "median_ms_per_frame": float(np.median(passes)) / n,
            "spread_ms_per_frame": (max(passes) - min(passes)) / n,
            "passes_ms": passes, "cfg": cfg, "esdf_cap": esdf_cap,
            "rounds": rounds, "timed_captures": captures,
            "launches_per_frame": {k: (launches1[k] - launches0[k]) /
                                   (PASSES * n) for k in launches1},
            "window": w, "bench_state": bs}


def mc_timer(cfg, max_triangles, cap, mask, state, dev):
    """``timed(k)``: the best of 3 runs of ``k`` back-to-back full
    extractions (``ops/marching_cubes.extract_mesh``, which reads the host
    as it goes), after one warm run; ms."""
    from taichislam_tpu_torch.ops import marching_cubes as mc_ops
    thres = cfg.tsdf_surface_thres

    def run(k):
        for _ in range(k):
            mc_ops.extract_mesh(cfg, max_triangles, 1, cap, state, 0, thres,
                                block_mask=mask)

    def timed_k(k):
        timed(dev, lambda: run(k))
        return min(timed(dev, lambda: run(k))[0] for _ in range(3))
    return timed_k


def device_info(dev):
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    CPU: its name and no power limit)."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in line.split(","))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        name, limit = torch.cuda.get_device_name(dev), "not measured"
    return {"name": name, "power_limit": limit}


def log_row(name, r):
    note(f"{name}: best {r['ms_per_frame']:.3f} ms/frame, median "
         f"{r['median_ms_per_frame']:.3f}, spread "
         f"{r['spread_ms_per_frame']:.3f} over {PASSES} passes; sized in "
         f"{r['rounds']} windows: max_bins {r['cfg'].max_bins} "
         f"max_march_lanes {r['cfg'].max_march_lanes} max_touched_blocks "
         f"{r['cfg'].max_touched_blocks} esdf_cap {r['esdf_cap']}; window "
         f"{r['window']}; captures in the timed passes "
         f"{r['timed_captures']}; launches per frame "
         f"{r['launches_per_frame']}")


def run_bench(frames: Frames):
    """Every row of the bench over ``frames``. Returns (the JSON object
    less ``device``, the rows by name: ``fusion``, ``primary``,
    ``drained``, ``big`` as :func:`size_and_time` returns them)."""
    from taichislam_tpu_torch.core.grid import clone_state
    from taichislam_tpu_torch.ops import marching_cubes as mc_ops
    from taichislam_tpu_torch.ops import tsdf as tsdf_ops
    dev = frames.depth.device
    n = frames.depth.shape[0]
    cfg = bench_config()
    rows = {}

    note("sizing fusion-only")
    rows["fusion"] = fuse = size_and_time(cfg, None, 6, BenchState(cfg, dev),
                                          frames)
    log_row("fusion only", fuse)
    cfg_sized = fuse["cfg"]
    # the last pass fused the whole window from the empty map: the map
    # the JAX bench builds for its mesh rows
    full_state = clone_state(fuse["bench_state"].state)

    # primary: fusion + per-frame incremental ESDF at the production
    # field knobs (raise hysteresis 0.5 voxels, convergence eps 2 mm),
    # 3 sweeps a frame, residual wavefronts re-queued
    esdf_cfg = dataclasses.replace(cfg_sized, esdf_raise_slack_voxels=0.5,
                                   esdf_converge_eps=2e-3)
    note("fusion+esdf budget 3")
    rows["primary"] = prim = size_and_time(esdf_cfg, 256, 3,
                                           BenchState(esdf_cfg, dev), frames)
    log_row("fusion + ESDF, budget 3", prim)
    note("fusion+esdf drained")
    rows["drained"] = drained = size_and_time(
        esdf_cfg, 256, 32, BenchState(esdf_cfg, dev), frames)
    log_row("fusion + ESDF, budget 32", drained)

    note("marching cubes full map")
    run_mc = mc_timer(cfg_sized, 1 << 18, 256, None, full_state, dev)
    mc_ms = (run_mc(6) - run_mc(2)) / 4

    # incremental re-mesh: one more frame on the converged map, its
    # touched blocks 26-dilated, extraction restricted to that set
    note("incremental re-mesh")
    st2 = clone_state(full_state)
    st2, stats2 = tsdf_ops.integrate_depth(
        cfg_sized, st2, frames.depth[0], None, frames.Rs[0],
        frames.Ts[0], frames.K, frames.K, 0)
    dil = mc_ops.dilate_blocks(cfg_sized, st2, 0, stats2["touched_blocks"])
    # size the caps in one probe: the masked surface blocks are at most
    # n_dirty, so a pow2-of-n_dirty block cap never drops, and the probe's
    # large triangle cap reports the exact total
    n_dirty = int(dil.sum())
    cap_inc = 64
    while cap_inc < n_dirty:
        cap_inc *= 2
    probe = mc_ops.extract_mesh(cfg_sized, 1 << 18, 1, cap_inc, st2, 0,
                                cfg_sized.tsdf_surface_thres, block_mask=dil)
    pk = [int(probe[k]) for k in ("total_triangles",
                                  "surface_blocks_dropped",
                                  "num_surface_blocks")]
    if pk[1]:
        raise AssertionError(f"re-mesh probe dropped surface blocks: {pk}")
    mt_inc = 1 << 12
    while mt_inc < pk[0]:
        mt_inc *= 2
    cap_kept = 64
    while cap_kept < pk[2]:
        cap_kept *= 2
    run_inc = mc_timer(cfg_sized, mt_inc, cap_kept, dil, st2, dev)
    mesh_update_ms = (run_inc(6) - run_inc(2)) / 4
    note(f"marching cubes: full map {mc_ms:.3f} ms, re-mesh "
         f"{mesh_update_ms:.3f} ms ({n_dirty} dirty blocks, {pk[2]} with "
         f"surface, caps {cap_kept} blocks / {mt_inc} triangles)")

    note("8192-block map")
    big_cfg = dataclasses.replace(cfg_sized, max_blocks=8192,
                                  map_scale=(40.0, 10.0))
    rows["big"] = big = size_and_time(big_cfg, None, 6,
                                      BenchState(big_cfg, dev), frames)
    log_row("fusion only, 8192 blocks", big)

    fps_esdf = 1000.0 / prim["ms_per_frame"]
    out = {
        "metric": "depth_fusion_esdf_fps_640x480_5cm",
        "value": round(fps_esdf, 2),
        "unit": "frames/sec",
        "secondary": {
            "fusion_only_fps": round(1000.0 / fuse["ms_per_frame"], 2),
            "fusion_esdf_ms_per_frame": round(prim["ms_per_frame"], 3),
            "esdf_budget_sweeps": 3,
            "esdf_drained_fps": round(1000.0 / drained["ms_per_frame"], 2),
            "marching_cubes_full_map_ms": round(mc_ms, 2),
            "mesh_update_ms": round(mesh_update_ms, 2),
            "mesh_dirty_blocks": n_dirty,
            "mesh_dirty_surface_blocks": pk[2],
            "fusion_fps_8192_blocks": round(1000.0 / big["ms_per_frame"], 2),
            "n_frames": n,
            "sized_bins": cfg_sized.max_bins,
            "sized_march_lanes": cfg_sized.max_march_lanes,
        },
    }
    return out, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    from taichislam_tpu_torch.core.device import resolve_device
    from taichislam_tpu_torch.utils.synthetic_scene import D435_K
    dev = resolve_device("cpu" if args.cpu else None)
    note(f"device {dev}")
    depth, Rs, Ts = make_inputs(N_FRAMES)
    note("scene rendered")
    frames = stage_frames(depth, Rs, Ts, D435_K, dev)
    note("frames staged")
    out, _ = run_bench(frames)
    print(json.dumps({**out, "device": device_info(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
