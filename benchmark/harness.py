"""One run of a cell: set-up, the window, the metrics and the check.

``run_cell`` works on any device: on the card it times with CUDA events
and can trace; on the CPU (the tests) it times with the host clock and does
not trace. ``node_factory`` and ``storage_dtype`` are for the control and
the fault tests, which run the same path with the program changed under it.
"""

from __future__ import annotations

import bisect
import sys
import time
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np

from benchmark import check, stats
from benchmark.loop import DeviceClock, HostClock, run_window
from benchmark.reference.geometry import quaternion_from_matrix
from benchmark.reference.node import DEFAULTS, NodeReference, intrinsics
from benchmark.trace import Tracer, busy_s, frame_windows


def log(msg: str) -> None:
    print(f"[benchmark {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def pose_msg(R, T):
    q = quaternion_from_matrix(R)
    return SimpleNamespace(
        position=SimpleNamespace(x=float(T[0]), y=float(T[1]),
                                 z=float(T[2])),
        orientation=SimpleNamespace(x=float(q[0]), y=float(q[1]),
                                    z=float(q[2]), w=float(q[3])))


IDENTITY = pose_msg(np.eye(3), np.zeros(3))


def keyframe_rule(every):
    """The traffic's ``keyframe_every`` as a test of stream frame ``g``: a
    whole number ``n``, every ``n``-th frame of the stream a keyframe (1:
    each frame, as a VIO front end flags frames with parallax; 0: none)."""
    if isinstance(every, bool) or not isinstance(every, int) or every < 0:
        raise ValueError(f"keyframe_every: want a whole number >= 0, got "
                         f"{every!r}")
    return lambda g: every > 0 and g % every == 0


class Frames:
    """The scene's frames as the node receives them: a VIOFrame-shaped
    frame (pose, identity extrinsic, the keyframe flag of the traffic's
    rule), the uint16 depth as an Image-shaped message and, textured, the
    rgb8 image."""

    def __init__(self, scene: dict, textured: bool, keyframe_every=1):
        self.is_keyframe = keyframe_rule(keyframe_every)
        self.n = scene["depth"].shape[0]
        h, w = scene["depth"].shape[1:]
        self.depth = [SimpleNamespace(width=w, height=h, data=d.tobytes())
                      for d in scene["depth"]]
        self.image = [SimpleNamespace(width=w, height=h, data=t.tobytes())
                      for t in scene["texture"]] if textured else None
        self.poses = [pose_msg(R, T)
                      for R, T in zip(scene["Rs"], scene["Ts"])]

    def frame(self, g: int):
        """Frame ``g`` of the stream: orbit sample ``g mod n``."""
        src = g % self.n
        return SimpleNamespace(
            frame_id=g, is_keyframe=self.is_keyframe(g),
            odom=SimpleNamespace(pose=SimpleNamespace(pose=self.poses[src])),
            extrinsics=[IDENTITY]), src


def make_node(params: dict, device, publish, comm: str,
              storage_dtype=None, node_factory=None):
    from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore
    cls = TaichiSLAMNodeCore
    if storage_dtype is not None:
        class cls(TaichiSLAMNodeCore):          # noqa: N801
            def get_general_mapping_opts(self):
                opts = super().get_general_mapping_opts()
                opts["storage_dtype"] = storage_dtype
                return opts
    kw = {}
    if comm == "loopback":
        from taichislam_tpu_torch.utils.comm import (LoopbackTransport,
                                                     SLAMComm)
        kw["comm"] = SLAMComm(int(params.get("~drone_id", 1)),
                              transport=LoopbackTransport(
                                  LoopbackTransport.Hub()))
    node = cls(get_param=lambda name, default=None: params.get(name,
                                                                default),
               publish_pointcloud=publish, device=device, **kw)
    return node if node_factory is None else node_factory(node)


class NodeDriver:
    """Stages frames into the node and calls its main-loop step, keeping
    what the reference needs: the frames processed, in order, and the
    clouds published at the frames to compare."""

    def __init__(self, node, frames: Frames, textured: bool, offset: int,
                 keyframe_step: int, submap: bool):
        self.node, self.frames, self.textured = node, frames, textured
        self.offset = offset            # window frame 0 is stream frame
        self.step, self.submap = keyframe_step, submap
        self.staged = None
        self.processed = []             # (stream frame, sample, message)
        self.boundary = []              # per processed frame
        self.pub = []
        self.published = {}             # processed count -> clouds
        self.keep = set()               # processed counts to keep clouds of
        self.last = None
        self.frame_range = None         # a traced range per call, or None

    def publish(self, xyz, colors, has_rgb):
        self.pub.append((xyz, colors))

    def outputs(self):
        """What the frame published, each cloud as (xyz, values): the
        surface cloud with its colours; the ESDF slice with the distances
        the node exported for it (its colours are jet of them)."""
        out = list(self.pub)
        m = self.node.mapping
        if len(out) == 2 and hasattr(m, "export_ESDF"):
            n = m.num_export_ESDF_particles
            out[1] = (out[1][0], m.export_ESDF[:n, None])
        return out

    def stage(self, k: int):
        g = self.offset + k
        frame, src = self.frames.frame(g)
        if self.textured:
            tex = self.node.decode_image(self.frames.image[src], False)
            self.node.stage_depth(frame, self.frames.depth[src], tex)
        else:
            self.node.stage_depth(frame, self.frames.depth[src])
        self.staged = (g, src, frame)

    def process(self) -> bool:
        g, src, frame = self.staged
        n = len(self.processed)
        # the submap layer's rule: a keyframe at a multiple of its step
        self.boundary.append(self.submap and n > 0 and
                             bool(frame.is_keyframe) and n % self.step == 0)
        self.pub = []
        raised = False
        with (self.frame_range() if self.frame_range else nullcontext()):
            try:
                self.node.process_taichi()
                self.node.handle_comm()
            except Exception as e:      # a failed frame counts as failed
                print(f"benchmark: frame {g} raised {type(e).__name__}: "
                      f"{e}")
                raised = True
        self.processed.append((g, src, frame))
        count = len(self.processed)
        if not raised:
            self.last = (count, self.outputs())
            if count in self.keep:
                self.published[count] = self.last[1]
        return raised


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_proc=None, storage_dtype=None, node_factory=None,
             frames_override=None):
    """One run; returns the result line (a dict)."""
    import torch
    if t_proc is None:
        t_proc = time.time()
    on_card = device.type == "cuda"
    p = cell.params
    node_p = dict(DEFAULTS, **p)
    tr = cell.traffic
    textured = bool(node_p["~texture_enabled"])
    submap = bool(node_p["~enable_submap"])
    if frames_override is not None:
        tr = dict(tr, **frames_override)
    scene_mod = cell.scene()
    scene = scene_mod.render(tr, intrinsics(node_p, "Kdepth"), seed, device,
                             textured)
    frames = Frames(scene, textured, tr["keyframe_every"])
    log(f"scene: {frames.n} frames rendered")
    drv = NodeDriver(None, frames, textured, int(tr["warmup_frames"]),
                     int(node_p["~keyframe_step"]), submap)
    drv.node = make_node(p, device, drv.publish, cell.config["comm"],
                         storage_dtype, node_factory)
    # warm-up: the first frames of the stream, back to back
    for k in range(int(tr["warmup_frames"])):
        drv.stage(k - drv.offset)
        if drv.process():
            raise RuntimeError("a warm-up frame raised")
    # the frames whose clouds are compared: some drawn from the seed
    rng = np.random.default_rng(seed)
    horizon = int(tr["rate_hz"] * seconds) // 3
    for c in rng.choice(np.arange(1, horizon + 1), size=min(
            int(tr.get("check_frames", 0)), horizon), replace=False):
        drv.keep.add(len(drv.processed) + int(c))
    counters = (lambda: _counters()) if on_card else (lambda: {})
    clock = DeviceClock(torch) if on_card else HostClock()
    tracer = None
    if trace and on_card:
        # the span closes the window, so the frames before it are untouched
        skip = max(0.0, seconds - float(tr["trace_tail_s"])) * 1000.0
        tracer = Tracer(torch, skip, int(tr["trace_frames"]), clock, drv)
        tracer.warm()
    if on_card:
        torch.cuda.synchronize()
    before = counters()
    setup_s = time.time() - t_proc
    log(f"set-up {setup_s:.1f} s; window of {seconds} s")
    recs, attempted, dropped = run_window(
        drv, clock, tr["loop"], float(tr["rate_hz"]), seconds,
        on_frame=tracer.on_frame if tracer else None)
    if tracer is not None:
        tracer.stop(len(recs))
        if tracer.started:
            for r in recs[tracer.first:]:
                r["traced"] = True
    after = counters()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    n0 = int(tr["warmup_frames"])
    for r, b in zip(recs, drv.boundary[n0:]):
        r["boundary"] = b
    raised = sum(r["raised"] for r in recs)
    run = {"frames": recs, "attempted": attempted, "dropped": dropped,
           "setup_s": setup_s, "peak_bytes": peak, "counters": (before,
                                                               after),
           "trace": tracer.result() if tracer else None, "seconds": seconds}

    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": False, "attempted": attempted,
            "failed": dropped + raised, "metrics": metrics,
            "device": dev_info}
    if run["trace"] is not None:
        dev_info["busy_s"], dev_info["window_s"] = busy_s(run["trace"])
        line["breakdown"] = breakdown(run["trace"])

    log(f"window: {len(recs)} frames processed, {dropped} dropped, "
        f"{raised} raised")
    t_ref = time.time()
    bounds = (scene_mod.BOUNDS_LO, scene_mod.BOUNDS_HI)
    numbers = compare(cell, drv, scene, bounds, device)
    log(f"reference and comparison {time.time() - t_ref:.1f} s: {numbers}")
    ok, rows = check.judge(numbers, cell.limits or {})
    line["correct"] = bool(ok and raised == 0)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return line


def _counters() -> dict:
    from taichislam_tpu_torch.ops import graphs, sequence
    return {"graphs": {k: v[0] for k, v in graphs.counts().items()},
            "sequence_captures": sequence.graph_cache.captures}


def breakdown(t) -> dict:
    """The ten device operations with the most time in the span, and the
    ten host ranges under which the device sat idle longest inside the
    frames' windows (``trace.frame_windows``)."""
    lo, hi = t["span"]
    by_op = {}
    for _, name, s, e in t["device"]:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            name = short_name(name)
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    idle = {}
    host = sorted(t["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle_iv = stats.intersect(
        stats.gaps([(s, e) for _, _, s, e in t["device"]], lo, hi),
        frame_windows(t))
    for g0, g1 in idle_iv:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid)
        name = "host (no traced range)"
        best = None
        for h in host[max(0, i - 300):i]:
            if h[2] >= mid and (best is None or h[1] >= best[1]):
                best = h
        if best is not None:
            name = best[0]
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list, at most
    120 characters."""
    name = name[5:] if name.startswith("void ") else name
    anon = "(anonymous namespace)::"
    name = name[len(anon):] if name.startswith(anon) else name
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


def compare(cell, drv, scene, bounds, device) -> dict:
    """Replay the processed frames through the reference and measure the
    program's map and clouds against it."""
    import torch
    ref = NodeReference(cell.params, bounds, device)
    spec = ref.spec
    mapping = drv.node.mapping
    # the program's state, read before the reference runs
    if ref.submap:
        col = mapping.submap_collection
        prog = {"sub": check.program_voxels(col.state, spec,
                                            ("TSDF", "W_TSDF")),
                "glob": check.program_voxels(mapping.global_map.state, spec,
                                             ("TSDF", "W_TSDF"))}
    else:
        chans = ("TSDF", "W_TSDF") + (("color",) if ref.texture else ())
        prog = {"map": check.program_voxels(mapping.state, spec, chans)}
        if ref.esdf:
            part = mapping.esdf_observed
            prog["esdf"] = check.program_voxels(
                _as_state(mapping.state, part), spec, (),
                extra={"esdf": mapping.esdf})
    published = dict(drv.published)
    if drv.last is not None:
        published[drv.last[0]] = drv.last[1]
    del mapping
    drv.node = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    depth = scene["depth"]
    tex = scene["texture"]
    for n, (g, src, frame) in enumerate(drv.processed, start=1):
        d = torch.from_numpy(depth[src].astype(np.int32)).to(device)
        t = torch.from_numpy(tex[src]).to(device) if ref.texture else None
        ref.frame(frame, d, t, export=n in published)
    out = {"reference_outside": float(ref.outside_total())}
    vs = ref.voxel
    if ref.submap:
        ijk, sub, tsdf, w = ref.submap_voxels()
        r = check.Voxels(check.voxel_key(spec, ijk, sub), TSDF=tsdf,
                         W_TSDF=w)
        out.update(check.tsdf_numbers(prog["sub"], r, vs, "submap_"))
        gm = ref.global_map(spec)
        out["reference_outside"] += gm.outside
        rg = check.grid_voxels(gm, spec, gm.obs, TSDF=gm.tsdf.float(),
                               W_TSDF=gm.w.float())
        out.update(check.tsdf_numbers(prog["glob"], rg, vs, "global_"))
    else:
        g = ref.grid
        vals = {"TSDF": g.tsdf.float(), "W_TSDF": g.w.float()}
        if ref.texture:
            vals["color"] = g.color.float().T
        rg = check.grid_voxels(g, spec, g.obs, **vals)
        out.update(check.tsdf_numbers(prog["map"], rg, vs))
        if ref.esdf:
            e, part = ref.esdf_field()
            re = check.grid_voxels(g, spec, part, esdf=e)
            out.update(check.esdf_gaps(prog["esdf"], re))
        worst = {}
        for n, clouds in published.items():
            want = ref.exports.get(n)
            if want is None:
                continue
            # the surface cloud first, then the ESDF slice
            for i, (got, exp) in enumerate(zip(clouds, want)):
                if i == 0:
                    d, n_ref = check.cloud_gaps(spec, vs, got, exp, device)
                    nums = {"surface_gap": float(d.sum()) / max(n_ref, 1)}
                else:
                    d, _ = check.cloud_gaps(spec, vs, got, exp, device,
                                            lone_cost=vs)
                    nums = {"slice_gap": float(d.mean()) if d.numel()
                            else 0.0,
                            "slice_gap_p90": check.quantile(d, 0.9)}
                for name, v in nums.items():
                    worst[name] = max(worst.get(name, 0.0), v)
        out.update(worst)
    return out


def _as_state(state, observed):
    """``state`` with ``observed`` in place of its observed channel."""
    ch = dict(state.channels)
    ch["TSDF_observed"] = observed.to(dtype=state.channels[
        "TSDF_observed"].dtype)
    return state._replace(channels=ch)
