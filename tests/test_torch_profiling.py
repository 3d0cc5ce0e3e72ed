"""The port's spans, counters and frame records (utils/profiling.py), the
node's use of them on the CPU, the kernels' work counters through a
capture's tally, and the benchmark's readers of them (benchmark/spans.py
and the metrics that read it) on a hand-made traced run."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmark import spans as bspans  # noqa: E402
from benchmark.cells import Cell  # noqa: E402
from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore  # noqa: E402
from taichislam_tpu_torch.ops import graphs  # noqa: E402
from taichislam_tpu_torch.ops.kernels import build  # noqa: E402
from taichislam_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture
def prof():
    """A clean module state, tracing off, restored afterwards."""
    was = profiling._enabled
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(was)
    profiling.reset()


# -- the module --------------------------------------------------------------

def test_off_is_one_shared_noop_and_counters_count(prof):
    a, b = prof.span("node.recast"), prof.span("node.esdf")
    assert a is b and math.isnan(a.ms)
    with a as sp:
        assert sp is a
    prof.frame_begin(0)
    with prof.span("node.decode"):
        pass
    prof.frame_end(lambda: {"x": torch.tensor(1)})
    assert prof.frames() == []
    prof.count("k1/lanes", 7)
    prof.count("k1/lanes")
    t = torch.arange(4)
    assert torch.equal(prof.host_read("unit.site", t), t)
    prof.host_read("unit.site", t[:0])          # moves nothing: not counted
    assert prof.counts() == {"k1/lanes": 8, "host_read/unit.site": 1}


def test_spans_nest_inside_a_cpu_profiler(prof):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as p:
        assert prof.span("x") is not prof.span("y")
        with prof.span("node.stage"):           # joins the next frame
            pass
        prof.frame_begin(3)
        with prof.span("node.recast") as outer:
            with prof.span("node.esdf"):
                prof.host_read("esdf.verdict", torch.ones(2)).sum()
        prof.frame_end(lambda: {
            "bins_dropped": torch.tensor(2, dtype=torch.int32),
            "esdf_pending": torch.tensor(5)})
    assert outer.ms > 0
    ranges = {e.name: e.time_range for e in p.events()
              if e.name.startswith("tsl/")}
    assert set(ranges) == {"tsl/node.stage", "tsl/node.recast",
                           "tsl/node.esdf", "tsl/sync/esdf.verdict",
                           "tsl/trace.scalars"}
    r, i = ranges["tsl/node.recast"], ranges["tsl/node.esdf"]
    assert r.start <= i.start and i.end <= r.end
    [rec] = prof.frames()
    assert rec["frame"] == 3 and rec["profiled"]
    names = [(s["name"], s["parent"]) for s in rec["spans"]]
    assert names == [("node.stage", None), ("node.recast", None),
                     ("node.esdf", 1), ("sync/esdf.verdict", 2),
                     ("trace.scalars", None)]
    for s in rec["spans"]:
        assert 0 < s["t0"] <= s["t1"] and s["e0"] is None   # no events here
    assert rec["t0"] <= rec["spans"][1]["t0"]
    assert rec["counts"] == {"host_read/esdf.verdict": 1}
    assert rec["scalars"] == {"bins_dropped": 2.0, "esdf_pending": 5.0}


def test_enable_records_every_frame_in_a_bounded_ring(prof, monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    prof.reset()
    prof.enable(True)
    for f in range(10):
        with prof.span("node.stage"):
            prof.count("host_read/x", f)
        prof.frame_begin(f)
        with prof.span("node.recast"):
            prof.count("k1/launches")
        prof.frame_end()
    recs = prof.frames()
    assert [r["frame"] for r in recs] == [6, 7, 8, 9]
    assert all(not r["profiled"] for r in recs)
    assert [r["counts"] for r in recs] == [
        {"host_read/x": f, "k1/launches": 1} for f in range(6, 10)]
    assert [s["name"] for s in recs[0]["spans"]] == ["node.stage",
                                                     "node.recast"]
    prof.enable(False)
    prof.frame_begin(10)
    prof.frame_end()
    assert len(prof.frames()) == 4


def test_spans_of_another_thread_stay_off_the_records(prof):
    import threading
    prof.enable(True)
    prof.frame_begin(0)
    seen = []
    worker = threading.Thread(target=lambda: seen.append(
        prof.host_read("submap.wire_buffer", torch.ones(3))))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive() and len(seen) == 1
    prof.frame_end()
    [rec] = prof.frames()
    assert rec["spans"] == []
    assert rec["counts"] == {"host_read/submap.wire_buffer": 1}


def test_host_read_start_counts_once_and_waits_on_any_thread(prof):
    """``host_read_start``: counted once, when queued; its wait returns the
    tensor on another thread. A CPU tensor is read at once, on the caller's
    thread, so its span is in the caller's record; an empty one moves
    nothing and is not counted."""
    import threading
    prof.enable(True)
    prof.frame_begin(0)
    t = torch.arange(6)
    wait = prof.host_read_start("exports.sparse_buffer", t)
    seen = []
    worker = threading.Thread(target=lambda: seen.append(wait()))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive() and torch.equal(seen[0], t)
    assert torch.equal(prof.host_read_start("unit.site", t[:0])(), t[:0])
    prof.frame_end()
    [rec] = prof.frames()
    assert [s["name"] for s in rec["spans"]] == ["sync/exports.sparse_buffer"]
    assert rec["counts"] == {"host_read/exports.sparse_buffer": 1}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_host_read_start_reads_what_the_stream_held(prof, device):
    """The copy is queued behind the work that wrote the tensor and ahead
    of later work that reuses its device memory: the wait, on another
    thread, returns the values at the call."""
    import threading
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the pinned copy and its event")
    n = 1 << 22
    t = torch.arange(n, dtype=torch.int32, device=device) * 3
    wait = prof.host_read_start("unit.site", t)
    del t                       # the allocator may hand its block on
    later = torch.full((n,), -1, dtype=torch.int32, device=device)
    seen = []
    worker = threading.Thread(target=lambda: seen.append(wait()))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and int(later[0]) == -1
    assert seen[0].device.type == "cpu"
    assert torch.equal(seen[0], torch.arange(n, dtype=torch.int32) * 3)
    assert prof.counts() == {"host_read/unit.site": 1}


# -- the kernels' work through a capture's tally -----------------------------

def test_count_adds_the_captured_work_on_each_replay(prof, monkeypatch):
    def kernel():
        pass
    kernel.launches, kernel.site_launches = 0, {}
    work = {"k1/launches": 1, "k1/lanes": 1000, "k1/tile_vals": 40}
    build.count(kernel, "march", work)          # an eager launch
    assert kernel.launches == 1 and prof.counts()["k1/lanes"] == 1000
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with build.capture_tally() as tally:        # a capture runs nothing
        build.count(kernel, "march", work)
        build.count(kernel, None)
    assert tally == [(kernel, "march", work), (kernel, None, None)]
    assert kernel.launches == 1 and prof.counts()["k1/lanes"] == 1000
    for _ in range(3):                          # three replays
        build.add_counts(tally)
    assert kernel.launches == 7 and kernel.site_launches == {"march": 4}
    assert prof.counts() == {"k1/launches": 4, "k1/lanes": 4000,
                             "k1/tile_vals": 160}


def test_unit_capture_is_a_span(prof, monkeypatch):
    class Stand:
        def __init__(self, fn, own=()):
            fn()
    monkeypatch.setattr(graphs, "Captured", Stand)
    unit = graphs.UnitCache("test_profiling_unit")
    try:
        prof.enable(True)
        prof.frame_begin(0)
        unit.capture(graphs.Entry([], {}, torch.device("cpu")), "body",
                     lambda: None)
        prof.frame_end()
    finally:
        graphs.UNITS.pop("test_profiling_unit", None)
    [rec] = prof.frames()
    assert [s["name"] for s in rec["spans"]] == [
        "unit.capture/test_profiling_unit"]
    assert unit.captures == 1


# -- the node on the CPU ------------------------------------------------------

def _pose(x=0.0):
    return SimpleNamespace(position=SimpleNamespace(x=x, y=0.0, z=0.0),
                           orientation=SimpleNamespace(x=0.0, y=0.0, z=0.0,
                                                       w=1.0))


def _frame(i):
    return SimpleNamespace(frame_id=i, is_keyframe=True,
                           odom=SimpleNamespace(pose=SimpleNamespace(
                               pose=_pose(0.05 * i))),
                           extrinsics=[_pose()])


def _depth(h=24, w=32, value=1000):
    return SimpleNamespace(width=w, height=h, data=np.full(
        (h, w), value, np.uint16).tobytes())


def _node(**extra):
    params = {"~enable_multi": False, "~enable_mesher": False,
              "~texture_enabled": False, "~mapping_type": "esdf",
              "~map_size_xy": 6.4, "~map_size_z": 6.4, "~voxel_scale": 0.1,
              "~num_voxel_per_blk_axis": 8, "~max_ray_length": 1.5,
              "~output_map": True, "~disp/max_disp_particles": 65536,
              "~esdf/publish_slice_z": 0.0, "Kdepth/fx": 20.0,
              "Kdepth/cx": 16.0, "Kdepth/fy": 20.0, "Kdepth/cy": 12.0}
    params.update(extra)
    return TaichiSLAMNodeCore(get_param=lambda n, d=None: params.get(n, d),
                              device="cpu")


def _drive(core, frames):
    for f in range(frames):
        core.stage_depth(_frame(f), _depth())
        core.process_taichi()
        core.handle_comm()


def test_node_writes_one_record_per_frame_with_its_stages(prof, capsys):
    core = _node()
    _drive(core, 1)
    assert "t_recast nanms" in capsys.readouterr().out   # tracing off
    prof.enable(True)
    _drive(core, 3)
    assert "t_recast nanms" not in capsys.readouterr().out
    core.updated = False
    core.process_taichi()                       # nothing staged: no frame
    recs = prof.frames()
    assert [r["frame"] for r in recs] == [1, 2, 3]
    for r in recs:
        names = [s["name"] for s in r["spans"]]
        for stage in ("node.stage", "node.recast", "node.decode",
                      "node.esdf", "node.export_surface",
                      "node.export_slice"):
            assert stage in names, (stage, names)
        assert names.count("node.publish") == 2
        by = {s["name"]: i for i, s in enumerate(r["spans"])}
        assert r["spans"][by["node.esdf"]]["parent"] == by["node.recast"]
        assert r["spans"][by["node.decode"]]["parent"] == by["node.recast"]
        c = r["counts"]
        assert c["host_read/tsdf.bin_load"] == 1
        assert c["host_read/esdf.verdict"] >= 1
        assert c["host_read/tsdf.block_count"] == 2
        assert c["host_read/export.surface_packed"] == 1
        assert c["host_read/export.esdf_slice_packed"] == 1
        reads = sum(v for k, v in c.items() if k.startswith("host_read/"))
        syncs = sum(1 for s in r["spans"] if s["name"].startswith("sync/"))
        assert reads == syncs
        assert set(r["scalars"]) == {"num_bins", "bins_dropped",
                                     "esdf_sweeps", "esdf_pending"}
        assert r["scalars"]["bins_dropped"] == 0.0


def test_boundary_spans_only_on_boundary_frames(prof):
    core = _node(**{"~mapping_type": "tsdf", "~enable_submap": True,
                    "~submap_max_disp_particles": 65536,
                    "~keyframe_step": 2})
    prof.enable(True)
    _drive(core, 5)
    recs = prof.frames()
    assert len(recs) == 5
    for k, r in enumerate(recs):
        names = [s["name"] for s in r["spans"]]
        boundary = k > 0 and k % 2 == 0
        # submap.send twice: the hand-off to the wire pool before the
        # refuse, the wait for the publish after it
        for part, n in (("submap.finalize", 1), ("submap.export", 1),
                        ("submap.send", 2), ("submap.refuse", 1)):
            assert names.count(part) == n * boundary, (k, part, names)
        assert names.count("submap.create") == int(k == 0 or boundary)
        if boundary:
            by = {s["name"]: i for i, s in enumerate(r["spans"])}
            fin = by["submap.finalize"]
            assert r["spans"][fin]["parent"] == by["node.recast"]
            for s in r["spans"]:
                if s["name"] in ("submap.export", "submap.send",
                                 "submap.refuse"):
                    assert s["parent"] == fin, s
            assert r["counts"]["host_read/tsdf.fuse_verdict"] >= 1
            assert r["counts"]["host_read/exports.sparse_buffer"] == 1
        else:
            assert "host_read/tsdf.fuse_verdict" not in r["counts"]


# -- the benchmark's readers on a hand-made traced run -----------------------

def _span(name, parent, e0, e1):
    return {"name": name, "parent": parent, "t0": 1, "t1": 2, "e0": e0,
            "e1": e1}


K1 = {"k1/launches": 1, "k1/lanes": 1000, "k1/lane_vals": 5000,
      "k1/key_bytes": 4000, "k1/presorted": 0, "k1/max_touched": 10,
      "k1/tile_vals": 25600}
K3 = {"k3/launches": 1, "k3/rows": 264, "k3/cells": 264 * 18 ** 3}


def _records():
    boundary = {"frame": 0, "profiled": True, "t0": 0, "t1": 9, "spans": [
        _span("node.recast", None, 0.0, 10.0),
        _span("node.decode", 0, 0.0, 1.0),
        _span("submap.finalize", 0, 2.0, 8.0),
        _span("submap.export", 2, 2.0, 3.0),
        _span("submap.send", 2, 3.0, 4.0),
        _span("submap.refuse", 2, 4.0, 7.0),
        _span("node.export_surface", None, 10.0, 13.0),
        _span("node.export_slice", None, 13.0, 15.0)],
        "counts": dict(K1, **K3, **{"host_read/tsdf.bin_load": 1,
                                    "host_read/tsdf.fuse_verdict": 2}),
        "scalars": {}}
    plain = {"frame": 1, "profiled": True, "t0": 10, "t1": 19, "spans": [
        _span("node.recast", None, 0.0, 4.0)],
        "counts": {"host_read/tsdf.bin_load": 1}, "scalars": {}}
    before = dict(plain, frame=-1, profiled=False)
    return [before, boundary, plain]


def _run():
    trace = {"span": (0.0, 1000.0), "frames": 2,
             "calls": [(0.0, 400.0), (500.0, 900.0)],
             "device": [("kernel", "void k1_reduce<int>(int)", 100.0, 110.0),
                        ("kernel", "void k3_loop_kernel<16>()", 120.0,
                         220.0),
                        ("memcpy_dtoh", "Memcpy DtoH", 600.0, 700.0)],
             "host": [("tsl/node.recast", 0.0, 350.0),
                      ("aten::add", 350.0, 400.0),
                      ("tsl/node.export_surface", 500.0, 880.0)]}
    return {"trace": trace, "frames": []}


def _read(name, run):
    return Cell("node_esdf_textured.orbit_backlog").reader(name)(run)


def test_span_metrics_on_a_hand_made_run(prof, monkeypatch):
    monkeypatch.setattr(profiling, "frames", _records)
    run = _run()
    k1_bytes = 4 * (2 * 1000 + 5000) + 4 * (10 + 25600) + 8
    k3_bytes = 12 * 264 * 18 ** 3 + 112 * 264 + 16
    assert bspans.k1_bytes(K1) == k1_bytes
    assert bspans.k3_bytes(K3) == k3_bytes
    want = {
        "recast_ms": ((10.0 - 6.0) + 4.0) / 2,
        "export_ms": (3.0 + 2.0) / 2,
        "refuse_ms": 3.0,
        "submap_send_ms": 2.0,
        "host_reads_per_frame": 4 / 2,
        # 10 us of k1_* and 100 us of k3_loop_kernel* in the span
        "k1_roofline": 100 * k1_bytes / 3.35e12 / 10e-6,
        "k3_roofline": 100 * k3_bytes / 3.35e12 / 100e-6,
        # idle in the windows (0-400, 500-900): 590 us, 520 under tsl/
        "idle_unspanned_share": 70 / 590,
    }
    for name, v in want.items():
        assert _read(name, run) == pytest.approx(v), name
    assert _read("k1_roofline", run) < 100


@pytest.mark.parametrize("name", ["recast_ms", "export_ms", "refuse_ms",
                                  "submap_send_ms", "host_reads_per_frame",
                                  "k1_roofline", "k3_roofline",
                                  "idle_unspanned_share"])
def test_span_metrics_read_nothing_without_matching_records(prof,
                                                            monkeypatch,
                                                            name):
    run = _run()
    monkeypatch.setattr(profiling, "frames", lambda: _records()[:2])
    assert _read(name, run) is None             # 1 record, 2 frames
    monkeypatch.delattr(profiling, "frames")    # a program without them
    assert _read(name, run) is None
    assert _read(name, {"trace": None, "frames": []}) is None
