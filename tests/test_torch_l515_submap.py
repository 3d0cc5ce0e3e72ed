"""The L515 launch file's textured 5 cm submap drone (the benchmark's
``l515_submap_textured`` configuration) on the CPU: its parameters against
the launch file and the node's defaults, the node core at those parameters
against the plain reference with colour
(``benchmark/reference/textured_submaps.py``), and the refuse's spans and
counters (``fusion.reduce`` ⊃ ``fusion.k1``, ``fusion.apply``,
``fusion/k1/*``, ``fusion/retries``, ``submap/wire_bytes``) and the
benchmark's readers of them."""

import ast
import json
import xml.etree.ElementTree as ET
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.cells import Cell  # noqa: E402
from benchmark.reference.textured_submaps import (  # noqa: E402
    run_with_colors)
from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore  # noqa: E402
from taichislam_tpu_torch.utils import profiling  # noqa: E402
from submap_wire import (assert_same_payloads,  # noqa: E402
                         record_inline_payloads)

ROOT = Path(__file__).resolve().parent.parent
CELL = "l515_submap_textured.orbit30"
# a 160 x 120 corner of the camera, 30 distinct frames, 12 warm-up frames
TINY = {"height": 120, "width": 160, "distinct_frames": 30,
        "warmup_frames": 12, "check_frames": 1}


def _launch_params():
    """{node parameter: value} the L515 launch file sets: its ``<param>``s
    through their ``<arg>`` defaults, and its ``<rosparam>`` block."""
    import yaml
    root = ET.parse(ROOT / "launch" / "taichislam-L515.launch").getroot()
    args = {a.get("name"): a.get("default") for a in root.iter("arg")}
    node = root.find("node")
    out = {}
    for p in node.iter("param"):
        v = p.get("value")
        if v.startswith("$(arg "):
            v = args[v[len("$(arg "):-1]]
        typ = p.get("type")
        v = {"boolean": lambda s: s == "true", "int": int,
             "string": str}[typ](v)
        out["~" + p.get("name")] = v

    def flat(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                flat(v, prefix + k + "/")
            else:
                out[prefix + k] = v
    flat(yaml.safe_load(node.find("rosparam").text), "")
    # the camera intrinsics are read without the private prefix
    for k in [k for k in out if k.startswith(("Kdepth/", "Kcolor/"))]:
        out[k.lstrip("~")] = out.pop(k)
    out = {("~" + k if not k.startswith(("~", "K")) else k): v
           for k, v in out.items()}
    return out


def _node_defaults():
    """{parameter: literal default} of every ``get_param`` in
    ``node/core.py`` (``g(name, default)`` / ``self.get_param(...)``)."""
    tree = ast.parse((ROOT / "taichislam_tpu_torch" / "node" /
                      "core.py").read_text())
    out = {}
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and len(n.args) == 2):
            continue
        f = n.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
        if name not in ("g", "get_param"):
            continue
        try:
            key, default = ast.literal_eval(n.args[0]), \
                ast.literal_eval(n.args[1])
        except ValueError:
            continue
        out[key] = default
    return out


def test_config_is_the_launch_file_over_the_node_defaults():
    launch = _launch_params()
    defaults = _node_defaults()
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "l515_submap_textured.json").read_text())
    params = cfg["params"]
    assert cfg["reduced"] == [] and cfg["comm"] == "loopback"
    # what the launch file sets that the node core reads is all there
    for k, v in launch.items():
        if k in defaults:
            assert params[k] == v, k
    for k in ("~voxel_scale", "~texture_enabled", "~enable_submap",
              "Kdepth/fx", "Kcolor/cy"):
        assert k in launch
    assert launch["~voxel_scale"] == 0.05 and launch["~texture_enabled"]
    # every other key is the node's own default
    for k, v in params.items():
        assert k in defaults, k
        assert v == (launch[k] if k in launch else defaults[k]), k
    for k in ("~max_ray_length", "~min_ray_length", "~keyframe_step",
              "~color_same_proj", "~texture_compressed", "~enable_multi",
              "~map_size_xy", "~map_size_z", "~num_voxel_per_blk_axis"):
        assert k not in launch and k in params, k


def test_node_matches_the_textured_reference():
    """Bit for bit in the submaps (TSDF, weight, colour); the global map
    within 1e-6, the rounding of its sums taken in another order (K1's
    twin against the reference's index_add_)."""
    line, gaps = run_with_colors(Cell(CELL), 2147483659, 1.0,
                                 torch.device("cpu"), frames_override=TINY)
    assert line["failed"] < line["attempted"]
    assert line["correct"], line["checks"]
    for part in ("tsdf", "weight", "color"):
        assert gaps[f"submap_{part}_gap"] == 0.0, gaps
        assert gaps[f"global_{part}_gap"] <= 1e-6, gaps
    for name, c in line["checks"].items():
        assert c["value"] <= 1e-6, (name, c)


def test_colour_fault_fails_the_colour_check():
    """A colour altered in the collection shows in both colour gaps and
    in neither TSDF check."""
    def tint(node):
        m = node.mapping
        real = m.recast_depth_to_map_by_frame

        def recast(*a):
            real(*a)
            m.submap_collection.state.channels["color"].mul_(0.9)
        m.recast_depth_to_map_by_frame = recast
        return node
    line, gaps = run_with_colors(Cell(CELL), 2147483659, 1.0,
                                 torch.device("cpu"), frames_override=TINY,
                                 node_factory=tint)
    assert line["correct"], line["checks"]
    assert gaps["submap_color_gap"] > 1e-3
    assert gaps["global_color_gap"] > 1e-3


# -- spans and counters of the refuse ------------------------------------------

# the same cases on the CUDA card (the card's K1 at the fusion site):
# ``python3 -m pytest tests/test_torch_l515_submap.py -m card --noconftest``
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.card)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: K1 runs there only")
    return name


@pytest.fixture
def prof():
    was = profiling._enabled
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(was)
    profiling.reset()


def _frame(f):
    ident = SimpleNamespace(position=SimpleNamespace(x=0.0, y=0.0, z=0.0),
                            orientation=SimpleNamespace(x=0.0, y=0.0,
                                                        z=0.0, w=1.0))
    th = 0.05 * f
    pose = SimpleNamespace(
        position=SimpleNamespace(x=0.1 * f, y=0.0, z=0.0),
        orientation=SimpleNamespace(x=0.0, y=0.0, z=float(np.sin(th / 2)),
                                    w=float(np.cos(th / 2))))
    return SimpleNamespace(frame_id=f, is_keyframe=True,
                           odom=SimpleNamespace(
                               pose=SimpleNamespace(pose=pose)),
                           extrinsics=[ident])


def _images(h=48, w=64):
    rng = np.random.default_rng(3)
    depth = rng.integers(800, 2500, size=(h, w)).astype(np.uint16)
    rgb = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    return (SimpleNamespace(width=w, height=h, data=depth.tobytes()),
            SimpleNamespace(width=w, height=h, data=rgb.tobytes()))


def _l515_node(sent, node_cls=TaichiSLAMNodeCore, device="cpu"):
    params = dict(json.loads((ROOT / "benchmark" / "configs" /
                              "l515_submap_textured.json").read_text())
                  ["params"])
    params.update({"~keyframe_step": 2, "~map_size_xy": 20,
                   "~map_size_z": 5, "Kdepth/cx": 32.0, "Kdepth/cy": 24.0,
                   "Kcolor/cx": 32.0, "Kcolor/cy": 24.0})
    from taichislam_tpu_torch.utils.comm import LoopbackTransport, SLAMComm
    comm = SLAMComm(0, transport=LoopbackTransport(LoopbackTransport.Hub()))
    core = node_cls(get_param=lambda n, d=None: params.get(n, d),
                    device=device, comm=comm)
    real = core.mapping.map_send_handle

    def send(buf):
        sent.append(len(buf))
        real(buf)
    core.mapping.map_send_handle = send
    return core


def _drive(core, frames):
    depth, rgb = _images()
    for f in range(frames):
        core.stage_depth(_frame(f), depth, core.decode_image(rgb, False))
        core.process_taichi()
        core.handle_comm()


def _nested(spans, child, parent):
    by = [i for i, s in enumerate(spans) if s["name"] == parent]
    return [s for s in spans if s["name"] == child and s["parent"] in by]


def _k1_counts(c, device):
    """The fusion site's K1 counters of a record: K1's wrapper counts them
    on the card only, where a kernel runs."""
    k1 = {k: v for k, v in c.items() if k.startswith("fusion/k1/")}
    if device == "cpu":
        assert k1 == {}
    return k1


@pytest.mark.parametrize("device", DEVICES)
def test_refuse_spans_and_counters(prof, device):
    device = _device(device)
    sent = []
    core = _l515_node(sent, device=device)
    prof.enable(True)
    _drive(core, 5)
    recs = prof.frames()
    gm = core.mapping.global_map
    boundaries = 0
    for k, r in enumerate(recs):
        spans, c = r["spans"], r["counts"]
        names = [s["name"] for s in spans]
        if not (k > 0 and k % 2 == 0):
            assert not any(n.startswith("fusion.") for n in names), names
            assert "submap/wire_bytes" not in c
            continue
        boundaries += 1
        [red] = _nested(spans, "fusion.reduce", "submap.refuse")
        assert len(_nested(spans, "fusion.k1", "fusion.reduce")) == 1
        assert len(_nested(spans, "fusion.apply", "submap.refuse")) == 1
        assert names.count("fusion.k1") == names.count("fusion.reduce") == 1
        k1 = _k1_counts(c, device)
        if device == "cuda":
            lanes = gm.last_fuse["lanes"]
            cap = gm.last_fuse["touched_cap"]
            assert k1["fusion/k1/lanes"] == lanes == c["k1/lanes"] - \
                c.get("bins/k1/lanes", 0) - c.get("march/k1/lanes", 0)
            assert k1["fusion/k1/launches"] == 1
            assert k1["fusion/k1/lane_vals"] == 6 * lanes      # textured
            assert k1["fusion/k1/max_touched"] == cap
            assert k1["fusion/k1/tile_vals"] == cap * 6 * 16 ** 3
        assert c.get("fusion/retries", 0) == 0
        assert c["submap/wire_bytes"] == sent[boundaries - 1]
    assert boundaries == 2 and len(sent) == 2
    assert prof.counts()["submap/wire_bytes"] == sum(sent)


@pytest.mark.parametrize("device", DEVICES)
def test_refuse_retry_counts_each_attempt(prof, device):
    device = _device(device)
    sent = []
    core = _l515_node(sent, device=device)
    _drive(core, 2)
    gm = core.mapping.global_map
    gm._fuse_touched_bucket = 1           # too small: the reduce is redone
    prof.enable(True)
    _drive(core, 1)
    [r] = [r for r in prof.frames() if r["frame"] == 2]
    attempts = gm.last_fuse["attempts"]
    assert attempts > 1
    c = r["counts"]
    assert c["fusion/retries"] == attempts - 1
    k1 = _k1_counts(c, device)
    if device == "cuda":
        assert k1["fusion/k1/launches"] == attempts
    names = [s["name"] for s in r["spans"]]
    assert names.count("fusion.reduce") == names.count("fusion.k1") == \
        attempts
    assert names.count("fusion.apply") == 1


@pytest.mark.parametrize("device", DEVICES)
def test_boundary_wire_overlaps_the_refuse(prof, device):
    """Each boundary queues its textured submap's gather and host copy
    ahead of the refuse and waits for the publish after it: in the
    boundary's record ``submap.finalize`` holds ``submap.export``, the
    hand-off ``submap.send``, ``submap.refuse`` and the waiting
    ``submap.send``, in that order; one ``submap/wire_overlapped``; the
    export's read counted once, its wait on the pool's thread recording no
    span; the payloads, colour included, those of an inline export."""
    device = _device(device)
    sent, bufs = [], []
    core = _l515_node(sent, device=device)
    m = core.mapping
    counted = m.map_send_handle
    m.map_send_handle = lambda buf: (bufs.append(buf), counted(buf))
    want = record_inline_payloads(m)
    prof.enable(True)
    _drive(core, 5)
    boundaries = [r for r in prof.frames()
                  if any(s["name"] == "submap.finalize" for s in r["spans"])]
    assert len(boundaries) == len(sent) == 2
    for r in boundaries:
        spans, c = r["spans"], r["counts"]
        [fin] = [i for i, s in enumerate(spans)
                 if s["name"] == "submap.finalize"]
        kids = [s["name"] for s in spans if s["parent"] == fin and
                s["name"].startswith("submap.")]
        # the inline reference's own export comes first
        assert kids == ["submap.export", "submap.export", "submap.send",
                        "submap.refuse", "submap.send"], kids
        assert c["submap/wire_overlapped"] == 1
        assert c["host_read/exports.sparse_buffer"] == 2    # with the inline
        # the inline read's span; the boundary's own is the node's on the
        # CPU (read at once), the pool's on the card (waited there)
        names = [s["name"] for s in spans]
        assert names.count("sync/exports.sparse_buffer") == (
            2 if device == "cpu" else 1)
    assert_same_payloads(m, bufs, want)
    assert [len(b) for b in bufs] == sent


# -- the collection's capacity and the refuse in passes ------------------------

def _voxels(state):
    """The observed voxels of a state of ``_l515_node``'s maps, keyed by
    (submap, i, j, k)."""
    from benchmark import check
    from benchmark.reference.tsdf import Spec
    return check.program_voxels(state, Spec(0.05, 16, 20, 5),
                                ("TSDF", "W_TSDF", "color", "occupy"))


def _run_small(device, frames=9, node_cls=TaichiSLAMNodeCore):
    sent = []
    core = _l515_node(sent, node_cls, device)
    _drive(core, frames)
    return core.mapping


@pytest.mark.parametrize("device", DEVICES)
def test_collection_grows_instead_of_dropping_blocks(capsys, device):
    """A collection of 8 block slots (4 blocks a submap here) doubles
    whenever more than three quarters are taken at a submap switch; its
    blocks, values and refuse are those of a collection that never had to
    grow, bit for bit, and nothing is dropped."""
    class Small(TaichiSLAMNodeCore):
        def get_submap_opts(self):
            return dict(super().get_submap_opts(), max_blocks=8)
    device = _device(device)
    small, big = _run_small(device, node_cls=Small), _run_small(device)
    col = small.submap_collection
    assert "block capacity 8 -> 16" in capsys.readouterr().out
    assert col.cfg.max_blocks == 32
    assert int(col.state.alloc_overflow) == 0
    assert int(col.state.num_blocks) == int(
        big.submap_collection.state.num_blocks) == 20
    for a, b in ((col.state, big.submap_collection.state),
                 (small.global_map.state, big.global_map.state)):
        va, vb = _voxels(a), _voxels(b)
        assert torch.equal(va.keys, vb.keys)
        for k in va.vals:
            assert torch.equal(va.vals[k], vb.vals[k]), k


@pytest.mark.parametrize("device", DEVICES)
def test_refuse_in_passes_equals_one_pass(monkeypatch, device):
    """The last refuse's 16 blocks in passes of 6 block slots (6, 6 and 4)
    against one pass: the same voxels, TSDF and colour within 1e-6 and weight within
    1e-6 relative (the sums rounded in another order), observed flags and
    occupancy equal."""
    device = _device(device)
    one = _run_small(device)
    assert one.global_map.last_fuse["passes"] == 1
    from taichislam_tpu_torch.models import dense_tsdf
    monkeypatch.setattr(dense_tsdf, "_FUSE_GROUP_BLOCKS", 6)
    split = _run_small(device)
    fz = split.global_map.last_fuse
    # each pass's cap: its slots by ``_block_cap`` (at least 64), at most
    # the group: 6 slots a pass
    assert fz["passes"] == 3 and fz["lanes"] == 7 * (6 + 6 + 6) * 16 ** 3
    a = _voxels(split.global_map.state)
    b = _voxels(one.global_map.state)
    assert torch.equal(a.keys, b.keys) and a.keys.numel() > 1000
    assert torch.equal(a.vals["occupy"], b.vals["occupy"])
    for k in ("TSDF", "color"):
        assert torch.allclose(a.vals[k], b.vals[k], rtol=0, atol=1e-6), k
    assert torch.allclose(a.vals["W_TSDF"], b.vals["W_TSDF"], rtol=1e-6,
                          atol=0)


# -- the benchmark's readers on a hand-made traced run -------------------------

def _span(name, parent, e0, e1):
    return {"name": name, "parent": parent, "t0": 1, "t1": 2, "e0": e0,
            "e1": e1}


FUSION = {"fusion/k1/launches": 2, "fusion/k1/lanes": 7000,
          "fusion/k1/lane_vals": 42000, "fusion/k1/max_touched": 64,
          "fusion/k1/tile_vals": 64 * 6 * 4096}


def _records():
    boundary = {"frame": 0, "profiled": True, "t0": 0, "t1": 9, "spans": [
        _span("node.recast", None, 0.0, 20.0),
        _span("submap.finalize", 0, 2.0, 19.0),
        _span("submap.send", 1, 2.0, 3.0),
        _span("submap.refuse", 1, 3.0, 18.0),
        _span("fusion.reduce", 3, 3.0, 8.0),
        _span("fusion.k1", 4, 5.0, 6.0),
        _span("fusion.reduce", 3, 8.0, 14.0),
        _span("fusion.k1", 6, 10.0, 12.0),
        _span("fusion.apply", 3, 14.0, 17.5)],
        "counts": dict(FUSION, **{"fusion/retries": 1,
                                  "submap/wire_bytes": 3 * 2 ** 20}),
        "scalars": {}}
    plain = {"frame": 1, "profiled": True, "t0": 10, "t1": 19, "spans": [
        _span("node.recast", None, 0.0, 4.0)], "counts": {}, "scalars": {}}
    return [boundary, plain]


def _run():
    """The trace of ``_records``' frames (us): the refuse's two reduces
    with their K1 calls, and K1 kernels of the integrate outside them."""
    host = [("tsl/fusion.reduce", 100.0, 200.0), ("tsl/fusion.k1", 120.0, 130.0),
            ("tsl/fusion.reduce", 300.0, 400.0), ("tsl/fusion.k1", 310.0, 320.0)]
    device = [("kernel", "k1_reduce<unsigned int>", 50.0, 60.0),
              ("kernel", "k1_prepare<unsigned int>", 125.0, 140.0),
              ("kernel", "k1_reduce<unsigned int>", 140.0, 150.0),
              ("kernel", "splat", 150.0, 160.0),
              ("kernel", "k1_reduce<unsigned int>", 330.0, 345.0),
              ("kernel", "k1_prepare<unsigned int>", 500.0, 520.0)]
    return {"trace": {"span": (0.0, 1000.0), "frames": 2, "calls": [],
                      "device": device, "host": host}, "frames": []}


def _read(name, run):
    return Cell(CELL).reader(name)(run)


def test_fusion_metrics_on_a_hand_made_run(prof, monkeypatch):
    from benchmark import spans as bspans
    monkeypatch.setattr(profiling, "frames", _records)
    k1 = {k[len("fusion/"):]: v for k, v in FUSION.items()}
    want = {"fusion_reduce_ms": 11.0, "fusion_apply_ms": 3.5,
            "fusion_k1_roofline": 100 * bspans.k1_bytes(k1) / 3.35e12 /
            40e-6,
            "submap_wire_mib": 3.0}
    for name, v in want.items():
        assert _read(name, _run()) == pytest.approx(v), name
    assert _read("fusion_k1_roofline", _run()) < 100


@pytest.mark.parametrize("name", ["fusion_reduce_ms", "fusion_apply_ms",
                                  "fusion_k1_roofline", "submap_wire_mib"])
def test_fusion_metrics_read_nothing_without_them(prof, monkeypatch, name):
    def parent_like():
        # a program without the refuse's spans and counters
        recs = _records()
        recs[0]["spans"] = recs[0]["spans"][:4]
        recs[0]["counts"] = {}
        return recs
    monkeypatch.setattr(profiling, "frames", parent_like)
    assert _read(name, _run()) is None
    monkeypatch.setattr(profiling, "frames", lambda: _records()[:1])
    assert _read(name, _run()) is None          # 1 record, 2 frames
    monkeypatch.delattr(profiling, "frames")
    assert _read(name, _run()) is None
    assert _read(name, {"trace": None, "frames": []}) is None
