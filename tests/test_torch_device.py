"""The port runs on the CUDA card unless the caller asks for the CPU.

Built with no device, DenseTSDF, DenseESDF, Octomap, SubmapMapping,
DenseTSDF.loadMap, the state constructors (make_grid_state, make_tsdf_state,
make_octomap_state), the bridge's *_from_numpy functions and the parallel
entry points (make_mesh, spawn_mesh, ShardedDenseTSDF) target ``cuda``;
with no card they raise, naming the ``device="cpu"`` way out, and never fall
back. Whether a card is present is decided inside each test
(monkeypatched), never at import.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core import grid  # noqa: E402
from taichislam_tpu_torch.core.config import OctomapConfig, TSDFConfig  # noqa: E402,E501
from taichislam_tpu_torch.models import base_map  # noqa: E402
from taichislam_tpu_torch.models import dense_tsdf  # noqa: E402
from taichislam_tpu_torch.models.dense_esdf import DenseESDF  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF  # noqa: E402
from taichislam_tpu_torch.models.octomap import Octomap  # noqa: E402
from taichislam_tpu_torch.models.submap_mapping import SubmapMapping  # noqa: E402,E501
from taichislam_tpu_torch.ops import occupancy, tsdf  # noqa: E402

SMALL = dict(map_scale=[3.2, 3.2], voxel_scale=0.1, num_voxel_per_blk_axis=8,
             max_blocks=64, max_submap_num=4)
CFG = TSDFConfig(**SMALL)
OCFG = OctomapConfig(map_scale=(3.2, 3.2), voxel_scale=0.1, max_blocks=64,
                     max_submap_num=4)


def _source(kind):
    """The numpy input of a bridge function (None for the others)."""
    if kind == "grid_state_from_numpy":
        return bridge.grid_state_to_numpy(tsdf.make_tsdf_state(CFG,
                                                               device="cpu"))
    if kind == "octomap_state_from_numpy":
        return bridge.grid_state_to_numpy(
            occupancy.make_octomap_state(OCFG, device="cpu"))
    if kind == "esdf_state_from_numpy":
        return {"esdf": np.zeros((4, 8), np.float32)}
    return None


def _build(kind, tmp_path, src=None, **kw):
    src = _source(kind) if src is None else src
    if kind == "make_grid_state":
        return grid.make_grid_state(CFG.grid, {"TSDF": (torch.float32, ())},
                                    **kw)
    if kind == "make_tsdf_state":
        return tsdf.make_tsdf_state(CFG, **kw)
    if kind == "make_octomap_state":
        return occupancy.make_octomap_state(OCFG, **kw)
    if kind.endswith("_from_numpy"):
        return getattr(bridge, kind)(src, **kw)
    if kind == "DenseTSDF":
        return DenseTSDF(**SMALL, **kw)
    if kind == "DenseESDF":
        return DenseESDF(**SMALL, **kw)
    if kind == "Octomap":
        return Octomap(map_scale=[3.2, 3.2], voxel_scale=0.1, max_blocks=64,
                       max_submap_num=4, **kw)
    if kind == "SubmapMapping":
        return SubmapMapping(DenseTSDF, sub_opts=SMALL,
                             global_opts=dict(SMALL, is_global_map=True),
                             **kw)
    path = tmp_path / "map.npy"
    DenseTSDF(**SMALL, device="cpu").saveMap(str(path))
    return DenseTSDF.loadMap(str(path), **kw)


def _device(obj):
    """The device an object built by _build keeps its state on."""
    if isinstance(obj, grid.GridState):
        return obj.table.device
    if isinstance(obj, dict):
        return next(iter(obj.values())).device
    return obj.device


MODELS = ["DenseTSDF", "DenseESDF", "Octomap", "SubmapMapping", "loadMap"]
STATE = ["make_grid_state", "make_tsdf_state", "make_octomap_state",
         "grid_state_from_numpy", "octomap_state_from_numpy",
         "esdf_state_from_numpy"]
KINDS = MODELS + STATE


@pytest.mark.parametrize("kind", KINDS)
def test_no_card_and_no_device_raises(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build(kind, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_on_request(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _build(kind, tmp_path, device="cpu")
    assert _device(m) == torch.device("cpu")


class _Asked(Exception):
    pass


@pytest.mark.parametrize("kind", ["models"] + STATE)
def test_default_asks_for_the_card(kind, tmp_path, monkeypatch):
    """With a card present and no device given, a model or a state
    constructor puts its state on ``cuda``: the first allocation is asked
    for that device."""
    if kind != "models":
        src = _source(kind)
        asked = []

        def to_tensor(a, device):
            asked.append(torch.device(device))
            raise _Asked

        def zeros(*a, device=None, **kw):
            to_tensor(None, device)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch, "zeros", zeros)
        monkeypatch.setattr(bridge, "_to_tensor", to_tensor)
        with pytest.raises(_Asked):
            _build(kind, tmp_path, src)
        assert asked == [torch.device("cuda")]
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert base_map.resolve_device(None) == torch.device("cuda")
    assert base_map.resolve_device("cpu") == torch.device("cpu")
    asked = []

    def make_state(cfg, device=None):
        asked.append(torch.device(device))
        raise _Asked

    monkeypatch.setattr(dense_tsdf.tsdf_ops, "make_tsdf_state", make_state)
    for build in (lambda: DenseTSDF(**SMALL), lambda: DenseESDF(**SMALL),
                  lambda: SubmapMapping(DenseTSDF, sub_opts=SMALL)):
        with pytest.raises(_Asked):
            build()
    assert len(asked) == 3 and all(d.type == "cuda" for d in asked)


# the entry points of the topo graph and the optimizer ------------------------

def _build_entry(kind, **kw):
    from taichislam_tpu_torch.core.colormap import jet_lut
    from taichislam_tpu_torch.node.topo_worker import TopoGen
    from taichislam_tpu_torch.opti import ba_demo
    from taichislam_tpu_torch.opti.nnls import NNLS
    if kind == "TopoGen":
        return TopoGen(SMALL, dict(coll_det_num=16), {}, **kw).mapping
    if kind == "NNLS":
        return NNLS(**kw)
    if kind == "jet_lut":
        return jet_lut(**kw)
    return ba_demo.make_scene(n_cams=2, n_pts=5, **kw)[3]


ENTRIES = ["TopoGen", "NNLS", "jet_lut", "make_scene"]


@pytest.mark.parametrize("kind", ENTRIES)
def test_entry_points_need_the_card_or_the_cpu(kind, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build_entry(kind)
    assert _build_entry(kind, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kind", ENTRIES)
def test_entry_points_default_to_the_card(kind, monkeypatch):
    """With a card present and no device given, each entry point resolves
    ``cuda`` (and a TopoGen's map asks for its state there)."""
    from taichislam_tpu_torch.core import colormap
    from taichislam_tpu_torch.opti import ba_demo, nnls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []

    def spy(device=None):
        asked.append(base_map.resolve_device(device))
        raise _Asked

    def make_state(cfg, device=None):
        asked.append(torch.device(device))
        raise _Asked
    for mod in (colormap, ba_demo, nnls):
        monkeypatch.setattr(mod, "resolve_device", spy)
    monkeypatch.setattr(dense_tsdf.tsdf_ops, "make_tsdf_state", make_state)
    with pytest.raises(_Asked):
        _build_entry(kind)
    assert [d.type for d in asked] == ["cuda"]


def test_topo_graph_follows_its_map():
    """TopoGraphGen runs its map calls on the map's device."""
    from taichislam_tpu_torch.models.topo_graph import TopoGraphGen
    m = DenseTSDF(**SMALL, device="cpu")
    topo = TopoGraphGen(m, coll_det_num=16)
    assert topo.device == m.device == torch.device("cpu")
    assert topo._dev(np.zeros(3)).device == m.device
    assert not topo.detect_collisions(np.zeros(3))   # unobserved: all black,
    assert topo.black_num == 16 and topo.host_syncs == 1   # at length 0


# the node and the user-facing entry points -----------------------------------

NODE_PARAMS = {"~enable_multi": False, "~enable_mesher": False,
               "~texture_enabled": False, "~map_size_xy": 3.2,
               "~map_size_z": 3.2, "~voxel_scale": 0.1,
               "~num_voxel_per_blk_axis": 8}
NODE_ENTRIES = ["TaichiSLAMNodeCore", "TaichiSLAMNode", "demo",
                "demo_synthetic", "gen_topo_graph"]


def _run_node_entry(kind, monkeypatch, cpu=False):
    """Build the node or run a CLI as a user would; ``cpu`` asks for the
    CPU (``device="cpu"``, or the CLIs' ``--cpu``). Returns the map the
    node built, or None for a CLI."""
    if kind == "TaichiSLAMNodeCore":
        from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore
        return TaichiSLAMNodeCore(
            get_param=lambda n, d=None: NODE_PARAMS.get(n, d),
            **({"device": "cpu"} if cpu else {})).mapping
    if kind == "TaichiSLAMNode":
        from tests.test_torch_ros_shell import SHELL, _import_shell
        import sys
        params = dict(NODE_PARAMS, **{"~enable_rendering": False})
        module, _ = _import_shell(monkeypatch, params, [], lambda t: None)
        try:
            return module.TaichiSLAMNode(
                **({"device": "cpu"} if cpu else {})).mapping
        finally:
            sys.modules.pop(SHELL, None)
    flag = ["--cpu"] if cpu else []
    if kind == "demo":
        from taichislam_tpu_torch import demo
        demo.main(["-m", "tsdf", "--map-size", "3.2", "3.2", "--voxel-size",
                   "0.1", "--blk", "8"] + flag)
    elif kind == "demo_synthetic":
        from taichislam_tpu_torch.examples import demo_synthetic
        demo_synthetic.main(["--frames", "1"] + flag)
    else:
        from taichislam_tpu_torch.examples import gen_topo_graph
        gen_topo_graph.main(["--benchmark", "--run_num", "1"] + flag)
    return None


@pytest.mark.parametrize("kind", NODE_ENTRIES)
def test_node_entry_points_raise_without_a_card(kind, monkeypatch,
                                                tmp_path):
    """Without a card, the node and the CLIs without --cpu raise, naming
    the way out; they never fall back to the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run_node_entry(kind, monkeypatch)
    if kind.startswith("TaichiSLAM"):
        m = _run_node_entry(kind, monkeypatch, cpu=True)
        assert m.device == torch.device("cpu")


@pytest.mark.parametrize("kind", NODE_ENTRIES)
def test_node_entry_points_default_to_the_card(kind, monkeypatch, tmp_path):
    """With a card present and no device asked for, the node and the CLIs
    put their first map on ``cuda``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []

    def make_state(cfg, device=None):
        asked.append(torch.device(device))
        raise _Asked
    monkeypatch.setattr(dense_tsdf.tsdf_ops, "make_tsdf_state", make_state)
    with pytest.raises(_Asked):
        _run_node_entry(kind, monkeypatch)
    assert [d.type for d in asked] == ["cuda"]


# the parallel entry points ---------------------------------------------------

PARALLEL = ["make_mesh", "spawn_mesh", "ShardedDenseTSDF"]


def _build_parallel(kind, tmp_path, **kw):
    """The device the entry point's mesh (or model) runs on."""
    from taichislam_tpu_torch.models.sharded_dense_tsdf import \
        ShardedDenseTSDF
    from taichislam_tpu_torch.parallel import mesh
    import torch_parallel_workers as workers
    if kind == "make_mesh":
        return mesh.make_mesh(1, "block", **kw).device
    if kind == "spawn_mesh":
        return torch.device(mesh.spawn_mesh(workers.mesh_device, 1,
                                            store_dir=tmp_path, **kw)[0])
    return ShardedDenseTSDF(map_scale=[3.2, 3.2], voxel_scale=0.1,
                            max_blocks=15, max_submap_num=4, **kw).device


@pytest.mark.parametrize("kind", PARALLEL)
def test_parallel_entry_points_need_the_card_or_the_cpu(kind, monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build_parallel(kind, tmp_path)
    assert _build_parallel(kind, tmp_path, device="cpu") == \
        torch.device("cpu")


@pytest.mark.parametrize("kind", PARALLEL)
def test_parallel_entry_points_default_to_the_card(kind, monkeypatch,
                                                   tmp_path):
    """With a card present and no device given, the mesh, the spawned ranks
    and the sharded model resolve ``cuda`` (and the NCCL backend) before
    anything else."""
    from taichislam_tpu_torch.models import sharded_dense_tsdf
    from taichislam_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []

    def spy(device=None):
        asked.append(base_map.resolve_device(device))
        raise _Asked
    for mod in (mesh, sharded_dense_tsdf):
        monkeypatch.setattr(mod, "resolve_device", spy)
    with pytest.raises(_Asked):
        _build_parallel(kind, tmp_path)
    assert [d.type for d in asked] == ["cuda"]
    assert mesh.default_backend(asked[0]) == "nccl"
