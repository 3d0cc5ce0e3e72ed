"""The port's node core (node/core.py) against the JAX package's, driven
WITHOUT ROS by the duck-typed fake messages of tests/test_node_core.py.

Each test feeds the same fake messages to a JAX core and to a port core on
the CPU and compares what they publish and render: point counts and xyz
exact, colors within 4e-3, ESDF values within 1e-5. The JAX models take
their Pallas paths in interpret mode (K1's accumulation order). The loopback
exchange between two port cores, the topology worker factory and the
default ``spawn`` worker are the port's own.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.node.core import TaichiSLAMNodeCore as JCore  # noqa: E402
from taichislam_tpu.utils.visualization import \
    TaichiSLAMRender as JRender  # noqa: E402
from taichislam_tpu_torch.models.dense_esdf import DenseESDF  # noqa: E402
from taichislam_tpu_torch.models.octomap import Octomap  # noqa: E402
from taichislam_tpu_torch.node import core as tcore  # noqa: E402
from taichislam_tpu_torch.node.core import TaichiSLAMNodeCore as TCore  # noqa: E402,E501
from taichislam_tpu_torch.utils.comm import LoopbackTransport, SLAMComm  # noqa: E402,E501
from taichislam_tpu_torch.utils.visualization import \
    TaichiSLAMRender as TRender  # noqa: E402


def fake_pose(x=0.0, y=0.0, z=0.0, qw=1.0):
    return SimpleNamespace(
        position=SimpleNamespace(x=x, y=y, z=z),
        orientation=SimpleNamespace(x=0.0, y=0.0, z=0.0, w=qw))


def fake_frame(frame_id=0, is_keyframe=True, x=0.0):
    return SimpleNamespace(
        frame_id=frame_id, is_keyframe=is_keyframe,
        odom=SimpleNamespace(pose=SimpleNamespace(pose=fake_pose(x=x))),
        extrinsics=[fake_pose()])


def fake_depth_msg(h=24, w=32, value=1000):
    data = np.full((h, w), value, np.uint16)
    return SimpleNamespace(width=w, height=h, data=data.tobytes())


BASE_PARAMS = {
    "~enable_multi": False,
    "~enable_mesher": False,
    "~texture_enabled": False,
    "~mapping_type": "tsdf",
    "~map_size_xy": 6.4,
    "~map_size_z": 6.4,
    "~voxel_scale": 0.1,
    "~num_voxel_per_blk_axis": 8,
    "~max_ray_length": 1.5,
    "~output_map": True,
    "~disp/max_disp_particles": 65536,
}
SUBMAP = {"~enable_submap": True, "~submap_max_disp_particles": 65536}
# a 32x24 camera with a wide field of view
SMALL_K = {"Kdepth/fx": 20.0, "Kdepth/cx": 16.0, "Kdepth/fy": 20.0,
           "Kdepth/cy": 12.0}


def _getter(extra):
    params = dict(BASE_PARAMS)
    params.update(extra or {})
    return lambda name, default=None: params.get(name, default)


def _pallas(m):
    m.cfg = dataclasses.replace(m.cfg, pallas_accum="on", pallas_esdf="on",
                                esdf_loop_kernel="off")


def make_pair(extra=None, render=False, **kw):
    """A JAX core and a port core (on the CPU) with the same parameters,
    each publishing into its own list."""
    pubs = ([], [])
    cores = []
    for i, (cls, rcls) in enumerate(((JCore, JRender), (TCore, TRender))):
        pub = pubs[i]
        kwargs = dict(kw, get_param=_getter(extra),
                      publish_pointcloud=lambda xyz, col, tex, pub=pub:
                      pub.append((np.array(xyz), np.array(col), tex)),
                      render=rcls(160, 120) if render else None)
        if cls is TCore:
            kwargs["device"] = "cpu"
        core = cls(**kwargs)
        if cls is JCore:
            m = core.mapping
            for sub in ((m.submap_collection, m.global_map)
                        if hasattr(m, "global_map") else (m,)):
                _pallas(sub)
        cores.append(core)
    return cores, pubs


def assert_same_published(jp, tp):
    assert len(jp) == len(tp) > 0
    for (jx, jc, jt), (tx, tc, tt) in zip(jp, tp):
        assert jt == tt
        assert jx.shape == tx.shape and len(tx) > 0
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_allclose(jc, tc, atol=4e-3)


def test_param_plumbing_matches_jax():
    """The option builders of both cores give the same dicts for the node
    defaults and for the launch file's parameters; the port's core builds
    its maps on the device it is given."""
    launch = {"~enable_submap": True, "~mapping_type": "tsdf",
              "~texture_enabled": False, "~max_ray_length": 3.1,
              "~voxel_scale": 0.1, "~color_same_proj": True,
              "Kdepth/fx": 384.0, "Kdepth/cy": 240.0}
    for params in ({}, launch, {"~mapping_type": "esdf",
                                "~esdf/max_sweeps": 32}):
        get = (lambda p: lambda name, default=None: p.get(name, default))(
            params)
        j, t = object.__new__(JCore), object.__new__(TCore)
        for c in (j, t):
            c.get_param = get
            c.init_params()
        for name in ("get_general_mapping_opts", "get_octo_opts",
                     "get_sdf_opts", "get_esdf_opts", "get_submap_opts"):
            assert getattr(j, name)() == getattr(t, name)(), name
        np.testing.assert_array_equal(j.Kdep, t.Kdep)
        np.testing.assert_array_equal(j.Kcolor, t.Kcolor)
        assert j.skeleton_graph_gen_opts == t.skeleton_graph_gen_opts
        assert (j.keyframe_step, j.drone_id, j.mapping_type) == \
            (t.keyframe_step, t.drone_id, t.mapping_type)
    core = TCore(get_param=_getter(None), device="cpu")
    assert core.mapping_type == "tsdf"
    assert core.mapping.voxel_scale == pytest.approx(0.1)
    assert core.mapping.map_size_xy == pytest.approx(6.4)
    assert core.mapping.device == torch.device("cpu")
    assert core.comm is None  # ~enable_multi False
    core2 = TCore(get_param=_getter({"~mapping_type": "octo", "K": 2}),
                  device="cpu")
    assert isinstance(core2.mapping, Octomap)


def test_stage_and_process_depth_frame():
    """Latest-wins staging + recast + output publish, with fake messages:
    the port publishes the JAX core's surface cloud."""
    (jc, tc), (jp, tp) = make_pair(
        extra=dict(SUBMAP, **{"~keyframe_step": 2}))
    for core in (jc, tc):
        # two staged frames: only the LATEST is consumed
        core.stage_depth(fake_frame(0), fake_depth_msg(value=800))
        core.stage_depth(fake_frame(0), fake_depth_msg(value=1000))
        assert core.updated
        core.process_taichi()
        assert core.count == 1 and not core.updated
        core.process_taichi()   # no new frame -> no-op
        assert core.count == 1
    assert tc.mapping.submap_collection.count_active() == \
        jc.mapping.submap_collection.count_active() > 0
    assert_same_published(jp, tp)
    assert len(tp) == 1 and tp[0][2] is False
    # surface sits near the 1.0 m wall
    assert 0.7 < np.median(tp[0][0][:, 2]) < 1.3


def test_rendering_stages_particles():
    (jc, tc), _ = make_pair(extra=dict(SUBMAP, **{"~keyframe_step": 1}),
                            render=True)
    for core in (jc, tc):
        core.stage_depth(fake_frame(0), fake_depth_msg())
        core.process_taichi()
        core.rendering()
        assert core.render.par is not None and len(core.render.par) > 0
        assert core.render.drone_poses  # set_drone_pose ran
    np.testing.assert_array_equal(jc.render.par, tc.render.par)
    np.testing.assert_allclose(jc.render.par_color, tc.render.par_color,
                               atol=4e-3)
    for a, b in zip(jc.render.drone_poses[0], tc.render.drone_poses[0]):
        np.testing.assert_array_equal(a, b)


def test_output_meshes_into_the_render():
    """With a render and ~enable_mesher, output() runs generate_mesh(1) and
    hands the mesh to the render: the same triangles as the JAX core's
    (vertices within the 1 mm quantum of the mesh delivery)."""
    (jc, tc), _ = make_pair(extra={"~enable_mesher": True, **SMALL_K},
                            render=True)
    for f in range(2):
        for core in (jc, tc):
            core.stage_depth(fake_frame(f, x=0.05 * f), fake_depth_msg())
            core.process_taichi()
    assert tc.mesher.num_facelets == jc.mesher.num_facelets > 0
    jv, tv = jc.render.mesh_vertices, tc.render.mesh_vertices
    assert jv.shape == tv.shape == (3 * tc.mesher.num_facelets, 3)
    np.testing.assert_allclose(jv, tv, atol=1e-3)


def test_rendering_slice_view():
    """enable_slice_z routes the TSDF export through the z-slice path:
    particles cluster at slice_z, the same in both packages."""
    (jc, tc), _ = make_pair(extra=dict(SUBMAP, **{"~keyframe_step": 1}),
                            render=True)
    for core in (jc, tc):
        core.stage_depth(fake_frame(0), fake_depth_msg())
        core.process_taichi()
        core.mapping.set_exporting_local()   # global map is empty
        core.render.enable_slice_z = True
        core.render.slice_z = 1.0
        core.rendering()
        assert core.render.par is not None and len(core.render.par) > 0
        assert np.all(np.abs(core.render.par[:, 2] - 1.0) < 0.1 + 1e-6)
    np.testing.assert_array_equal(jc.render.par, tc.render.par)
    np.testing.assert_allclose(jc.render.par_color, tc.render.par_color,
                               atol=4e-3)


@pytest.mark.parametrize("textured", [False, True],
                         ids=["plain", "textured"])
def test_esdf_mapping_type_end_to_end(textured):
    """mapping_type="esdf": frames recast, the incremental ESDF updates, and
    ~esdf/publish_slice_z publishes the slice cloud after the surface
    cloud; the port publishes the JAX core's clouds, and the render slice
    path exports the same distance-field particles. Textured, the node's
    default color reprojection (color_same_proj False) colors them."""
    (jc, tc), (jp, tp) = make_pair(
        extra={"~mapping_type": "esdf", "~enable_mesher": False,
               "~esdf/publish_slice_z": 1.0, "~texture_enabled": textured,
               **SMALL_K, "Kcolor/fx": 22.0, "Kcolor/cx": 15.5,
               "Kcolor/fy": 21.0, "Kcolor/cy": 12.5},
        render=True)
    assert isinstance(tc.mapping, DenseESDF)
    rng = np.random.default_rng(8)
    for f in range(2):
        tex = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        depth = fake_depth_msg(value=1000 - 40 * f)
        for core in (jc, tc):
            if textured:
                core.stage_depth(fake_frame(f, x=0.05 * f), depth, tex)
            else:
                core.stage_depth(fake_frame(f, x=0.05 * f), depth)
            core.process_taichi()
    assert tc.mapping.count_active() == jc.mapping.count_active() > 0
    assert len(tp) == 4          # surface cloud + slice cloud per frame
    assert_same_published(jp, tp)
    xyz, col, has_rgb = tp[-1]
    assert has_rgb is True and len(xyz) > 0
    assert np.all(np.abs(xyz[:, 2] - 1.0) < 0.6 + 1e-6)   # dz=0.5 band

    for core in (jc, tc):
        core.render.enable_slice_z = True
        core.render.slice_z = 1.0
        core.rendering()
    np.testing.assert_array_equal(jc.render.par, tc.render.par)
    n = tc.mapping.num_export_ESDF_particles
    assert n == jc.mapping.num_export_ESDF_particles > 0
    vals = tc.mapping.export_ESDF[:n]
    np.testing.assert_allclose(np.asarray(jc.mapping.export_ESDF)[:n], vals,
                               atol=1e-5)
    assert np.all(np.abs(vals) <= tc.mapping.max_ray_length)


def test_esdf_check_interval_takes_the_deferred_path():
    """~esdf/check_interval reaches DenseESDF: at 2, process_taichi runs
    the deferred per-frame path (the interval accumulators fill on odd
    frames and the verdict empties them) on both cores, and the published
    surface and slice clouds stay the JAX core's."""
    (jc, tc), (jp, tp) = make_pair(
        extra={"~mapping_type": "esdf", "~enable_mesher": False,
               "~esdf/publish_slice_z": 1.0, "~esdf/check_interval": 2,
               **SMALL_K})
    for core in (jc, tc):
        assert core.mapping.esdf_check_interval == 2
    for f in range(3):
        for core in (jc, tc):
            core.stage_depth(fake_frame(f, x=0.05 * f),
                             fake_depth_msg(value=1000 - 40 * f))
            core.process_taichi()
        assert (tc.mapping._frame_pack is None) == (f % 2 == 1)
        assert (jc.mapping._frame_pack is None) == (f % 2 == 1)
    assert tc.mapping._esdf_frame == jc.mapping._esdf_frame == 3
    assert len(tp) == 6
    assert_same_published(jp, tp)


def test_pcl_frame_matches_jax():
    """The point-cloud branch of recast (stage_pcl): a PointCloud2 wall
    decoded by each package's codec, integrated and published the same."""
    from taichislam_tpu_torch.utils.ros_pcl_transfer import _PF_DTYPES
    assert _PF_DTYPES[7] is np.float32
    zz, yy = np.meshgrid(np.linspace(-0.4, 0.4, 16),
                         np.linspace(-0.4, 0.4, 16))
    pts = np.stack([yy.ravel(), zz.ravel(),
                    np.full(yy.size, 1.0)], axis=1).astype(np.float32)
    fields = [SimpleNamespace(name=n, offset=4 * i, datatype=7, count=1)
              for i, n in enumerate("xyz")]
    cloud = SimpleNamespace(fields=fields, point_step=12, height=1,
                            width=len(pts), data=pts.tobytes())
    (jc, tc), (jp, tp) = make_pair(
        extra=dict(SUBMAP, **{"~keyframe_step": 2}))
    for core in (jc, tc):
        core.stage_pcl(fake_frame(0), cloud)
        assert core.updated_pcl
        core.process_taichi()
        assert core.count == 1
    assert tc.mapping.submap_collection.count_active() == \
        jc.mapping.submap_collection.count_active() > 0
    assert_same_published(jp, tp)


def test_traj_callback_applies_pgo_poses():
    (jc, tc), _ = make_pair(extra=dict(SUBMAP, **{"~drone_id": 1,
                                                  "~keyframe_step": 1}))
    for core in (jc, tc):
        core.stage_depth(fake_frame(0), fake_depth_msg())
        core.process_taichi()
        traj = SimpleNamespace(drone_id=1, frame_ids=[0],
                               poses=[fake_pose(x=0.5)])
        core.traj_callback(traj)
        assert 0 in core.mapping.pgo_poses
        np.testing.assert_allclose(core.mapping.pgo_poses[0][1],
                                   [0.5, 0.0, 0.0])
        # wrong drone id is ignored
        traj2 = SimpleNamespace(drone_id=9, frame_ids=[0],
                                poses=[fake_pose(x=9.0)])
        core.traj_callback(traj2)
        np.testing.assert_allclose(core.mapping.pgo_poses[0][1],
                                   [0.5, 0.0, 0.0])
    for a, b in zip(jc.mapping.pgo_poses[0], tc.mapping.pgo_poses[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_two_cores_exchange_submaps_over_loopback():
    """Node-level multi-drone path: core A's submaps reach core B through
    the port's SLAMComm on the loopback transport."""
    hub = LoopbackTransport.Hub()
    comm_a = SLAMComm(0, transport=LoopbackTransport(hub))
    comm_b = SLAMComm(1, transport=LoopbackTransport(hub))
    extra = dict(SUBMAP, **{"~enable_multi": True, "~keyframe_step": 1})
    core_a = TCore(get_param=_getter(extra), comm=comm_a, device="cpu")
    core_b = TCore(get_param=_getter(extra), comm=comm_b, device="cpu")
    for f in range(3):
        core_a.stage_depth(fake_frame(f, x=0.05 * f), fake_depth_msg())
        core_a.process_taichi()
    core_b.handle_comm()
    assert core_b.mapping.submap_collection.remote_submap_num == 2
    assert core_b.mapping.global_map.count_active() > 0
    assert core_a.mapping.submap_collection.remote_submap_num == 0


class _FakeProcess:
    def __init__(self, target=None, args=()):
        self.target, self.args = target, args
        self.started = self.terminated = self.joined = False

    def start(self):
        self.started = True

    def terminate(self):
        self.terminated = True

    def join(self):
        self.joined = True


def test_topo_process_factory():
    """A topo_process_factory gets the worker's parameters (the device
    included); every refuse hands the exported global map to the shared
    dict and the worker's edge lines to the render."""
    seen = {}

    def factory(params):
        seen["params"] = params
        return _FakeProcess(), {"exit": False, "update": False,
                                "topo_graph_viz": {"lines": np.ones((4, 3))}}
    extra = dict(SUBMAP, **{"~keyframe_step": 1,
                            "~enable_skeleton_graph_gen": True})
    core = TCore(get_param=_getter(extra), topo_process_factory=factory,
                 render=TRender(160, 120), device="cpu")
    p = seen["params"]
    assert p["device"] == "cpu"
    assert p["sdf_params"] == core.get_sdf_opts()
    assert p["skeleton_graph_gen_opts"] == core.skeleton_graph_gen_opts
    for f in range(2):
        core.stage_depth(fake_frame(f, x=0.05 * f), fake_depth_msg())
        core.process_taichi()
    assert core.post_submap_fusion_count == 1
    d = core.shared_map_d
    assert d["update"] is True
    assert set(d["map_data"]) >= {"indices", "TSDF", "W_TSDF", "occupy",
                                  "color"}
    assert all(isinstance(v, (np.ndarray, list, float, int, bool))
               for v in d["map_data"].values())
    assert len(d["map_data"]["TSDF"]) == core.mapping.global_map.count_active()
    np.testing.assert_array_equal(core.render.skeleton_edges[0],
                                  np.ones((4, 3)))
    topo = core.topo
    core.end_topo_thread()
    assert d["exit"] is True and topo.terminated and topo.joined
    assert core.topo is None


def test_default_worker_uses_spawn(monkeypatch):
    """Without a factory the worker starts in a ``spawn`` process (CUDA
    cannot start in a forked child), its Manager too, with TopoGenThread as
    target and the core's device in its parameters."""
    import multiprocessing
    from taichislam_tpu_torch.node.topo_worker import TopoGenThread
    asked = []

    class Man:
        def dict(self):
            return {}

        def shutdown(self):
            asked.append("shutdown")

    ctx = SimpleNamespace(Manager=Man, Process=_FakeProcess)

    def get_context(method=None):
        asked.append(method)
        return ctx
    monkeypatch.setattr(multiprocessing, "get_context", get_context)
    core = TCore(get_param=_getter({"~enable_skeleton_graph_gen": True}),
                 device="cpu")
    assert asked == ["spawn"]
    proc = core.topo
    assert proc.started and proc.target is TopoGenThread
    params, shared = proc.args
    assert params["device"] == "cpu" and shared is core.shared_map_d
    assert shared == {"exit": False, "update": False,
                      "topo_graph_viz": None}
    core.end_topo_thread()
    assert proc.terminated and asked == ["spawn", "shutdown"]
    assert tcore.TaichiSLAMNodeCore is TCore
