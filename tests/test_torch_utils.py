"""The port's host utilities against the JAX package's: the headless
renderer, the ROS interop codecs, the WebGL viewer server and its software
mirror (twins of tests/test_utils.py and tests/test_viewer.py, each also
held to the JAX module on the same arrays), the profiling twin, and the
new entry points (compiled, and the offline demo's smoke fill on the CPU
against the JAX demo's).
"""

import hashlib
import json
import os
import py_compile
import struct
import sys
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.utils import ros_pcl_transfer as jrpt  # noqa: E402
from taichislam_tpu.utils import viewer_server as jvs  # noqa: E402
from taichislam_tpu.utils import viewer_softrender as jsoft  # noqa: E402
from taichislam_tpu.utils.profiling import StageTimer as JTimer  # noqa: E402
from taichislam_tpu.utils.visualization import \
    TaichiSLAMRender as JRender  # noqa: E402
from taichislam_tpu_torch.utils import profiling  # noqa: E402
from taichislam_tpu_torch.utils import ros_pcl_transfer as rpt  # noqa: E402
from taichislam_tpu_torch.utils import viewer_server as tvs  # noqa: E402
from taichislam_tpu_torch.utils import viewer_softrender as tsoft  # noqa: E402,E501
from taichislam_tpu_torch.utils.visualization import \
    TaichiSLAMRender as TRender  # noqa: E402


# -- headless renderer -------------------------------------------------------

def _stage(r, rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    r.set_particles(pts, cols)
    r.set_drone_pose(0, np.eye(3), np.zeros(3))
    r.set_drone_trajectory(0, np.cumsum(rng.normal(size=(20, 3)), axis=0))
    tris = rng.normal(size=(12, 3)).astype(np.float32)
    r.set_mesh(tris, np.ones((12, 3), np.float32) * 0.5)
    r.set_skeleton_graph_edges(rng.normal(size=(4, 3)).astype(np.float32))


def test_renderer_headless_frame(tmp_path):
    """Both packages' renderers draw the same staged scene to the same
    pixels."""
    import matplotlib.image as mpimg
    frames = []
    for cls, sub in ((TRender, "port"), (JRender, "jax")):
        out = tmp_path / sub
        out.mkdir()
        r = cls(320, 240, save_path=str(out))
        _stage(r, np.random.default_rng(0))
        r.rendering()
        r.close()
        png = out / "frame_00000.png"
        assert png.exists() and png.stat().st_size > 1000
        frames.append(mpimg.imread(str(png)))
    np.testing.assert_array_equal(frames[0], frames[1])


# -- ROS interop -------------------------------------------------------------

class _Field:
    def __init__(self, name, offset, datatype):
        self.name, self.offset, self.datatype = name, offset, datatype
        self.count = 1


class _Msg:
    pass


def test_pointcloud2_codec_roundtrip():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    pts[5] = np.nan  # one invalid point

    msg = _Msg()
    msg.fields = [_Field("x", 0, 7), _Field("y", 4, 7), _Field("z", 8, 7)]
    msg.point_step = 12
    msg.height, msg.width = 1, 100
    msg.data = pts.tobytes()

    arr = rpt.pointcloud2_to_array(msg)
    xyz, rgb = rpt.get_xyz_rgb_points(arr)
    assert xyz.shape == (99, 3)
    assert rgb is None
    np.testing.assert_allclose(xyz[:5], pts[:5], rtol=1e-6)
    jxyz, jrgb = jrpt.pointcloud2_to_xyz_rgb_array(msg)
    np.testing.assert_array_equal(jxyz, xyz)
    assert jrgb is None


def test_packed_rgb_unpack():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 1 << 24, 16).astype(np.uint32)
    packed[0] = (255 << 16) | (128 << 8) | 1
    data_rgb = np.empty(16, dtype=[("x", np.float32), ("y", np.float32),
                                   ("z", np.float32), ("rgb", np.float32)])
    data_rgb["x"] = data_rgb["y"] = data_rgb["z"] = 1.0
    data_rgb["rgb"] = packed.view(np.float32)

    msg = _Msg()
    msg.fields = [_Field("x", 0, 7), _Field("y", 4, 7), _Field("z", 8, 7),
                  _Field("rgb", 12, 7)]
    msg.point_step = 16
    msg.height, msg.width = 1, 16
    msg.data = data_rgb.tobytes()

    xyz, rgb = rpt.pointcloud2_to_xyz_rgb_array(msg)
    assert rgb is not None
    np.testing.assert_array_equal(rgb[0], [255, 128, 1])
    jxyz, jrgb = jrpt.pointcloud2_to_xyz_rgb_array(msg)
    np.testing.assert_array_equal(jrgb, rgb)
    np.testing.assert_array_equal(jxyz, xyz)


def _pose(q, t):
    class Q:
        x, y, z, w = (float(v) for v in q)

    class P:
        x, y, z = (float(v) for v in t)

    class Pose:
        orientation = Q()
        position = P()
    return Pose()


def test_pose_conversion_helpers():
    R, T = rpt.pose_msg_to_numpy(_pose([0, 0, 0, 1], [1, 2, 3]))
    np.testing.assert_allclose(R, np.eye(3), atol=1e-7)
    np.testing.assert_allclose(T, [1, 2, 3])
    rng = np.random.default_rng(2)
    for _ in range(8):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        R, T = rpt.pose_msg_to_numpy(_pose(q, t))
        jR, jT = jrpt.pose_msg_to_numpy(_pose(q, t))
        np.testing.assert_allclose(R, jR, atol=1e-6)
        np.testing.assert_array_equal(T, jT)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        tf = _Msg()
        tf.transform = _Msg()
        tf.transform.rotation = _pose(q, t).orientation
        tf.transform.translation = _pose(q, t).position
        Rdb = np.diag([1.0, -1.0, -1.0])
        for a, b in zip(rpt.transform_msg_to_numpy(tf, Rdb),
                        jrpt.transform_msg_to_numpy(tf, Rdb)):
            np.testing.assert_allclose(a, b, atol=1e-6)


# -- the WebGL viewer server and its software mirror -------------------------

@pytest.fixture()
def renders():
    rs = [m.InteractiveRender(port=0, announce=False) for m in (tvs, jvs)]
    yield rs
    for r in rs:
        r.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as f:
        return f.read()


def _parse_scene(blob):
    magic, version = struct.unpack_from("<II", blob, 0)
    assert magic == tvs._MAGIC
    off, sections = 8, {}
    while off + 8 <= len(blob):
        tag, ln = struct.unpack_from("<II", blob, off)
        off += 8
        sections.setdefault(tag, []).append(
            np.frombuffer(blob, np.float32, ln // 4, off))
        off += ln
    return version, sections


def test_viewer_page_and_scene_roundtrip(renders):
    """The port serves the JAX viewer's page, and the same staged scene as
    the same scene.bin bytes."""
    render, jrender = renders
    url = render.server.url
    page = _get(url).decode()
    assert "scene.bin" in page and "webgl" in page
    assert "http" not in page.split("</title>")[1]  # fully offline
    assert page == _get(jrender.server.url).decode() == jvs._PAGE

    par = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]], np.float32)
    col = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    for r in renders:
        r.set_particles(par, col)
        r.set_mesh(np.zeros((6, 3), np.float32),
                   np.full((6, 3), 0.5, np.float32), mesh_num=2)
        r.set_drone_pose(1, np.eye(3), np.array([1.0, 2.0, 3.0]))
        r.set_drone_trajectory(1, np.array([[0, 0, 0], [1, 1, 1]],
                                           np.float32))
        r.set_skeleton_graph_edges(np.array([[0, 0, 0], [0, 0, 1]],
                                            np.float32))
        r.rendering()

    assert json.loads(_get(url + "version"))["version"] == 1
    blob = _get(url + "scene.bin")
    assert blob == _get(jrender.server.url + "scene.bin")
    version, sections = _parse_scene(blob)
    assert version == 1
    np.testing.assert_allclose(sections[1][0].reshape(-1, 3), par)
    np.testing.assert_allclose(sections[2][0].reshape(-1, 3), col)
    assert sections[3][0].size == 18          # mesh vertices
    pose = sections[7][0]
    assert pose[0] == 1.0 and tuple(pose[10:13]) == (1.0, 2.0, 3.0)
    traj = sections[8][0]
    assert traj[0] == 1.0 and traj[1] == 2.0
    assert sections[9][0][0] == pytest.approx(render.particle_radius)

    render.rendering()
    assert json.loads(_get(url + "version"))["version"] == 2


def test_viewer_options_roundtrip(renders):
    """The browser panel POSTs options; rendering() pulls them back into the
    attributes node code reads."""
    render = renders[0]
    url = render.server.url
    body = json.dumps({"particle_radius": 0.05, "slice_z": 1.5,
                       "disp_mesh": False, "enable_mesher": False,
                       "lock_pos_drone": True}).encode()
    req = urllib.request.Request(url + "options", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=5) as f:
        assert f.status == 200
    render.rendering()
    assert render.particle_radius == pytest.approx(0.05)
    assert render.slice_z == pytest.approx(1.5)
    assert render.disp_mesh is False
    assert render.enable_mesher is False
    assert render.lock_pos_drone is True
    assert render.disp_particles is True  # untouched

    req = urllib.request.Request(url + "options", data=b"{bad",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 400
    assert json.loads(_get(url + "options"))["slice_z"] == 1.5


def test_softrender_pixels(renders):
    """The software mirror of the page renders every element to visible
    pixels, and the port's mirror gives the JAX mirror's pixels."""
    render = renders[0]
    th = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    par = np.stack([1.5 * np.cos(th), 1.5 * np.sin(th),
                    0 * th], -1).astype(np.float32)
    col = np.stack([th / th.max(), 1 - th / th.max(),
                    0 * th], -1).astype(np.float32)
    tri = np.array([[-1, -1, 1], [1, -1, 1], [0, 1, 1]], np.float32)
    render.set_particles(par, col)
    render.set_mesh(tri, np.full((3, 3), 0.8, np.float32),
                    np.tile([0, 0, 1.0], (3, 1)).astype(np.float32))
    render.set_drone_pose(0, np.eye(3, dtype=np.float32),
                          np.array([0, -2.0, 0.5], np.float32))
    render.rendering()

    scene, img = tsoft.fetch_and_render(render.server.url, w=400, h=300)
    assert scene.version == 1 and len(scene.par) == 512
    nonbg = np.abs(img - tsoft.CLEAR).max(-1) > 0.01
    assert nonbg.mean() > 0.01
    img_nopts = tsoft.render(scene, w=400, h=300, disp_particles=False)
    img_nomesh = tsoft.render(scene, w=400, h=300, disp_mesh=False)
    n_all = int(nonbg.sum())
    n_nopts = int((np.abs(img_nopts - tsoft.CLEAR).max(-1) > 0.01).sum())
    n_nomesh = int((np.abs(img_nomesh - tsoft.CLEAR).max(-1) > 0.01).sum())
    assert n_nopts < n_all and n_nomesh < n_all
    _, img2 = tsoft.fetch_and_render(render.server.url, w=400, h=300)
    digest = [hashlib.sha256((np.clip(i, 0, 1) * 255).astype(
        np.uint8).tobytes()).hexdigest() for i in (img, img2)]
    assert digest[0] == digest[1]
    jscene, jimg = jsoft.fetch_and_render(render.server.url, w=400, h=300)
    np.testing.assert_array_equal(jimg, img)
    np.testing.assert_array_equal(jsoft.render(jscene, w=400, h=300,
                                               disp_mesh=False), img_nomesh)


# -- profiling ---------------------------------------------------------------

def test_stage_timer_report_and_ema(monkeypatch):
    """The port's StageTimer gives the JAX timer's report line and EMA for
    the same clock readings; ``sync`` with a CPU tensor waits for nothing."""
    import taichislam_tpu.utils.profiling as jprof
    ticks = iter(np.cumsum([0.0, 0.012, 0.001, 0.030, 0.002, 0.020,
                            0.004, 0.009]).tolist() * 2)
    readings = list(ticks)
    lines = []
    for mod, cls in ((profiling, profiling.StageTimer), (jprof, JTimer)):
        it = iter(readings)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        t = cls(alpha=0.2)
        for name in ("t_recast", "t_mesh", "t_recast", "t_mesh"):
            t.start(name)
            t.stop(name, sync=torch.zeros(3) if cls is not JTimer else None)
        lines.append((t.report(), dict(t.ema), dict(t.last)))
        monkeypatch.undo()
    assert lines[0] == lines[1]
    report, ema, last = lines[0]
    assert report.startswith("[TaichiSLAM] Time: t_recast ")
    assert ema["t_recast"] == pytest.approx(0.8 * 12.0 + 0.2 * 20.0)


def test_trace_and_device_trace(tmp_path):
    """trace() is a torch.profiler annotation; device_trace(log_dir), as
    JAX's takes a directory, creates it and writes a Chrome trace holding
    it inside."""
    log_dir = tmp_path / "profile"
    with profiling.device_trace(str(log_dir)):
        with profiling.trace("node_stage"):
            torch.ones(8).sum()
    [path] = list(log_dir.iterdir())
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "node_stage" in names
    t = profiling.StageTimer()
    with t.stage("x", sync_fn=lambda: torch.zeros(1)):
        pass
    assert "x" in t.last


# -- entry points ------------------------------------------------------------

ENTRY_POINTS = ["taichislam_tpu_torch/node/ros_node.py",
                "taichislam_tpu_torch/node/core.py",
                "taichislam_tpu_torch/demo.py",
                "taichislam_tpu_torch/examples/demo_synthetic.py",
                "taichislam_tpu_torch/examples/gen_topo_graph.py"]


@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_entry_points_compile(path, tmp_path):
    """The ROS shell cannot import without rospy; every entry point must at
    least compile."""
    py_compile.compile(path, cfile=str(tmp_path / "out.pyc"), doraise=True)


@pytest.mark.parametrize("method", ["tsdf", "octo"])
def test_demo_smoke_fill_matches_jax(method, monkeypatch, capsys, tmp_path):
    """The port's offline demo (smoke fill, --cpu) exports as many voxels
    as the JAX package's taichislam_demo.py on the same flags."""
    from taichislam_tpu_torch import demo
    monkeypatch.chdir(tmp_path)
    flags = ["-m", method, "--cpu", "--map-size", "6.4", "6.4",
             "--voxel-size", "0.1", "--blk", "8"]
    n = demo.main(flags)
    out = capsys.readouterr().out
    assert f"map voxels exported: {n}" in out and "demo done" in out
    assert n > 0
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        import taichislam_demo
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["taichislam_demo.py"] + flags)
    taichislam_demo.main()
    assert f"map voxels exported: {n}\n" in capsys.readouterr().out
