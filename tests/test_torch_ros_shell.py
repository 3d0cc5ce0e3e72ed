"""Drive the port's rospy shell (taichislam_tpu_torch/node/ros_node.py)
under the fake ROS of tests/test_ros_shell.py, on the CPU.

The twins of that file's tests: subscriber and synchronizer wiring, the
depth-frame callback to /dense_mapping, the PointCloud2 input branch, the
esdf type's slice cloud and the 100 Hz slam_main loop. The shell builds the
port's node core with ``device="cpu"``; the clouds it publishes are built by
the port's ``point_cloud`` codec, whose messages equal the JAX codec's.
"""

import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.test_ros_shell import (PARAMS, _make_fake_ros, fake_depth_msg,  # noqa: E402,E501
                                  fake_frame)

SHELL = "taichislam_tpu_torch.node.ros_node"


def _import_shell(monkeypatch, params, published, sleep_hook):
    mods = _make_fake_ros(params, published, sleep_hook)
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.delitem(sys.modules, SHELL, raising=False)
    module = importlib.import_module(SHELL)
    monkeypatch.setitem(sys.modules, SHELL, module)
    return module, mods


@pytest.fixture()
def shell(monkeypatch):
    """Inject the fake ROS and import the port's shell fresh."""
    published = []
    hooks = {"sleep": lambda tick: None}
    module, mods = _import_shell(monkeypatch, PARAMS, published,
                                 lambda tick: hooks["sleep"](tick))
    yield SimpleNamespace(module=module, published=published,
                          registry=mods["message_filters"]._registry,
                          hooks=hooks)
    sys.modules.pop(SHELL, None)


def test_shell_wiring_and_depth_publish(shell):
    """Construct the port's TaichiSLAMNode: subscriber topics, synchronizer
    signatures, then depth-frame callback -> recast -> /dense_mapping."""
    node = shell.module.TaichiSLAMNode(device="cpu")
    assert node.mapping.device == torch.device("cpu")
    topics = {s.topic for s in (node.depth_sub, node.pointcloud_sub,
                                node.frame_sub)}
    assert topics == {"~depth", "~pointcloud", "~frame_local"}
    assert node.traj_sub.topic == "~traj"
    assert node.traj_sub.cb == node.traj_callback
    assert [s.topic for s in node.ts.subs] == ["~depth", "~frame_local"]
    assert [s.topic for s in node.ts_pcl.subs] == ["~pointcloud",
                                                   "~frame_local"]
    assert node.ts.slop == pytest.approx(0.03)

    node.ts.cb(fake_depth_msg(value=1000), fake_frame(0))
    assert node.updated
    node.process_taichi()
    assert node.count == 1

    assert len(shell.published) == 1
    topic, msg = shell.published[0]
    assert topic == "/dense_mapping"
    assert msg.header.frame_id == "world"
    assert [f.name for f in msg.fields] == ["x", "y", "z"]
    xyz = np.frombuffer(msg.data, np.float32).reshape(-1, 3)
    assert msg.width == len(xyz) > 0
    assert 0.7 < np.median(xyz[:, 2]) < 1.3

    # the same cloud through the JAX package's codec gives the same message
    from taichislam_tpu.utils.ros_pcl_transfer import point_cloud
    ref = point_cloud(xyz, "world", has_rgb=False)
    assert ref.data == msg.data and ref.width == msg.width
    assert [(f.name, f.offset, f.datatype) for f in ref.fields] == \
        [(f.name, f.offset, f.datatype) for f in msg.fields]


def test_shell_pcl_path_roundtrip(shell):
    """PointCloud2 input: encode with the port's point_cloud codec, feed the
    ts_pcl synchronizer, and check the pcl recast branch integrates it."""
    node = shell.module.TaichiSLAMNode(device="cpu")
    from taichislam_tpu_torch.utils.ros_pcl_transfer import point_cloud
    zz, yy = np.meshgrid(np.linspace(-0.4, 0.4, 16),
                         np.linspace(-0.4, 0.4, 16))
    pts = np.stack([yy.ravel(), zz.ravel(),
                    np.full(yy.size, 1.0)], axis=1).astype(np.float32)
    cloud = point_cloud(pts, "world", has_rgb=False)
    node.ts_pcl.cb(cloud, fake_frame(0))
    assert node.updated_pcl
    node.process_taichi()
    assert node.count == 1
    assert node.mapping.submap_collection.count_active() > 0


def test_shell_esdf_type_publishes_slice(monkeypatch):
    """mapping_type=esdf under the fake-ROS shell: DenseESDF end to end,
    the distance-field z-slice published (rgb-coded) after the surface
    cloud."""
    published = []
    params = dict(PARAMS)
    params.update({"~enable_submap": False, "~mapping_type": "esdf",
                   "~esdf/publish_slice_z": 1.0})
    module, _ = _import_shell(monkeypatch, params, published,
                              lambda tick: None)
    try:
        node = module.TaichiSLAMNode(device="cpu")
        from taichislam_tpu_torch.models.dense_esdf import DenseESDF
        assert isinstance(node.mapping, DenseESDF)
        # non-submap mode registers process_depth_pose, a no-op (a TODO in
        # TaichiSLAM's node too) — stage directly
        node.stage_depth(fake_frame(0), fake_depth_msg(value=1000))
        node.process_taichi()
    finally:
        sys.modules.pop(SHELL, None)
    msgs = [m for t, m in published if t == "/dense_mapping"]
    assert len(msgs) == 2      # surface cloud + ESDF slice cloud
    slice_msg = msgs[-1]
    assert [f.name for f in slice_msg.fields] == ["x", "y", "z", "r", "g",
                                                  "b"]
    assert slice_msg.width > 0


def test_slam_main_loop(shell):
    """The 100 Hz main loop: frames arrive between ticks, process_taichi
    consumes them, the loop exits on is_shutdown, the topo thread is torn
    down."""
    def on_sleep(tick):
        ts = [s for s in shell.registry
              if s.subs and s.subs[0].topic == "~depth"][-1]
        if tick <= 2:
            ts.cb(fake_depth_msg(value=1000),
                  fake_frame(tick - 1, x=0.05 * (tick - 1)))
    shell.hooks["sleep"] = on_sleep

    shell.module.slam_main(device="cpu")

    depth_pubs = [m for t, m in shell.published if t == "/dense_mapping"]
    assert len(depth_pubs) == 2
    assert all(m.width > 0 for m in depth_pubs)
