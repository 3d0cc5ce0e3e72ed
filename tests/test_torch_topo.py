"""Topo graph: the PyTorch port against the JAX package.

The box room of tests/test_topo.py (an observed free box with walls, the
TSDF written directly) and a 6 m wide slab of free space between a floor
and a ceiling (whose level rays stay white, so the graph grows frontiers
and edges) are loaded into both packages with ``load_numpy``; the graph is
host numpy around the map's batched raycasts and point queries, so node
counts, edges and frontiers are exact and the facelet arrays agree within
1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.models.dense_tsdf import DenseTSDF as JTSDF  # noqa: E402
from taichislam_tpu.models import topo_graph as jtopo  # noqa: E402
from taichislam_tpu_torch.models import topo_graph as ttopo  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TTSDF  # noqa: E402,E501
from taichislam_tpu_torch.node.topo_worker import TopoGen  # noqa: E402

ROOM = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_blocks=2048, max_submap_num=4, max_ray_length=3.0)


def box_room():
    """(ijk, tsdf) of tests/test_topo.py's room: +-1.2 m, TSDF = distance
    to the nearest wall."""
    r = np.arange(-12, 13)
    ii, jj, kk = np.meshgrid(r, r, r, indexing="ij")
    ijk = np.stack([ii, jj, kk], -1).reshape(-1, 3)
    tsdf = (1.2 - np.max(np.abs(ijk * 0.1), axis=-1)).astype(np.float32)
    return ijk, tsdf


def slab():
    """(ijk, tsdf) of free space |z| < 0.65 m, |x|, |y| < 2.95 m: TSDF =
    distance to the nearest wall, 0 outside."""
    r, rz = np.arange(-30, 31), np.arange(-8, 9)
    ii, jj, kk = np.meshgrid(r, r, rz, indexing="ij")
    ijk = np.stack([ii, jj, kk], -1).reshape(-1, 3)
    p = ijk * 0.1
    d = np.minimum(0.65 - np.abs(p[:, 2]),
                   2.95 - np.maximum(np.abs(p[:, 0]), np.abs(p[:, 1])))
    return ijk, np.maximum(d, 0.0).astype(np.float32)


SCENES = {"box room": box_room, "slab": slab}


def load(cls, scene="box room", **kw):
    m = cls(**ROOM, **kw)
    ijk, tsdf = SCENES[scene]()
    m.load_numpy(0, ijk, tsdf, np.ones_like(tsdf), np.zeros(len(tsdf)),
                 np.array([]))
    return m


@pytest.fixture(scope="module")
def rooms():
    return load(JTSDF), load(TTSDF, device="cpu")


def test_fibonacci_sphere_and_moller_trumbore_equal_jax():
    for n in (16, 64, 128):
        np.testing.assert_array_equal(ttopo.fibonacci_sphere(n),
                                      jtopo.fibonacci_sphere(n))
    rng = np.random.default_rng(0)
    v0, e1, e2 = (rng.normal(size=(50, 3)).astype(np.float32)
                  for _ in range(3))
    P = rng.normal(size=3).astype(np.float32)
    w = rng.normal(size=3).astype(np.float32)
    for a, b in zip(ttopo._moller_trumbore(v0, e1, e2, P, w),
                    jtopo._moller_trumbore(v0, e1, e2, P, w)):
        np.testing.assert_array_equal(a, b)
    W = rng.normal(size=(7, 3)).astype(np.float32)
    for a, b in zip(ttopo._moller_trumbore_fan(v0, e1, e2, P, W),
                    jtopo._moller_trumbore_fan(v0, e1, e2, P, W)):
        np.testing.assert_array_equal(a, b)


def test_detect_collisions_matches_jax(rooms):
    """64 rays from the room's centre: every one is black, with the JAX
    graph's lengths."""
    jm, tm = rooms
    jt = jtopo.TopoGraphGen(jm, coll_det_num=64, max_raycast_dist=2.0)
    tt = ttopo.TopoGraphGen(tm, coll_det_num=64, max_raycast_dist=2.0)
    start = np.zeros(3, np.float32)
    assert tt.detect_collisions(start) == jt.detect_collisions(start)
    assert tt.black_num == jt.black_num == 64 and tt.white_num == 0
    np.testing.assert_array_equal(tt.black_lens, jt.black_lens)
    np.testing.assert_array_equal(tt.black_dirs, jt.black_dirs)
    assert tt.host_syncs == 1


def graph_of(topo):
    return (topo.num_nodes, topo.num_frontiers, len(topo.edges),
            sorted(topo.connected),
            [n["master"] for n in topo.nodes],
            [(n["start"], n["end"]) for n in topo.nodes])


@pytest.mark.parametrize("scene", list(SCENES))
def test_generate_topo_graph_matches_jax(rooms, scene):
    jm, tm = rooms if scene == "box room" else (
        load(JTSDF, scene), load(TTSDF, scene, device="cpu"))
    kw = dict(coll_det_num=64, max_raycast_dist=2.0, thres_size=0.2)
    jt = jtopo.TopoGraphGen(jm, **kw)
    tt = ttopo.TopoGraphGen(tm, **kw)
    nj = jt.generate_topo_graph([0.0, 0.0, 0.0], max_nodes=10)
    nt = tt.generate_topo_graph([0.0, 0.0, 0.0], max_nodes=10)
    assert nt == nj >= 1 and tt.num_facelets == jt.num_facelets > 10
    if scene == "slab":
        assert nt > 1 and tt.num_frontiers > 0 and len(tt.edges) > 0
    assert graph_of(tt) == graph_of(jt)
    for name in ("fl_v0", "fl_e1", "fl_e2", "fl_normal", "fl_center"):
        np.testing.assert_allclose(getattr(tt, name), getattr(jt, name),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tt.fl_poly, jt.fl_poly)
    np.testing.assert_array_equal(tt.fl_frontier, jt.fl_frontier)
    for a, b in zip(tt.frontiers, jt.frontiers):
        assert a["master_idx"] == b["master_idx"]
        assert a["is_valid"] == b["is_valid"]
        np.testing.assert_allclose(a["projected_center"],
                                   b["projected_center"], atol=1e-5)
    np.testing.assert_allclose(np.asarray(tt.edges), np.asarray(jt.edges),
                               atol=1e-5)
    # inside the room and the raycast range; inside the map for the slab
    assert np.all(np.abs(tt.tri_vertices) < (2.5 if scene == "box room"
                                             else 3.2))
    assert tt.host_syncs > 0


def test_topo_gen_worker_with_a_plain_dict(rooms):
    """TopoGen on a plain dict as its manager dict: loadMap from the
    exported map, one skeleton graph, the edge lines posted back."""
    _, tm = rooms
    idx, tsdf, w, occ, _ = tm.to_numpy()
    man_d = {"exit": False, "update": True, "start_pt": [0.0, 0.0, 0.0],
             "map_data": {"indices": idx, "TSDF": tsdf, "W_TSDF": w,
                          "occupy": occ, "color": np.array([])}}
    gen = TopoGen(ROOM, dict(coll_det_num=64, max_raycast_dist=2.0,
                             thres_size=0.2), man_d, device="cpu")
    gen.loadMap(man_d["map_data"])
    assert gen.mapping.count_active() == tm.count_active()
    gen.gen_skeleton_graph()
    assert gen.topo.num_nodes >= 1
    lines = man_d["topo_graph_viz"]["lines"]
    assert lines.dtype == np.float32 and lines.shape == (
        2 * len(gen.topo.edges), 3)


def test_verify_frontier_raycast_and_benchmark_match_jax(capsys):
    """On the slab: the combined polyhedron + map raycast from the seed,
    and verify_frontier on every frontier of a three-node graph, equal the
    JAX graph's; node_expansion_benchmark prints both timings."""
    jm, tm = load(JTSDF, "slab"), load(TTSDF, "slab", device="cpu")
    kw = dict(coll_det_num=64, max_raycast_dist=2.0, thres_size=0.2)
    jt, tt = jtopo.TopoGraphGen(jm, **kw), ttopo.TopoGraphGen(tm, **kw)
    for topo in (jt, tt):
        topo.generate_topo_graph([0.0, 0.0, 0.0], max_nodes=3)
    dirs = ttopo.fibonacci_sphere(32)
    pos = np.float32([0.3, -0.2, 0.1])
    for a, b in zip(tt.raycast(pos, dirs, 2.0, skip_idx=0),
                    jt.raycast(pos, dirs, 2.0, skip_idx=0)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert tt.num_frontiers == jt.num_frontiers > 0
    for i in range(tt.num_frontiers):
        assert tt.verify_frontier(i) == jt.verify_frontier(i)
        a, b = tt.frontiers[i], jt.frontiers[i]
        if a["is_valid"]:
            np.testing.assert_allclose(a["next_node_initial"],
                                       b["next_node_initial"], atol=1e-5)
    tt.node_expansion_benchmark([0.0, 0.0, 0.0], run_num=2)
    out = capsys.readouterr().out
    assert "avg detect_collisions" in out and "avg gen convex" in out
