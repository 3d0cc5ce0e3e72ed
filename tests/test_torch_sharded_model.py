"""ShardedDenseTSDF: the port's model against the JAX package's.

The scene of tests/test_parallel.py:537-619 — three 24x32 frames from a
numpy seed, ESDF 16 sweeps at cap 64, surface cap 64 — with the
default V = 16 (the JAX model keeps V = 16 whatever it is given), in 16
slots, so 4 ranks hold 4 rows each and the map spans two of them. JAX runs
on a mesh of n of the 8 virtual CPU devices, its sharded integrate rebuilt
with ``pallas_accum="on"`` so that its ray bins sum in the sorted order of
the port's K1; the port on n gloo ranks (one in this process, or 4
spawned). Tables, observed flags, sweep counts and the export and triangle
counts are exact; TSDF within 1e-5, the ESDF within 4e-3 and the mesh
vertices within 1e-4 m (the exact ESDF bar belongs to the carried-state
tests of tests/test_torch_sharded_esdf.py). n ranks of the port equal one
rank exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from taichislam_tpu.models.sharded_dense_tsdf import ShardedDenseTSDF as JModel  # noqa: E402,E501
from taichislam_tpu.parallel.block_sharded import sharded_integrate_depth  # noqa: E402,E501
from taichislam_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from taichislam_tpu_torch.parallel import mesh as pm  # noqa: E402

OPTS = dict(map_scale=[3.2, 3.2], voxel_scale=0.1, max_ray_length=1.5,
            min_ray_length=0.3, max_blocks=15, max_bins=1024,
            max_submap_num=4, enable_esdf=True, max_esdf_sweeps=16,
            esdf_block_cap=64, surface_block_cap=64, max_triangles=1 << 14)


def _frames():
    rng = np.random.default_rng(2)
    return [(rng.integers(400, 1400, size=(24, 32)).astype(np.uint16),
             np.eye(3, dtype=np.float32),
             np.asarray([0.1 * f, 0.05 * f, 0.0], np.float32))
            for f in range(3)]


def _jax(n):
    mesh = jax_mesh(n, "block")
    m = JModel(mesh=mesh, **OPTS)
    m.cfg = dataclasses.replace(m.cfg, pallas_accum="on")
    m._integrate_fn = sharded_integrate_depth(m.cfg, mesh)
    m._esdf_cap_bucket = 64
    m.set_dep_camera_intrinsic(workers.K)
    per = []
    for depth, R, T in _frames():
        m.recast_depth_to_map(R, T, depth)
        st = jax.tree_util.tree_map(np.asarray, m.state)
        per.append(dict(state=st, esdf=np.asarray(m.esdf),
                        fixed=np.asarray(m.esdf_fixed),
                        pending=np.asarray(m._esdf_pending),
                        sweeps=m.last_esdf_sweeps))
    m.cvt_TSDF_surface_to_voxels()
    out = m.extract_mesh(incremental=True)
    nt = int(out["num_triangles"])
    again = int(m.extract_mesh(incremental=True)["num_triangles"])
    return dict(per=per, xyz=m.export_TSDF_xyz, tsdf=m.export_TSDF,
                n_surface=m.num_TSDF_particles,
                vertices=np.asarray(out["vertices"])[:nt * 3], again=again,
                count_active=m.count_active(),
                esdf_dict=len(m.get_esdf_dict()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(side, n):
        if (side, n) not in cache:
            if side == "jax":
                cache[side, n] = _jax(n)
            elif n == 1:
                cache[side, n] = workers.sharded_model(
                    pm.make_mesh(1, "block", device="cpu"), OPTS, _frames())
            else:
                res = pm.spawn_mesh(
                    workers.sharded_model, n, backend="gloo", device="cpu",
                    args=(OPTS, _frames()), axis="block",
                    store_dir=tmp_path_factory.mktemp("store"))
                for r in res[1:]:
                    _assert_equal(res[0], r)
                cache[side, n] = res[0]
        return cache[side, n]
    return get


def _rows(a):
    return a[np.lexsort(a.T[::-1])]


def _assert_equal(a, b):
    for x, y in zip(a["per"], b["per"]):
        assert x["sweeps"] == y["sweeps"]
        for k in ("esdf", "fixed", "pending"):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        for k in x["state"]._fields[:-1]:
            np.testing.assert_array_equal(getattr(x["state"], k),
                                          getattr(y["state"], k), err_msg=k)
        for k, v in x["state"].channels.items():
            np.testing.assert_array_equal(v, y["state"].channels[k],
                                          err_msg=k)
    for k in ("xyz", "tsdf", "vertices"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("n_surface", "again", "count_active", "esdf_dict"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_model_matches_jax(runs, n):
    j, p = runs("jax", n), runs("port", n)
    for f, (a, b) in enumerate(zip(j["per"], p["per"])):
        for k in ("table", "block_coords", "block_active", "num_blocks"):
            np.testing.assert_array_equal(getattr(a["state"], k),
                                          getattr(b["state"], k), err_msg=k)
        for k in ("TSDF_observed", "occupy"):
            np.testing.assert_array_equal(a["state"].channels[k],
                                          b["state"].channels[k], err_msg=k)
        np.testing.assert_allclose(b["state"].channels["TSDF"],
                                   a["state"].channels["TSDF"], rtol=0,
                                   atol=1e-5)
        obs = a["state"].channels["TSDF_observed"] > 0
        np.testing.assert_allclose(b["esdf"][obs], a["esdf"][obs], rtol=0,
                                   atol=4e-3)
        assert b["sweeps"] == a["sweeps"] > 0, f
    k = j["n_surface"]
    assert p["n_surface"] == k > 0
    np.testing.assert_allclose(_rows(p["xyz"][:k]), _rows(j["xyz"][:k]),
                               rtol=0, atol=1e-6)
    nt = len(j["vertices"]) // 3
    assert len(p["vertices"]) // 3 == nt > 0
    np.testing.assert_allclose(_rows(p["vertices"]), _rows(j["vertices"]),
                               rtol=0, atol=1e-4)
    assert p["again"] == j["again"] == 0
    assert p["count_active"] == j["count_active"] > 0
    assert p["esdf_dict"] == j["esdf_dict"] > 0
    assert p["cfg_V"] == 16 and p["max_blocks"] == 15


def test_four_ranks_equal_one_rank(runs):
    _assert_equal(runs("port", 4), runs("port", 1))


def test_block_size_is_the_one_asked_for():
    """A divergence from the JAX model, which keeps V = 16: the port's
    model builds the block size it is given."""
    from taichislam_tpu_torch.models.sharded_dense_tsdf import \
        ShardedDenseTSDF
    m = ShardedDenseTSDF(**dict(OPTS, num_voxel_per_blk_axis=8),
                         device="cpu")
    assert m.cfg.grid.V == 8 and m.esdf.shape == (16, 512)
