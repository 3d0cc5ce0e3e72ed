"""Block-sharded integrate and surface gather: the port against the JAX
package's ``parallel/block_sharded.py``.

The scene is that of tests/test_parallel.py (24x32 depth from a numpy seed,
V = 8), two frames, in 16 slots: 4 ranks hold 4 rows each, and the map's
blocks fall on every rank. JAX runs on a mesh of n of the 8 virtual CPU
devices; the port on n gloo ranks (one in this process, or 4 spawned).
JAX takes ``pallas_accum="on"``: its ray bins then sum through the Pallas
kernel in interpret mode in sorted order, as the port's K1 does (its XLA
bin sums round otherwise, ~1e-5 relative); both packages scatter the march
lanes in f32.
Bounds (JAX's own, tests/test_parallel.py:126-167 and :199-233): touched
bitmaps, tables, observed and occupancy exact, TSDF / W / color within
1e-5; the gathered mini state's tables exact; its surface export and its
marching-cubes mesh equal in count, the export's rows within 1e-5 and the
vertices within the mesher parity's 1e-4 m. n ranks of the port equal one
rank exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import exports as je  # noqa: E402
from taichislam_tpu.ops import marching_cubes as jmc  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu.parallel import block_sharded as jbs  # noqa: E402
from taichislam_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import exports as te  # noqa: E402
from taichislam_tpu_torch.ops import marching_cubes as tmc  # noqa: E402
from taichislam_tpu_torch.parallel import mesh as pm  # noqa: E402

KW = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=1.5, min_ray_length=0.3, recast_step=2,
          max_blocks=15, max_bins=1024, max_submap_num=4)
CAP = 16


def _kw(textured):
    return dict(KW, texture_enabled=textured)


def _frames(textured):
    rng = np.random.default_rng(1)
    out = []
    for f in range(2):
        depth = rng.integers(400, 1400, size=(24, 32)).astype(np.uint16)
        tex = (rng.integers(0, 255, size=(24, 32, 3)).astype(np.uint8)
               if textured else np.zeros((1, 1, 3), np.uint8))
        out.append((depth, tex, np.eye(3, dtype=np.float32),
                    np.asarray([0.15 * f, 0.1 * f, 0.0], np.float32)))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax(n, textured):
    cfg = JConfig(pallas_accum="on", **_kw(textured))
    mesh = jax_mesh(n, "block")
    state = jbs.shard_state(jt.make_tsdf_state(cfg), mesh, "block")
    step = jbs.sharded_integrate_depth(cfg, mesh, "block")
    K = jnp.asarray(workers.K)
    touched = []
    for depth, tex, R, T in _frames(textured):
        state, t = step(state, jnp.asarray(depth), jnp.asarray(tex),
                        jnp.asarray(R), jnp.asarray(T), K, K, jnp.int32(0))
        touched.append(np.asarray(t))
    mini, n_kept, ov = jbs.gather_surface_blocks(cfg, mesh, CAP)(
        state, jnp.int32(0))
    return dict(state=_np(state), touched=touched, mini=_np(mini),
                n_kept=int(n_kept), overflow=int(ov))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(side, n, textured):
        key = (side, n, textured)
        if key not in cache:
            if side == "jax":
                cache[key] = _jax(n, textured)
            elif n == 1:
                cache[key] = workers.sharded_integrate(
                    pm.make_mesh(1, "block", device="cpu"), _kw(textured),
                    _frames(textured), CAP)
            else:
                res = pm.spawn_mesh(
                    workers.sharded_integrate, n, backend="gloo",
                    device="cpu", args=(_kw(textured), _frames(textured),
                                        CAP), axis="block",
                    store_dir=tmp_path_factory.mktemp("store"))
                for r in res[1:]:        # the same map on every rank
                    _assert_same(r, res[0])
                cache[key] = res[0]
        return cache[key]
    return get


def _assert_grids(j, p, atol):
    for name in ("table", "block_coords", "block_active", "num_blocks"):
        np.testing.assert_array_equal(getattr(j, name), getattr(p, name),
                                      err_msg=name)
    for name in j.channels:
        a = np.asarray(j.channels[name])
        b = p.channels[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("TSDF_observed", "occupy"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


def _assert_same(a, b):
    for x, y in zip(a["touched"], b["touched"]):
        np.testing.assert_array_equal(x, y)
    for k in ("state", "mini"):
        _assert_grids(a[k], b[k], 0.0)
    assert (a["n_kept"], a["overflow"]) == (b["n_kept"], b["overflow"])


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("n", [1, 4])
def test_sharded_integrate_matches_jax(runs, n, textured):
    j, p = runs("jax", n, textured), runs("port", n, textured)
    assert int(p["state"].num_blocks) > 12
    for a, b in zip(j["touched"], p["touched"]):
        np.testing.assert_array_equal(a, b)
        assert b.any()
    _assert_grids(j["state"], p["state"], 1e-5)


@pytest.mark.parametrize("n", [1, 4])
def test_surface_gather_matches_jax(runs, n):
    j, p = runs("jax", n, False), runs("port", n, False)
    assert (p["n_kept"], p["overflow"]) == (j["n_kept"], j["overflow"])
    assert 0 < p["n_kept"] <= CAP
    _assert_grids(j["mini"], p["mini"], 1e-5)

    # the single-device export and mesher on either package's mini state
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    jmini_cfg = jbs.surface_block_cfg(jcfg, CAP)
    tmini_cfg = TConfig(**dict(KW, max_blocks=CAP))
    jm = jax.tree_util.tree_map(jnp.asarray, j["mini"])
    tm = bridge.grid_state_from_numpy(p["mini"], device="cpu")
    bR = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    bT = np.zeros((4, 3), np.float32)
    xj = je.tsdf_surface_export(jmini_cfg, 4096, CAP, jm, jnp.asarray(bR),
                                jnp.asarray(bT), jnp.int32(0))
    xt = te.tsdf_surface_export(tmini_cfg, 4096, CAP, tm,
                                torch.from_numpy(bR), torch.from_numpy(bT), 0)
    k = int(xj[5])
    assert int(xt[5]) == k > 0

    def keyed(x, y, z, t):
        rows = np.stack([np.asarray(v)[:k] for v in (x, y, z, t)], axis=1)
        return rows[np.lexsort(rows.T)]
    np.testing.assert_allclose(keyed(*xt[:3], xt[4]), keyed(*xj[:3], xj[4]),
                               rtol=0, atol=1e-5)

    thres = float(jcfg.tsdf_surface_thres)
    mj = jmc.extract_mesh(jmini_cfg, 4096, 1, CAP, jm, jnp.int32(0),
                          jnp.float32(thres))
    mt = tmc.extract_mesh(tmini_cfg, 4096, 1, CAP, tm, 0, thres)
    nt = int(mj["num_triangles"])
    assert int(mt["num_triangles"]) == nt > 0
    np.testing.assert_allclose(
        np.sort(mt["vertices"].numpy()[:nt * 3], axis=0),
        np.sort(np.asarray(mj["vertices"])[:nt * 3], axis=0), rtol=0,
        atol=1e-4)
    assert tcfg.grid.table_size == tm.table.shape[0]


@pytest.mark.parametrize("textured", [False, True])
def test_four_ranks_equal_one_rank(runs, textured):
    _assert_same(runs("port", 4, textured), runs("port", 1, textured))
