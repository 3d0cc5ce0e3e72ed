"""Marching tetrahedra and the incremental mesher: the PyTorch port against
the JAX package.

``extract_mesh`` runs in both packages on the same JAX-fused textured map,
carried to the port through the numpy bridge. Bounds: triangle counts and
per-block spans exact, vertices within 1e-4 m, normals within 1e-3, colors
within 1e-4; the wire buffer of ``pack_mesh_delivery`` equal byte for byte.
In the port alone, the incremental re-mesh equals a full extraction
(tests/test_mesher.py:102-140) and the quantized delivery is within 0.5 mm
of the f32 one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.models.dense_tsdf import DenseTSDF as JMap  # noqa: E402
from taichislam_tpu.models.mesher import MarchingCubeMesher as JMesher  # noqa: E402,E501
from taichislam_tpu.ops import marching_cubes as jmc  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TMap  # noqa: E402,E501
from taichislam_tpu_torch.models.mesher import MarchingCubeMesher as TMesher  # noqa: E402,E501
from taichislam_tpu_torch.ops import marching_cubes as tmc  # noqa: E402

KW = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=1.5, min_ray_length=0.3, max_blocks=64,
          max_bins=1024, max_submap_num=4, max_touched_blocks=64,
          texture_enabled=True)
K = np.asarray([20.0, 0, 16.0, 0, 20.0, 12.0, 0, 0, 1], np.float32)
K48 = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
# every port model here runs on the CPU, asked for explicitly (the models
# default to the CUDA card)
DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def scene():
    cj, ct = JConfig(pallas_accum="on", **KW), TConfig(**KW)
    rng = np.random.default_rng(8)
    st = jt.make_tsdf_state(cj)
    jj, ii = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    for f in range(2):
        depth = (900 + 12 * ii + 6 * jj + rng.integers(-20, 20, (24, 32)))
        tex = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        st, _ = jt.integrate_depth(
            cj, st, jnp.asarray(depth.astype(np.uint16)), jnp.asarray(tex),
            jnp.eye(3, dtype=jnp.float32),
            jnp.asarray([0.05 * f, 0.0, 0.0], np.float32), jnp.asarray(K),
            jnp.asarray(K), jnp.int32(0))
    return cj, ct, st


def test_tet_tables_match_jax():
    for a, b in zip(jmc.tet_tri_tables(), tmc.tet_tri_tables()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _compare_mesh(want, got):
    for k in ("num_triangles", "total_triangles", "num_surface_blocks",
              "surface_blocks_dropped", "block_slots", "block_tri_counts"):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)
    for k, tol in (("vertices", 1e-4), ("normals", 1e-3), ("colors", 1e-4)):
        np.testing.assert_allclose(np.asarray(want[k]), got[k].numpy(),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("step,masked", [(1, False), (1, True), (2, False)])
def test_extract_mesh_matches_jax(scene, step, masked):
    cj, ct, st = scene
    mask = None
    if masked:
        mask = np.asarray(st.block_active).copy()
        mask[::3] = False
    want = jmc.extract_mesh(cj, 4096, step, 64, st, jnp.int32(0),
                            jnp.float32(0.25),
                            block_mask=None if mask is None
                            else jnp.asarray(mask))
    got = tmc.extract_mesh(ct, 4096, step, 64,
                           bridge.grid_state_from_numpy(st, device="cpu"),
                           0, 0.25,
                           block_mask=None if mask is None
                           else torch.from_numpy(mask))
    _compare_mesh(want, got)
    n = int(got["num_triangles"])
    assert 100 < n < 4096
    assert got["colors"][:3 * n].std(0).min() > 0.02


def test_extract_mesh_triangle_cap_matches_jax(scene):
    cj, ct, st = scene
    want = jmc.extract_mesh(cj, 64, 1, 64, st, jnp.int32(0),
                            jnp.float32(0.25))
    got = tmc.extract_mesh(ct, 64, 1, 64,
                           bridge.grid_state_from_numpy(st, device="cpu"),
                           0, 0.25)
    _compare_mesh(want, got)
    assert int(got["total_triangles"]) > 64 == int(got["num_triangles"])


def test_dilate_blocks_matches_jax(scene):
    cj, ct, st = scene
    bitmap = np.zeros(KW["max_blocks"] + 1, bool)
    bitmap[[0, 3, 7]] = True
    want = jmc.dilate_blocks(cj, st, jnp.int32(0), jnp.asarray(bitmap))
    got = tmc.dilate_blocks(ct, bridge.grid_state_from_numpy(st,
                                                             device="cpu"), 0,
                            torch.from_numpy(bitmap))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.sum() > 3


def test_pack_mesh_delivery_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.uniform(-40, 40, (600, 3)).astype(np.float32)
    n = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    c = rng.uniform(-0.1, 1.1, (600, 3)).astype(np.float32)
    for with_colors in (True, False):
        want = np.asarray(jmc.pack_mesh_delivery(
            jnp.asarray(v), jnp.asarray(n), jnp.asarray(c), 512, with_colors))
        got = tmc.pack_mesh_delivery(torch.from_numpy(v), torch.from_numpy(n),
                                     torch.from_numpy(c), 512,
                                     with_colors).numpy()
        np.testing.assert_array_equal(want, got)
        for a, b in zip(jmc.unpack_mesh_delivery(want, 512, with_colors),
                        tmc.unpack_mesh_delivery(got, 512, with_colors)):
            np.testing.assert_array_equal(a, b)


def test_mesher_model_matches_jax():
    """The host-facing mesher on the JAX sphere fixture, f32 delivery."""
    kw = dict(map_scale=[6.4, 6.4], voxel_scale=0.1,
              num_voxel_per_blk_axis=8, max_blocks=256, max_submap_num=4,
              texture_enabled=True)
    jm, tm = JMap(**kw), TMap(**kw, device=DEV)
    jm.init_sphere()
    tm.state = bridge.grid_state_from_numpy(jm.state, device="cpu")
    want = JMesher(jm, max_triangles=20000, delivery="f32")
    got = TMesher(tm, max_triangles=20000, delivery="f32")
    want.generate_mesh(1)
    got.generate_mesh(1)
    n = want.num_facelets * 3
    assert got.num_facelets * 3 == n > 150
    for a, b in ((want.mesh_vertices, got.mesh_vertices),
                 (want.mesh_normals, got.mesh_normals),
                 (want.mesh_colors, got.mesh_colors)):
        np.testing.assert_allclose(a[:n], b[:n], atol=1e-3)
    assert sorted(got._spans) == sorted(want._spans)


def _triangle_rows(mesher):
    """Live triangles as sorted (T, 27) rows of vertex | normal | color,
    degenerate pad triangles dropped."""
    n = mesher.num_facelets
    v = mesher.mesh_vertices[:n * 3].reshape(n, 3, 3)
    nr = mesher.mesh_normals[:n * 3].reshape(n, 3, 3)
    c = mesher.mesh_colors[:n * 3].reshape(n, 3, 3)
    live = ~(np.all(v[:, 0] == v[:, 1], axis=-1) &
             np.all(v[:, 0] == v[:, 2], axis=-1))
    rows = np.concatenate([v[live].reshape(-1, 9), nr[live].reshape(-1, 9),
                           c[live].reshape(-1, 9)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("delivery", ["quantized", "f32"])
def test_incremental_mesh_matches_full(delivery):
    """Patching spans over a depth sequence equals a full re-mesh; the
    wall recedes, so blocks gain, rewrite and lose surface. The node's
    100 m map takes the f32 delivery, a 10 m map the quantized one."""
    m = TMap(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
             max_blocks=256, max_submap_num=4, max_bins=4096, device=DEV)
    m.set_dep_camera_intrinsic(K48)
    inc = TMesher(m, max_triangles=60000, delivery=delivery)
    eye = np.eye(3, dtype=np.float32)
    rng = np.random.default_rng(5)
    checked = 0
    for f in range(8):
        z = (1200 if f < 4 else 2200) + 40 * rng.integers(-1, 2, (48, 64))
        m.recast_depth_to_map(eye, np.array([0.03 * f, 0.0, 0.0], np.float32),
                              z.astype(np.uint16), None)
        inc.generate_mesh(1)
        if f in (0, 2, 4, 7):
            ref = TMesher(m, max_triangles=60000, incremental=False,
                          delivery=delivery)
            ref.generate_mesh(1)
            got, want = _triangle_rows(inc), _triangle_rows(ref)
            assert got.shape == want.shape, (f, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
            checked += 1
    assert checked == 4
    assert inc._live_tris == sum(sp[2] for sp in inc._spans.values())
    assert inc._alloc_end <= inc._buf_tris()
    n0 = inc.num_facelets
    inc.generate_mesh(1)            # nothing changed: no work
    assert inc.num_facelets == n0


def test_quantized_delivery_within_half_mm():
    m = TMap(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
             max_blocks=256, max_submap_num=4, texture_enabled=True,
             device=DEV)
    m.init_sphere()
    q = TMesher(m, max_triangles=20000)
    assert q.delivery == "quantized"
    q.generate_mesh(1)
    ref = TMesher(m, max_triangles=20000, delivery="f32")
    ref.generate_mesh(1)
    n = q.num_facelets * 3
    assert ref.num_facelets == q.num_facelets > 50
    assert np.abs(q.mesh_vertices[:n] - ref.mesh_vertices[:n]).max() <= 5e-4
    assert np.abs(q.mesh_normals[:n] - ref.mesh_normals[:n]).max() <= \
        1.0 / 127 + 1e-6
    assert np.abs(q.mesh_colors[:n] - ref.mesh_colors[:n]).max() <= \
        1.0 / 255 + 1e-6
    assert np.all(q.mesh_vertices[n:] == -1000000.0)
    # a map wider than the int16 millimetre range takes f32 delivery
    wide = TMap(map_scale=[100, 10], voxel_scale=0.05, max_blocks=64,
                max_submap_num=1, device=DEV)
    assert TMesher(wide).delivery == "f32"
