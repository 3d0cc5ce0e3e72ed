"""Exports and serialization: the PyTorch port against the JAX package.

Both packages read the same JAX-fused textured map (two submaps, posed
submap frames), carried to the port through the numpy bridge. Bounds:
counts exact, export arrays within 1e-6 (they are gathers of the same
values, in the same order), gathered and packed wire arrays equal, and
``saveMap`` in one package followed by ``loadMap`` in the other yields the
same map, both ways.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.models.dense_tsdf import DenseTSDF as JMap  # noqa: E402
from taichislam_tpu.ops import exports as jx  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TMap  # noqa: E402,E501
from taichislam_tpu_torch.ops import exports as tx  # noqa: E402

KW = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=1.5, min_ray_length=0.3, max_blocks=64,
          max_bins=1024, max_submap_num=4, max_touched_blocks=64,
          disp_ceiling=0.9, disp_floor=-0.4)
K = np.asarray([20.0, 0, 16.0, 0, 20.0, 12.0, 0, 0, 1], np.float32)
NB = 4
# every port model here runs on the CPU, asked for explicitly (the models
# default to the CUDA card)
DEV = torch.device("cpu")


def _fuse(cfg):
    """Two textured frames into submap 1 and one into submap 0."""
    rng = np.random.default_rng(11)
    st = jt.make_tsdf_state(cfg)
    for f, sub in ((0, 1), (1, 1), (2, 0)):
        depth = rng.integers(500, 1400, (24, 32)).astype(np.uint16)
        tex = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        th = 0.3 * f
        R = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                      [0, np.sin(th), np.cos(th)]], np.float32)
        st, _ = jt.integrate_depth(
            cfg, st, jnp.asarray(depth), jnp.asarray(tex), jnp.asarray(R),
            jnp.asarray([0.05 * f, 0.0, -0.02], np.float32), jnp.asarray(K),
            jnp.asarray(K), jnp.int32(sub))
    return st


@pytest.fixture(scope="module", params=[True, False],
                ids=["textured", "plain"])
def scene(request):
    kw = dict(KW, texture_enabled=request.param)
    cj, ct = JConfig(pallas_accum="on", **kw), TConfig(**kw)
    js = _fuse(cj)
    rng = np.random.default_rng(3)
    base_R = np.tile(np.eye(3, dtype=np.float32), (NB, 1, 1))
    base_T = np.zeros((NB, 3), np.float32)
    base_R[1] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    base_T[1] = [0.4, -0.3, 0.25]
    return cj, ct, js, base_R, base_T


def _port_state(js):
    return bridge.grid_state_from_numpy(js, device="cpu")


def _close(want, got):
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("capacity", [4096, 150])
def test_surface_export_matches_jax(scene, capacity):
    cj, ct, js, bR, bT = scene
    for sub in (0, 1):
        want = jx.tsdf_surface_export(cj, capacity, 64, js, jnp.asarray(bR),
                                      jnp.asarray(bT), jnp.int32(sub))
        got = tx.tsdf_surface_export(ct, capacity, 64, _port_state(js),
                                     torch.from_numpy(bR),
                                     torch.from_numpy(bT), sub)
        assert int(want[5]) == int(got[5]) > 0
        _close(want[:5], got[:5])


def test_slice_export_matches_jax(scene):
    cj, ct, js, bR, bT = scene
    for z in (0.35, 0.6):
        want = jx.tsdf_slice_export(cj, 4096, 64, js, jnp.asarray(bR),
                                    jnp.asarray(bT), jnp.int32(1),
                                    jnp.float32(z), jnp.float32(0.5))
        got = tx.tsdf_slice_export(ct, 4096, 64, _port_state(js),
                                   torch.from_numpy(bR),
                                   torch.from_numpy(bT), 1, z, 0.5)
        assert int(want[5]) == int(got[5]) > 0
        _close(want[:5], got[:5])


def test_count_active_and_voxel_positions_match_jax(scene):
    cj, ct, js, bR, bT = scene
    ps = _port_state(js)
    for sub in (0, 1, 2):
        assert int(jx.count_active(cj, js, jnp.int32(sub))) == \
            int(tx.count_active(ct, ps, sub))
    np.testing.assert_array_equal(np.asarray(jx.voxel_ijk_all(cj.grid, js)),
                                  tx.voxel_ijk_all(ct.grid, ps).numpy())
    np.testing.assert_allclose(
        np.asarray(jx.voxel_xyz_all(cj.grid, js, jnp.asarray(bR),
                                    jnp.asarray(bT), False)),
        tx.voxel_xyz_all(ct.grid, ps, torch.from_numpy(bR),
                         torch.from_numpy(bT), False).numpy(), atol=1e-6)


@pytest.mark.parametrize("capacity", [4096, 200])
def test_sparse_gather_and_packed_match_jax(scene, capacity):
    cj, ct, js, _, _ = scene
    ps = _port_state(js)
    want = jx.sparse_gather(cj, capacity, 64, js, jnp.int32(1))
    got = tx.sparse_gather(ct, capacity, 64, ps, 1)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    wbuf = np.asarray(jx.sparse_gather_packed(cj, capacity, 64, js,
                                              jnp.int32(1)))
    gbuf = tx.sparse_gather_packed(ct, capacity, 64, ps, 1).numpy()
    assert wbuf.dtype == gbuf.dtype == np.uint8
    np.testing.assert_array_equal(wbuf, gbuf)
    for a, b in zip(jx.unpack_sparse_delivery(wbuf, capacity,
                                              cj.texture_enabled),
                    tx.unpack_sparse_delivery(gbuf, capacity,
                                              ct.texture_enabled)):
        np.testing.assert_array_equal(a, b)


def test_sparse_scatter_matches_jax(scene):
    cj, ct, js, _, _ = scene
    idx, tsdf, w, occ, col, kept, _ = (np.asarray(a) for a in
                                       jx.sparse_gather(cj, 4096, 64, js,
                                                        jnp.int32(1)))
    if not cj.texture_enabled:
        col = np.zeros((4096, 3), np.float32)
    args = (idx, tsdf, w, occ.astype(np.float32), col)
    want = jx.sparse_scatter(cj, jt.make_tsdf_state(cj), jnp.int32(2),
                             *map(jnp.asarray, args), jnp.int32(kept))
    got = tx.sparse_scatter(ct, bridge.grid_state_from_numpy(
        jt.make_tsdf_state(cj), device="cpu"), 2,
        *(torch.from_numpy(np.array(a)) for a in args), int(kept))
    got = bridge.grid_state_to_numpy(got)
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name), err_msg=name)
    for k, v in want.channels.items():
        np.testing.assert_array_equal(np.asarray(v), got.channels[k],
                                      err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_and_load_across_packages(scene, direction, tmp_path):
    cj, ct, js, _, _ = scene
    kw = dict(map_scale=[3.2, 3.2], voxel_scale=0.1,
              num_voxel_per_blk_axis=8, max_blocks=64, max_submap_num=4,
              texture_enabled=cj.texture_enabled)
    jm, tm = JMap(**kw), TMap(**kw, device=DEV)
    jm.state = js
    tm.state = _port_state(js)
    jm.active_submap_id = tm.active_submap_id = 1
    jm.saveMap(str(tmp_path / "jax.npy"))
    tm.saveMap(str(tmp_path / "port.npy"))
    # the same dict, byte for byte
    assert (tmp_path / "jax.npy").read_bytes() == \
        (tmp_path / "port.npy").read_bytes()
    if direction == "jax_to_port":
        got = TMap.loadMap(str(tmp_path / "jax.npy"), device=DEV)
        want = JMap.loadMap(str(tmp_path / "jax.npy"))
    else:
        got = TMap.loadMap(str(tmp_path / "port.npy"), device=DEV)
        want = JMap.loadMap(str(tmp_path / "port.npy"))
    assert got.count_active() == want.count_active() == \
        int(jx.count_active(cj, js, jnp.int32(1)))
    gs = bridge.grid_state_to_numpy(got.state)
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(want.state, name)),
                                      getattr(gs, name), err_msg=name)
    for k, v in want.state.channels.items():
        np.testing.assert_array_equal(np.asarray(v), gs.channels[k],
                                      err_msg=k)
    for a, b in zip(want.to_numpy(), got.to_numpy()):
        np.testing.assert_array_equal(a, b)


def test_model_exports_match_jax():
    """The models' host-side export API on the same point-cloud-fused map:
    the full capacity-padded host arrays, the appending ``_to`` variant,
    ``to_numpy`` and ``reset``."""
    kw = dict(map_scale=[3.2, 3.2], voxel_scale=0.1,
              num_voxel_per_blk_axis=8, max_blocks=64, max_submap_num=4,
              max_ray_length=1.5, texture_enabled=True,
              max_disp_particles=3000, disp_ceiling=0.6)
    jm, tm = JMap(**kw), TMap(**kw, device=DEV)
    jm.cfg = dataclasses.replace(jm.cfg, pallas_accum="on")
    rng = np.random.default_rng(12)
    xyz = rng.uniform(-1.0, 1.0, (1500, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (1500, 3)).astype(np.float32)
    pose = (np.eye(3, dtype=np.float32), np.array([0.1, 0, 0], np.float32))
    ext = (np.eye(3), np.zeros(3))
    for m in (jm, tm):
        m.recast_pcl_to_map_by_frame(0, True, pose, ext, xyz, rgb)
    for m in (jm, tm):
        m.cvt_TSDF_surface_to_voxels()
    assert jm.num_TSDF_particles == tm.num_TSDF_particles > 100
    for name in ("export_TSDF_xyz", "export_color", "export_TSDF"):
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-3, err_msg=name)
    for m in (jm, tm):
        m.cvt_TSDF_to_voxels_slice(0.2)
    assert jm.num_TSDF_particles == tm.num_TSDF_particles > 10
    np.testing.assert_allclose(jm.export_TSDF_xyz, tm.export_TSDF_xyz,
                               atol=1e-6)
    bufs = []
    for m in (jm, tm):
        xyz_buf = np.zeros((3000, 3), np.float32)
        col_buf = np.zeros((3000, 3), np.float32)
        n = m.cvt_TSDF_surface_to_voxels_to(2900, 3000, xyz_buf, col_buf)
        bufs.append((n, xyz_buf, col_buf))
    assert bufs[0][0] == bufs[1][0] == 3000
    np.testing.assert_allclose(bufs[0][1], bufs[1][1], atol=1e-6)
    for a, b in zip(jm.to_numpy(), tm.to_numpy()):
        np.testing.assert_allclose(a, b, atol=2e-3)
    tm.reset()
    assert tm.count_active() == 0 and int(tm.state.num_blocks) == 0
    assert tm.consume_mesh_dirty() == (True, None)


@pytest.mark.parametrize("caps", [(4096, 64), (300, 64), (4096, 3)],
                         ids=["full", "lanes_cut", "blocks_cut"])
def test_bitmap_gather_packed_matches_jax(scene, caps):
    """The compact submap wire (async finalize): byte-identical buffers,
    truncated gathers included, and each package's decoder reads the other
    package's buffer to the same arrays."""
    cj, ct, js, _, _ = scene
    lane_cap, block_cap = caps
    for sub in (0, 1):
        wbuf = np.asarray(jx.bitmap_gather_packed(cj, lane_cap, block_cap, js,
                                                  jnp.int32(sub)))
        gbuf = tx.bitmap_gather_packed(ct, lane_cap, block_cap,
                                       _port_state(js), sub).numpy()
        assert wbuf.dtype == gbuf.dtype == np.uint8
        np.testing.assert_array_equal(wbuf, gbuf)
        V, tex = ct.grid.V, ct.texture_enabled
        j_of_g = jx.unpack_bitmap_packed(gbuf, lane_cap, block_cap, V, tex)
        g_of_j = tx.unpack_bitmap_packed(wbuf, lane_cap, block_cap, V, tex)
        for a, b in zip(j_of_g, g_of_j):
            np.testing.assert_array_equal(a, b)
        kept_v, total_v = g_of_j[7], g_of_j[8]
        assert kept_v == min(total_v, lane_cap) and total_v > 0
        if caps == (4096, 64):
            # the untruncated gather holds the sparse gather's voxels
            idx = np.asarray(jx.sparse_gather(cj, 4096, 64, js,
                                              jnp.int32(sub))[0])[:kept_v]
            order = np.lexsort(idx.T)
            got = g_of_j[0].astype(np.int32)
            np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                          idx[order])
