"""The slice as a whole: DenseESDF in the port against the JAX package.

Three frames of the synthetic orbit go through ``recast_depth_to_map`` on
both models (interval-1 verdicts), with the JAX package's Pallas paths in
interpret mode and its loop kernel off: once untextured in block mode, and
textured at the node's defaults (window / dense ESDF modes, the color
reprojection, the incremental mesher and the exports), also with dense
budgets small enough that the window gives way to the dense mode and the
dense mode to the block mode.
Bounds: per-frame ESDF mode, sweep and dirty counts, block tables,
observed and fixed flags and the pending wavefront exact; TSDF and color
to 2e-3, W to rtol 2e-3; ESDF to 2e-3 on observed voxels, since it
inherits the TSDF bound through its fixed band; triangle and export counts
exact, vertices within the 1 mm quantum of the mesh delivery.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.models.dense_esdf import DenseESDF as JModel  # noqa: E402,E501
from taichislam_tpu.models.mesher import MarchingCubeMesher as JMesher  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_esdf import DenseESDF as TModel  # noqa: E402,E501
from taichislam_tpu_torch.models.mesher import MarchingCubeMesher as TMesher  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import bin_bucket_for  # noqa: E402,E501
from taichislam_tpu_torch.utils.synthetic_scene import D435_K, orbit_sequence  # noqa: E402,E501

KW = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
          max_bins=8192, max_submap_num=8, max_esdf_sweeps=6,
          esdf_raise_slack_voxels=0.5, esdf_dense_max_voxels=0)

# every port model here runs on the CPU, asked for explicitly (the models
# default to the CUDA card)
DEV = torch.device("cpu")


def _small_K():
    K = (D435_K * np.float32(0.1)).astype(np.float32)
    K[8] = 1.0
    return K


def _models(**kw):
    jm = JModel(**kw)
    jm.cfg = dataclasses.replace(jm.cfg, pallas_accum="on", pallas_esdf="on",
                                 esdf_loop_kernel="off")
    return jm, TModel(**kw, device=DEV)


def _assert_maps_match(jm, tm):
    js, ts = jm.state, tm.state
    for name in ("table", "block_coords", "num_blocks", "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy())
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(js.channels[name]),
                                      ts.channels[name].numpy())
    np.testing.assert_allclose(np.asarray(js.channels["TSDF"]),
                               ts.channels["TSDF"].numpy(), atol=2e-3)
    np.testing.assert_allclose(np.asarray(js.channels["W_TSDF"]),
                               ts.channels["W_TSDF"].numpy(), rtol=2e-3,
                               atol=1e-3)
    obs = np.asarray(jm.esdf_observed)
    np.testing.assert_array_equal(obs, tm.esdf_observed.numpy())
    assert obs.sum() > 1000
    np.testing.assert_array_equal(np.where(obs, np.asarray(jm.esdf_fixed), 0),
                                  np.where(obs, tm.esdf_fixed.numpy(), 0))
    err = np.abs(np.where(obs, np.asarray(jm.esdf) - tm.esdf.numpy(), 0))
    assert err.max() <= 2e-3, err.max()
    np.testing.assert_array_equal(np.asarray(jm._esdf_pending),
                                  tm._esdf_pending.numpy())
    assert tm.count_active() == jm.count_active()


def test_dense_esdf_slice_matches_jax():
    depth, Rs, Ts, K = orbit_sequence(n_frames=12, h=48, w=64, K=_small_K())
    jm, tm = _models(**KW)
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K)
    for f in range(3):
        jm.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
        tm.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
        assert jm.last_esdf_sweeps == tm.last_esdf_sweeps, f
        assert jm.last_esdf_dirty == tm.last_esdf_dirty, f
        assert jm._bin_bucket == tm._bin_bucket
    assert tm.last_esdf_sweeps > 0
    _assert_maps_match(jm, tm)
    assert tm.mem_per_voxel == 4 + 4 + 1 + 1   # float32 storage


def _texture(rng, h, w):
    """Deterministic, spatially coherent, non-constant RGB."""
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([128 + 100 * np.sin(ii / 9.0), 128 + 100 * np.cos(
        jj / 7.0), (ii * 3 + jj * 2) % 256], -1)
    return np.clip(base + rng.integers(0, 12, (h, w, 3)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("budget,modes", [
    (2 * 1024 * 1024, ["window"] * 3),
    (256 * 512, ["window", "dense", "dense"]),
    (96 * 512, ["dense", "block", "block"])],
    ids=["node_default", "window_to_dense", "dense_to_block"])
def test_textured_node_defaults_match_jax(budget, modes):
    """The node's single-map path: textured, ``color_same_proj=False`` with
    a distinct color camera, the default ESDF modes, the incremental mesher
    and the surface / ESDF-slice exports after every frame."""
    kw = dict(KW, texture_enabled=True, color_same_proj=False,
              esdf_dense_max_voxels=budget)
    depth, Rs, Ts, K = orbit_sequence(n_frames=12, h=48, w=64, K=_small_K())
    Kc = K.copy()
    Kc[[0, 2, 4, 5]] *= np.float32([1.1, 1.02, 1.08, 0.97])
    rng = np.random.default_rng(9)
    jm, tm = _models(**kw)
    # quantized delivery: the JAX mesher's incremental patch cannot write
    # into its f32 delivery's read-only arrays (ROADMAP.md Queue C)
    meshers = (JMesher(jm, 60000, tsdf_surface_thres=0.5),
               TMesher(tm, 60000, tsdf_surface_thres=0.5))
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K)
        m.set_color_camera_intrinsic(Kc)
    seen = []
    for f in range(3):
        tex = _texture(rng, 48, 64)
        for m, mesher in zip((jm, tm), meshers):
            m.recast_depth_to_map(Rs[f], Ts[f], depth[f], tex)
            mesher.generate_mesh(1)
            m.cvt_TSDF_surface_to_voxels()
            m.cvt_ESDF_to_voxels_slice(0.0)
        assert jm._esdf_last_mode == tm._esdf_last_mode, f
        assert jm.last_esdf_sweeps == tm.last_esdf_sweeps, f
        assert jm.last_esdf_dirty == tm.last_esdf_dirty, f
        assert jm.num_TSDF_particles == tm.num_TSDF_particles > 0
        assert jm.num_export_ESDF_particles == \
            tm.num_export_ESDF_particles > 0
        jv, tv = (mm.mesh_vertices[:mm.num_facelets * 3] for mm in meshers)
        assert meshers[0].num_facelets == meshers[1].num_facelets > 0
        np.testing.assert_allclose(jv, tv, atol=1e-3)   # one mm quantum
        seen.append(tm._esdf_last_mode)
    # a window over budget gives way to the dense mode, and that to the
    # block mode once the observed box outgrows the budget too
    assert seen == modes
    _assert_maps_match(jm, tm)
    np.testing.assert_allclose(np.asarray(jm.state.channels["color"]),
                               tm.state.channels["color"].numpy(), atol=2e-3)
    n = tm.num_TSDF_particles
    np.testing.assert_allclose(jm.export_TSDF_xyz[:n], tm.export_TSDF_xyz[:n],
                               atol=1e-6)
    np.testing.assert_allclose(jm.export_color[:n], tm.export_color[:n],
                               atol=2e-3)


@pytest.mark.parametrize("n", [1, 2048, 2049, 3000, 10 ** 6])
def test_bin_bucket_rule_matches_jax(n):
    from taichislam_tpu.models.dense_tsdf import bin_bucket_for as jax_rule
    assert bin_bucket_for(n) == jax_rule(n)


def test_unported_modes_raise():
    """No mode of the models raises any more: recast_depth_sequence runs
    (tests/test_torch_sequence.py holds it to the JAX sequences), and
    esdf_check_interval > 1 runs the JAX package's deferred verdicts
    (tests/test_torch_deferred.py and test_torch_esdf.py hold it to the
    JAX model). A window of one empty frame leaves the map empty."""
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    kw = {k: v for k, v in KW.items() if not k.startswith(("esdf", "max_e"))}
    for m in (TModel(**KW, device=DEV), DenseTSDF(**kw, device=DEV)):
        m.set_dep_camera_intrinsic(_small_K())
        m.recast_depth_sequence([np.eye(3)], [np.zeros(3)],
                                [np.zeros((48, 64), np.uint16)])
        assert m.count_active() == 0
        assert int(m.last_stats["max_dropped"]) == 0
