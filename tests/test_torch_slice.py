"""The slice as a whole: DenseESDF in the port against the JAX package.

Three frames of the synthetic orbit go through ``recast_depth_to_map`` on
both models in block mode (interval-1 verdicts, no dense window), with the
JAX package's Pallas paths in interpret mode and its loop kernel off.
Bounds: per-frame sweep and dirty counts, block tables, observed and fixed
flags and the pending wavefront exact; TSDF to 2e-3, W to rtol 2e-3; ESDF to
2e-3 on observed voxels, since it inherits the TSDF bound through its
fixed band.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.models.dense_esdf import DenseESDF as JModel  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_esdf import DenseESDF as TModel  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import bin_bucket_for  # noqa: E402,E501
from taichislam_tpu_torch.utils.synthetic_scene import D435_K, orbit_sequence  # noqa: E402,E501

KW = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
          max_bins=8192, max_submap_num=8, max_esdf_sweeps=6,
          esdf_raise_slack_voxels=0.5, esdf_dense_max_voxels=0)


def test_dense_esdf_slice_matches_jax():
    K = (D435_K * np.float32(0.1)).astype(np.float32)
    K[8] = 1.0
    depth, Rs, Ts, K = orbit_sequence(n_frames=12, h=48, w=64, K=K)
    jm = JModel(**KW)
    jm.cfg = dataclasses.replace(jm.cfg, pallas_accum="on", pallas_esdf="on",
                                 esdf_loop_kernel="off")
    tm = TModel(**KW)
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K)
    for f in range(3):
        jm.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
        tm.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
        assert jm.last_esdf_sweeps == tm.last_esdf_sweeps, f
        assert jm.last_esdf_dirty == tm.last_esdf_dirty, f
        assert jm._bin_bucket == tm._bin_bucket
    assert tm.last_esdf_sweeps > 0

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
    assert tm.mem_per_voxel == 4 + 4 + 1 + 1   # float32 storage


@pytest.mark.parametrize("n", [1, 2048, 2049, 3000, 10 ** 6])
def test_bin_bucket_rule_matches_jax(n):
    from taichislam_tpu.models.dense_tsdf import bin_bucket_for as jax_rule
    assert bin_bucket_for(n) == jax_rule(n)


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError):
        TModel(**dict(KW, esdf_dense_max_voxels=1 << 20))
    with pytest.raises(NotImplementedError):
        TModel(**dict(KW, esdf_check_interval=4))
