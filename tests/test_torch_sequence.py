"""Multi-frame ingest (``recast_depth_sequence``): the PyTorch port against
the JAX package's sequences and against the port's own per-frame loop.

The port runs a window as a loop of per-frame calls with the JAX sequence's
semantics: one ray-bin bucket per window, window maxima, grow-and-redo from
the entry state, keyframe splits in SubmapMapping, and for DenseESDF the
block-mode ESDF step at ``min(max_esdf_sweeps, 6)`` on every frame. The JAX
models take their Pallas paths in interpret mode (K1's accumulation order),
so bounds: block tables, observed flags and ESDF flags exact; TSDF, W and
ESDF within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.models.dense_esdf import DenseESDF as JESDF  # noqa: E402
from taichislam_tpu.models.dense_tsdf import DenseTSDF as JTSDF  # noqa: E402
from taichislam_tpu.models.submap_mapping import \
    SubmapMapping as JSM  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.models.dense_esdf import DenseESDF as TESDF  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TTSDF  # noqa: E402,E501
from taichislam_tpu_torch.models.submap_mapping import \
    SubmapMapping as TSM  # noqa: E402
from tests.test_tsdf import K_DEP, synthetic_depth  # noqa: E402

OPTS = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
            max_bins=8192, max_disp_particles=65536, max_submap_num=8)
ESDF_OPTS = dict(OPTS, esdf_dense_max_voxels=0)   # block-incremental mode
DEV = torch.device("cpu")


def _frames(n=4):
    """tests/test_sequence.py's window."""
    Rs, Ts, depths = [], [], []
    for f in range(n):
        ang = 0.05 * f
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1]], np.float32)
        T = np.array([0.05 * f, -0.017, 0.111], np.float32)
        depths.append(synthetic_depth(base=1000.0 + 30.0 * f))
        Rs.append(R)
        Ts.append(T)
    return Rs, Ts, np.stack(depths)


def _pallas(m):
    """The JAX model on its Pallas paths (interpret mode on the CPU)."""
    m.cfg = dataclasses.replace(m.cfg, pallas_accum="on", pallas_esdf="on",
                                esdf_loop_kernel="off")
    return m


def _jax(cls, **kw):
    m = _pallas(cls(**kw))
    m.set_dep_camera_intrinsic(K_DEP)
    return m


def _port(cls, **kw):
    m = cls(**kw, device=DEV)
    m.set_dep_camera_intrinsic(K_DEP)
    return m


def assert_grids_match(js, ts, tol=1e-5):
    """A JAX GridState against a port GridState."""
    ts = bridge.grid_state_to_numpy(ts)
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name), err_msg=name)
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(js.channels[name]),
                                      ts.channels[name], err_msg=name)
    for name in ("TSDF", "W_TSDF"):
        np.testing.assert_allclose(np.asarray(js.channels[name]),
                                   ts.channels[name], atol=tol, err_msg=name)


def assert_port_maps_equal(a, b):
    """Two port maps: the same state, exactly."""
    for name in ("table", "block_coords", "num_blocks", "block_active"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))
    for name in a.state.channels:
        assert torch.equal(a.state.channels[name], b.state.channels[name])


def test_tsdf_sequence_matches_per_frame():
    Rs, Ts, depths = _frames()
    t_seq = _port(TTSDF, **OPTS)
    t_seq.recast_depth_sequence(Rs, Ts, depths)
    t_ref = _port(TTSDF, **OPTS)
    for R, T, d in zip(Rs, Ts, depths):
        t_ref.recast_depth_to_map(R, T, d, None)
    assert_port_maps_equal(t_seq, t_ref)
    j_seq = _jax(JTSDF, **OPTS)
    j_seq.recast_depth_sequence(Rs, Ts, depths)
    assert t_seq.count_active() == j_seq.count_active() > 0
    assert_grids_match(j_seq.state, t_seq.state)
    for k in ("max_bins_total", "max_dropped", "max_live_lanes"):
        assert int(t_seq.last_stats[k]) == int(j_seq.last_stats[k]), k
    np.testing.assert_array_equal(
        np.asarray(j_seq.last_stats["touched_blocks"]),
        t_seq.last_stats["touched_blocks"].numpy())


def test_tsdf_sequence_grows_bin_bucket():
    """An undersized starting bin bucket ends as the JAX window ends: the
    same verdict, bucket and map, with nothing dropped."""
    Rs, Ts, depths = _frames(2)
    maps = (_port(TTSDF, **OPTS), _jax(JTSDF, **OPTS))
    for m in maps:
        m._bin_bucket = 2048
        m.recast_depth_sequence(Rs, Ts, depths)
    t_seq, j_seq = maps
    assert int(t_seq.last_stats["max_dropped"]) == 0
    assert t_seq._bin_bucket == j_seq._bin_bucket
    t_ref = _port(TTSDF, **OPTS)
    for R, T, d in zip(Rs, Ts, depths):
        t_ref.recast_depth_to_map(R, T, d, None)
    assert t_seq.count_active() == t_ref.count_active() == \
        j_seq.count_active()
    assert_grids_match(j_seq.state, t_seq.state)


def _esdf_check(jm, tm):
    assert_grids_match(jm.state, tm.state)
    obs = np.asarray(jm.esdf_observed)
    np.testing.assert_array_equal(obs, tm.esdf_observed.numpy())
    np.testing.assert_array_equal(np.asarray(jm.esdf_fixed),
                                  tm.esdf_fixed.numpy())
    np.testing.assert_array_equal(np.asarray(jm._esdf_pending),
                                  tm._esdf_pending.numpy())
    np.testing.assert_allclose(np.asarray(jm.esdf)[obs],
                               tm.esdf.numpy()[obs], atol=1e-5)


@pytest.mark.parametrize("sweeps", [6, 32])
def test_esdf_sequence_matches_jax(sweeps):
    """The ESDF window against the JAX window. At 6 sweeps it is also the
    port's per-frame loop; at 32 it is not (the window's budget is
    min(max_esdf_sweeps, 6), the per-frame path's max_esdf_sweeps)."""
    Rs, Ts, depths = _frames(3)
    t_seq = _port(TESDF, **ESDF_OPTS, max_esdf_sweeps=sweeps)
    t_seq.recast_depth_sequence(Rs, Ts, depths)
    j_seq = _jax(JESDF, **ESDF_OPTS, max_esdf_sweeps=sweeps)
    j_seq.recast_depth_sequence(Rs, Ts, depths)
    _esdf_check(j_seq, t_seq)
    t_ref = _port(TESDF, **ESDF_OPTS, max_esdf_sweeps=sweeps)
    for R, T, d in zip(Rs, Ts, depths):
        t_ref.recast_depth_to_map(R, T, d, None)
    assert torch.equal(t_ref.esdf_observed, t_seq.esdf_observed)
    same = torch.equal(t_ref.esdf[t_ref.esdf_observed],
                       t_seq.esdf[t_seq.esdf_observed])
    assert same == (sweeps <= 6), sweeps


def test_esdf_sequence_without_gating_is_tsdf_then_update():
    """Outside the gated mode the window is TSDF only and then one
    update_esdf(): the same as the JAX model's fallback."""
    Rs, Ts, depths = _frames(2)
    kw = dict(ESDF_OPTS, esdf_incremental=False, max_esdf_sweeps=6)
    t_seq = _port(TESDF, **kw)
    t_seq.recast_depth_sequence(Rs, Ts, depths)
    j_seq = _jax(JESDF, **kw)
    j_seq.recast_depth_sequence(Rs, Ts, depths)
    assert_grids_match(j_seq.state, t_seq.state)
    obs = np.asarray(j_seq.esdf_observed)
    np.testing.assert_array_equal(obs, t_seq.esdf_observed.numpy())
    np.testing.assert_allclose(np.asarray(j_seq.esdf)[obs],
                               t_seq.esdf.numpy()[obs], atol=1e-5)


def _submaps(cls, **kw):
    sub_opts = dict(OPTS)
    sm = cls(submap_type=JTSDF if cls is JSM else TTSDF, keyframe_step=2,
             sub_opts=sub_opts, global_opts=dict(sub_opts,
                                                 is_global_map=True), **kw)
    if cls is JSM:
        for m in (sm.submap_collection, sm.global_map):
            _pallas(m)
    sm.set_dep_camera_intrinsic(K_DEP)
    return sm


def test_submap_sequence_matches_per_frame():
    Rs, Ts, depths = _frames(4)
    ext = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    frames = [(f, True, (Rs[f], Ts[f]), ext, depths[f], None)
              for f in range(len(Rs))]
    t_seq = _submaps(TSM, device=DEV)
    t_seq.recast_depth_sequence(frames)
    t_ref = _submaps(TSM, device=DEV)
    for fr in frames:
        t_ref.recast_depth_to_map_by_frame(*fr)
    j_seq = _submaps(JSM)
    j_seq.recast_depth_sequence(frames)
    assert t_seq.frame_count == t_ref.frame_count == j_seq.frame_count
    assert t_seq.submaps == t_ref.submaps == j_seq.submaps
    col = t_seq.submap_collection
    assert col.get_active_submap_id() == \
        j_seq.submap_collection.get_active_submap_id()
    assert_port_maps_equal(col, t_ref.submap_collection)
    assert_port_maps_equal(t_seq.global_map, t_ref.global_map)
    assert_grids_match(j_seq.submap_collection.state, col.state)


def test_async_window_verdict_matches_sync():
    """sequence_verdict_async: the port settles each window's verdict at
    once, so two windows with an undersized starting bucket end in the
    state of one synchronous window (and of the JAX async chain), with no
    pending chain."""
    Rs, Ts, depths = _frames(4)
    t_async = _port(TTSDF, **OPTS)
    t_async.sequence_verdict_async = True
    t_async._bin_bucket = 128
    t_async.recast_depth_sequence(Rs[:2], Ts[:2], [depths[0], depths[1]])
    t_async.recast_depth_sequence(Rs[2:], Ts[2:], [depths[2], depths[3]])
    assert not getattr(t_async, "_seq_chain", None)
    t_ref = _port(TTSDF, **OPTS)
    t_ref.recast_depth_sequence(Rs, Ts, depths)
    assert_port_maps_equal(t_async, t_ref)
    j_async = _jax(JTSDF, **OPTS)
    j_async.sequence_verdict_async = True
    j_async._bin_bucket = 128
    j_async.recast_depth_sequence(Rs[:2], Ts[:2], [depths[0], depths[1]])
    j_async.recast_depth_sequence(Rs[2:], Ts[2:], [depths[2], depths[3]])
    assert j_async.count_active() == t_async.count_active()
    assert_grids_match(j_async.state, t_async.state)
