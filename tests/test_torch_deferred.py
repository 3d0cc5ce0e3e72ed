"""The deferred verdicts (``esdf_check_interval``,
``capacity_check_interval``), device-resident frames and the public helpers
added beside them: the PyTorch port against the JAX package on the CPU.

The JAX models take their Pallas paths in interpret mode with the loop
kernel off (``pallas_accum="on"``, ``pallas_esdf="on"``,
``esdf_loop_kernel="off"``), as the other port tests run them. Bounds:
block tables, observed and fixed flags, the pending wavefront, dropped
bins, every bucket and the interval accumulators exact; TSDF and W within
1e-5; ESDF within 1e-5 in block mode and within 2e-4 where the window and
dense modes run (tests/test_torch_esdf_dense.py's bound for them).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.models.dense_esdf import DenseESDF as JESDF  # noqa: E402
from taichislam_tpu.models.dense_tsdf import DenseTSDF as JTSDF  # noqa: E402
from taichislam_tpu.ops import esdf as je  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch.models.dense_esdf import DenseESDF as TESDF  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TTSDF  # noqa: E402,E501
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402
from tests.test_esdf import _drain_esdf  # noqa: E402
from tests.test_torch_sequence import assert_grids_match  # noqa: E402

DEV = torch.device("cpu")
K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
EYE = np.eye(3, dtype=np.float32)
ZERO = np.zeros(3, np.float32)
# tests/test_esdf.py's wall map (_make_wall_map)
WALL = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
            max_bins=8192, max_submap_num=8, max_esdf_sweeps=128,
            esdf_raise_slack_voxels=0.0, esdf_seed_eps_voxels=0.0)


def _pallas(m):
    m.cfg = dataclasses.replace(m.cfg, pallas_accum="on", pallas_esdf="on",
                                esdf_loop_kernel="off")
    return m


def _drain_port(m, rounds=40):
    m.last_stats = dict(m.last_stats)
    m.last_stats["touched_blocks"] = torch.zeros(
        (m.cfg.max_blocks + 1,), dtype=torch.bool)
    for _ in range(rounds):
        if not bool(m._esdf_pending.any()):
            return
        m.update_esdf()
    raise AssertionError("esdf wavefront queue never drained")


def _assert_esdf_match(jm, tm, tol, what):
    assert_grids_match(jm.state, tm.state)
    np.testing.assert_allclose(np.asarray(jm.esdf), tm.esdf.numpy(),
                               rtol=0, atol=tol, err_msg=what)
    np.testing.assert_array_equal(np.asarray(jm.esdf_fixed),
                                  tm.esdf_fixed.numpy(), err_msg=what)
    np.testing.assert_array_equal(np.asarray(jm._esdf_pending),
                                  tm._esdf_pending.numpy(), err_msg=what)
    for name in ("_bin_bucket", "_esdf_cap_bucket", "_touched_bucket",
                 "_esdf_frame", "_esdf_last_mode"):
        assert getattr(jm, name, None) == getattr(tm, name, None), \
            (what, name)
    for name in ("_frame_pack", "_frame_union", "_esdf_pack"):
        j, t = getattr(jm, name), getattr(tm, name)
        assert (j is None) == (t is None), (what, name)
        if j is not None:
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=f"{what}: {name}")


@pytest.mark.parametrize("dense_max", [0, 2 * 1024 * 1024])
def test_deferred_check_interval_matches_jax(dense_max):
    """tests/test_esdf.py:384's frames at esdf_check_interval = 4 with the
    ESDF block-cap bucket cut to 8, so the deferred verdicts grow it late
    and re-queue the interval's touched blocks: every frame's ESDF, fixed
    flags, pending wavefront, buckets and accumulators as the JAX model's,
    then the drained field (update_esdf's deferred mode). ``dense_max`` 0
    keeps every update in block mode; the default lets the drains take the
    window mode."""
    kw = dict(WALL, esdf_dense_max_voxels=dense_max)
    tol = 1e-5 if dense_max == 0 else 2e-4
    jm, tm = _pallas(JESDF(**kw)), TESDF(**kw, device=DEV)
    wall = np.full((48, 64), 1000, np.uint16)
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K)
        m.recast_depth_to_map(EYE, ZERO, wall, None)
    _drain_esdf(jm)
    _drain_port(tm)
    _assert_esdf_match(jm, tm, tol, "interval 1 start")
    for m in (jm, tm):
        m.esdf_check_interval = 4
        m._esdf_cap_bucket = 8
    far = np.full((48, 64), 1400, np.uint16)
    grew = False
    for f, depth in enumerate([wall] + [far] * 6):
        for m in (jm, tm):
            m.recast_depth_to_map(EYE, ZERO, depth, None)
        _assert_esdf_match(jm, tm, tol, f"deferred frame {f}")
        grew |= tm._esdf_cap_bucket > 8
    assert grew, "the deferred verdict never grew the ESDF cap"
    _drain_esdf(jm)
    _drain_port(tm)
    _assert_esdf_match(jm, tm, tol, "drained")
    a, b = jm.get_esdf_dict(), tm.get_esdf_dict()
    assert set(a) == set(b) and len(a) > 0
    assert max(abs(a[k] - b[k]) for k in a) <= tol


def test_check_interval_deferred_slice_export_refreshes():
    """After deferred frames the exports refresh the observed mask from
    the map, as the JAX model's lazy refresh does: the ESDF slice equals
    the JAX one."""
    kw = dict(WALL, esdf_dense_max_voxels=0, esdf_check_interval=2,
              max_esdf_sweeps=6)
    jm, tm = _pallas(JESDF(**kw)), TESDF(**kw, device=DEV)
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K)
        for base in (1000, 1200, 1300):
            m.recast_depth_to_map(EYE, ZERO,
                                  np.full((48, 64), base, np.uint16), None)
    assert tm._esdf_obs_stale
    # the camera looks along +z: slice the free space before the wall
    jx, je_ = jm.get_voxels_ESDF_slice(0.8)
    tx, te_ = tm.get_voxels_ESDF_slice(0.8)
    n = jm.num_export_ESDF_particles
    assert n == tm.num_export_ESDF_particles > 0
    np.testing.assert_allclose(jx[:n], tx[:n], atol=1e-6)
    np.testing.assert_allclose(je_[:n], te_[:n], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jm.esdf_observed),
                                  tm.esdf_observed.numpy())


# a 96x128 camera whose 2-pixel step spans 3.1 cm at 1 m, above the 2 cm
# voxel: every strided point is a ray bin of its own
K_FINE = np.array([64.0, 0, 64.0, 0, 64.0, 48.0, 0, 0, 1], np.float32)
FINE = dict(map_scale=[2.56, 2.56], voxel_scale=0.02,
            num_voxel_per_blk_axis=8, max_ray_length=1.5, min_ray_length=0.3,
            max_blocks=2048, max_bins=8192, max_submap_num=2)


def _rising(f):
    """A wall at 1 m whose visible part widens frame by frame: 1024 to
    3072 ray bins."""
    d = np.zeros((96, 128), np.uint16)
    d[:, :32 + 24 * f] = 1000
    return d


@pytest.mark.parametrize("interval", [1, 4])
def test_capacity_check_interval_matches_jax(interval):
    """capacity_check_interval on a rising bin load: the bin bucket is read
    every ``interval`` frames, so at 4 the frames between checks integrate
    with a bucket that drops bins. Per frame the dropped bins, the bucket
    and the map equal the JAX model's."""
    jm, tm = _pallas(JTSDF(**FINE)), TTSDF(**FINE, device=DEV)
    drops = []
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K_FINE)
        m.capacity_check_interval = interval
        m._bin_bucket = 2048
    for f in range(6):
        for m in (jm, tm):
            m.recast_depth_to_map(EYE, ZERO, _rising(f), None)
        jd = int(jm.last_stats["bins_dropped"])
        td = int(tm.last_stats["bins_dropped"])
        assert jd == td, (f, jd, td)
        assert jm._bin_bucket == tm._bin_bucket, f
        drops.append(td)
        assert_grids_match(jm.state, tm.state)
    if interval > 1:
        assert sum(drops[1:interval]) > 0, drops


def test_device_tensor_frames():
    """Frames handed over as tensors on the map's device give the maps the
    numpy frames give, through recast_depth_to_map (per-frame and deferred
    paths) and recast_depth_sequence (a stacked tensor and a tuple);
    ``_tensor`` returns such a frame itself, uncopied."""
    from tests.test_torch_sequence import _frames
    Rs, Ts, depths = _frames(4)
    tdepth = torch.from_numpy(depths.astype(np.int32))
    kw = dict(WALL, esdf_dense_max_voxels=0, max_esdf_sweeps=6)
    for interval in (1, 3):
        a = TESDF(**kw, esdf_check_interval=interval, device=DEV)
        b = TESDF(**kw, esdf_check_interval=interval, device=DEV)
        for m in (a, b):
            m.set_dep_camera_intrinsic(K)
        f0 = tdepth[0]
        assert a._tensor(f0, np.int32) is f0
        for f in range(4):
            a.recast_depth_to_map(Rs[f], Ts[f], depths[f], None)
            b.recast_depth_to_map(Rs[f], Ts[f], tdepth[f], None)
        for name in ("table", "num_blocks"):
            assert torch.equal(getattr(a.state, name),
                               getattr(b.state, name))
        for name in a.state.channels:
            assert torch.equal(a.state.channels[name],
                               b.state.channels[name])
        assert torch.equal(a.esdf, b.esdf)
    seqs = []
    for frames in (depths, tdepth, tuple(tdepth)):
        m = TESDF(**kw, device=DEV)
        m.set_dep_camera_intrinsic(K)
        m.recast_depth_sequence(Rs, Ts, frames)
        seqs.append(m)
    for m in seqs[1:]:
        assert torch.equal(m.state.channels["TSDF"],
                           seqs[0].state.channels["TSDF"])
        assert torch.equal(m.esdf, seqs[0].esdf)


def test_added_public_names_match_jax():
    """ops/tsdf.py::TSDF_CHANNELS, ops/esdf.py::neighbor_table and
    ops/esdf.py::neighborhood_extrema against the JAX package's."""
    assert tt.TSDF_CHANNELS == jt.TSDF_CHANNELS
    jd, jdist = je.neighbor_table()
    td, tdist = te.neighbor_table(device=DEV)
    assert td.dtype == torch.int32 and tdist.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jdist), tdist.numpy())
    halo = np.random.default_rng(3).standard_normal(
        (3, 6, 6, 6)).astype(np.float32)
    for jop, top in ((jnp.minimum, torch.minimum),
                     (jnp.maximum, torch.maximum)):
        want = je.neighborhood_extrema(jnp.asarray(halo), jop)
        got = te.neighborhood_extrema(torch.from_numpy(halo), top)
        for w, g in zip(want, got):
            assert g.shape == (3, 4, 4, 4)
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
