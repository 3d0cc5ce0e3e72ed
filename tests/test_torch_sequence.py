"""Multi-frame ingest: ``ops/sequence.py`` (``integrate_depth_sequence``,
``integrate_esdf_sequence``, ``accumulate_frame_verdict``) and the models'
``recast_depth_sequence``, the PyTorch port against the JAX package's
sequences and against the port's own per-frame loop.

On the CPU the port's sequences run their plain ``*_ref`` loop (the card
replays a captured graph of the same frame body; chip_smoke.py holds the
two equal). The semantics are the JAX sequence's: one ray-bin bucket per
window, window maxima, grow-and-redo from the entry state, keyframe splits
in SubmapMapping, and for DenseESDF the block-mode ESDF step at
``min(max_esdf_sweeps, 6)`` on every frame. The JAX functions take their
Pallas paths in interpret mode (K1's accumulation order), so bounds: block
tables, observed flags, ESDF flags, the pending wavefront and the window
stats exact; TSDF, W and ESDF within 1e-5.

Run on the CPU: ``python -m pytest tests/test_torch_sequence.py -q``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.models.dense_esdf import DenseESDF as JESDF  # noqa: E402
from taichislam_tpu.models.dense_tsdf import DenseTSDF as JTSDF  # noqa: E402
from taichislam_tpu.models.submap_mapping import \
    SubmapMapping as JSM  # noqa: E402
from taichislam_tpu.ops import sequence as jseq  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.models.dense_esdf import DenseESDF as TESDF  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TTSDF  # noqa: E402,E501
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.models.submap_mapping import \
    SubmapMapping as TSM  # noqa: E402
from taichislam_tpu_torch.ops import sequence as tseq  # noqa: E402
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402
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


# ---------------------------------------------------------------------------
# ops/sequence.py against the JAX functions
# ---------------------------------------------------------------------------

OPS_KW = {k: v for k, v in OPTS.items()
          if k not in ("max_disp_particles",)}
OPS_KW["map_scale"] = tuple(OPS_KW["map_scale"])


def _ops_inputs(n=3):
    Rs, Ts, depths = _frames(n)
    return np.stack(Rs), np.stack(Ts), depths


def _jax_window(cfg, fn, *head, depths, Rs, Ts):
    F = len(depths)
    return fn(cfg, *head, jnp.asarray(depths),
              jnp.zeros((F, 1, 1, 3), jnp.uint8), jnp.asarray(Rs),
              jnp.asarray(Ts), jnp.asarray(K_DEP), jnp.asarray(K_DEP),
              jnp.int32(0))


def _assert_stats(js, ts):
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                      err_msg=k)
    assert set(js) == set(ts)


@pytest.mark.parametrize("form", ["stacked", "tuple", "tensors"])
def test_integrate_depth_sequence_op_matches_jax(form):
    """integrate_depth_sequence on seeded frames against the JAX function:
    the state and the window stats; the frames as an (F, h, w) array, a
    tuple of arrays, or a tuple of CPU tensors."""
    Rs, Ts, depths = _ops_inputs()
    jcfg = JConfig(pallas_accum="on", **OPS_KW)
    tcfg = TConfig(**OPS_KW)
    jstate, jstats = _jax_window(jcfg, jseq.integrate_depth_sequence,
                                 jt.make_tsdf_state(jcfg), depths=depths,
                                 Rs=Rs, Ts=Ts)
    frames = {"stacked": depths, "tuple": tuple(depths),
              "tensors": tuple(torch.from_numpy(d.astype(np.int32))
                               for d in depths)}[form]
    tstate = tt.make_tsdf_state(tcfg, device=DEV)
    out, tstats = tseq.integrate_depth_sequence(
        tcfg, tstate, frames, None, Rs, Ts, K_DEP, K_DEP, 0)
    assert out is tstate
    assert_grids_match(jstate, tstate)
    _assert_stats(jstats, tstats)
    assert int(tstats["max_live_lanes"]) > 0


@pytest.mark.parametrize("budget", [1, 6])
def test_integrate_esdf_sequence_op_matches_jax(budget):
    """integrate_esdf_sequence against the JAX function at a budget that
    takes K2's twin (1) and K3's (6), with a block cap small enough to
    overflow: the state, the ESDF, fixed flags, pending wavefront,
    snapshots and the window stats."""
    Rs, Ts, depths = _ops_inputs()
    kw = dict(OPS_KW, esdf_seed_eps_voxels=0.0)
    jcfg = JConfig(pallas_accum="on", pallas_esdf="on",
                   esdf_loop_kernel="off", **kw)
    tcfg = TConfig(**kw)
    nb, V3 = tcfg.max_blocks + 1, tcfg.grid.voxels_per_block
    cap = 16
    jout = _jax_window(
        jcfg, jseq.integrate_esdf_sequence, budget, cap,
        jt.make_tsdf_state(jcfg), jnp.zeros((nb, V3), jnp.float32),
        jnp.zeros((nb, V3), jnp.int8), jnp.zeros((nb,), bool),
        jnp.zeros((nb, V3), jnp.float32), jnp.zeros((nb, V3), bool),
        depths=depths, Rs=Rs, Ts=Ts)
    tout = tseq.integrate_esdf_sequence(
        tcfg, budget, cap, tt.make_tsdf_state(tcfg, device=DEV),
        torch.zeros((nb, V3)), torch.zeros((nb, V3), dtype=torch.int8),
        torch.zeros((nb,), dtype=torch.bool), torch.zeros((nb, V3)),
        torch.zeros((nb, V3), dtype=torch.bool), depths, None, Rs, Ts,
        K_DEP, K_DEP, 0)
    assert_grids_match(jout[0], tout[0])
    names = ("esdf", "fixed", "pending", "seen_tsdf", "seen_obs")
    for name, j, t in zip(names, jout[1:6], tout[1:6]):
        if name in ("esdf", "seen_tsdf"):
            np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=name)
    _assert_stats(jout[6], tout[6])
    assert int(tout[6]["max_esdf_overflow"]) > 0
    assert bool(tout[3].any())


def test_accumulate_frame_verdict_matches_jax():
    """The deferred path's fold: running maxima and the touched union."""
    rng = np.random.default_rng(5)
    pack = rng.integers(0, 50, 4).astype(np.int32)
    union = rng.random(33) < 0.3
    keys = ("max_bins_total", "max_dropped", "max_live_lanes",
            "max_esdf_overflow")
    vals = rng.integers(0, 50, 4).astype(np.int32)
    touched = rng.random(33) < 0.3
    jstats = {k: jnp.int32(v) for k, v in zip(keys, vals)}
    jstats["touched_blocks"] = jnp.asarray(touched)
    tstats = {k: torch.tensor(int(v), dtype=torch.int32)
              for k, v in zip(keys, vals)}
    tstats["touched_blocks"] = torch.from_numpy(touched)
    jp, ju = jseq.accumulate_frame_verdict(jnp.asarray(pack),
                                           jnp.asarray(union), jstats)
    tp, tu = tseq.accumulate_frame_verdict(torch.from_numpy(pack),
                                           torch.from_numpy(union), tstats)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
