"""Dense-window and dirty-window ESDF, and the ESDF slice export: the
PyTorch port against the JAX package.

Both run from the same JAX-fused TSDF state (a slanted wall), carried to
the port through the numpy bridge. The JAX functions are plain XLA on the
CPU. Bounds: ESDF within 2e-4 on participating voxels, fixed flags,
changed bitmaps, overflow and sweep counts exact; the slice export's count
exact and its arrays within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import esdf as je  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402

KW = dict(map_scale=(6.4, 6.4), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
          max_bins=8192, max_submap_num=8, esdf_raise_slack_voxels=0.5)
JCFG = JConfig(pallas_accum="on", **KW)
TCFG = TConfig(**KW)
K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
SHAPE = (KW["max_blocks"] + 1, 8 ** 3)
DIMS = (8, 8, 4)


@pytest.fixture(scope="module")
def scene():
    jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    depth = (1000 + 4.0 * ii + 2.0 * jj).astype(np.uint16)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    st, stats = jt.integrate_depth(
        JCFG, jt.make_tsdf_state(JCFG), jnp.asarray(depth),
        jnp.zeros((1, 1, 3), jnp.uint8), jnp.asarray(R),
        jnp.asarray([0.1, -0.2, 0.05], np.float32), jnp.asarray(K),
        jnp.asarray(K), jnp.int32(0))
    return st, np.asarray(stats["touched_blocks"])


def _compare(jstate, e0, f0, dims=DIMS, budget=64, **kw):
    """Run both from the same inputs; assert the exact parts and the 2e-4
    field bound; return the numpy outputs of the port."""
    want = je.esdf_update_dense(
        JCFG, budget, dims, jstate, jnp.asarray(e0), jnp.asarray(f0),
        jnp.int32(0), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = te.esdf_update_dense(
        TCFG, budget, dims, bridge.grid_state_from_numpy(jstate, device="cpu"),
        torch.from_numpy(np.array(e0)), torch.from_numpy(np.array(f0)), 0,
        **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
    we, wf, wp, ws, wc, wo = (np.asarray(a) for a in want)
    ge, gf, gp, gs, gc, go = (a.numpy() for a in got)
    assert int(ws) == int(gs), (int(ws), int(gs))
    assert int(wo) == int(go)
    np.testing.assert_array_equal(wp, gp)
    np.testing.assert_array_equal(np.where(wp, wf, 0), np.where(gp, gf, 0))
    np.testing.assert_array_equal(wc, gc)
    err = np.abs(np.where(wp, we - ge, 0.0)).max()
    assert err <= 2e-4, f"field max abs err {err}"
    return ge, gf, gp, int(gs), gc, int(go)


@pytest.mark.parametrize("mode", ["dense", "window"])
def test_dense_modes_match_jax(scene, mode):
    """From a cold field, then the subset-dirty re-run on the converged
    field (tests/test_esdf.py:568-577)."""
    state, touched = scene
    zeros = (np.zeros(SHAPE, np.float32), np.zeros(SHAPE, np.int8))
    kw, dims = {}, DIMS
    if mode == "window":
        # the active blocks' bounding box plus the one-block ring
        dirty = np.asarray(state.block_active).copy()
        dirty[-1] = False
        c = np.asarray(state.block_coords)[dirty, 1:4]
        dims = tuple(int(d) + 2 for d in c.max(0) - c.min(0) + 1)
        kw = dict(dirty_blocks=dirty)
    e, f, part, sweeps, _, ov = _compare(state, *zeros, dims=dims, **kw)
    assert ov == 0 and 1 < sweeps < 64 and part.sum() > 1000
    if mode == "window":
        kw = dict(dirty_blocks=dirty & (np.arange(SHAPE[0]) % 2 == 0))
    e2, *_, changed2, ov2 = _compare(state, e, f, dims=dims, **kw)
    assert ov2 == 0
    assert np.abs(np.where(part, e2 - e, 0)).max() < 2e-4
    assert not changed2.any()


def test_window_with_snapshot_seeds_matches_jax(scene):
    """The model's window call: the frame's touched blocks as the dirty set,
    seeded from consume-once snapshots that differ from the live TSDF."""
    state, touched = scene
    rng = np.random.default_rng(1)
    tsdf = np.asarray(state.channels["TSDF"], np.float32)
    seen_t = (tsdf + rng.uniform(-0.02, 0.02, tsdf.shape)).astype(np.float32)
    seen_o = np.asarray(state.channels["TSDF_observed"]) > 0
    _, _, _, sweeps, changed, _ = _compare(
        state, np.zeros(SHAPE, np.float32), np.zeros(SHAPE, np.int8),
        budget=3, dirty_blocks=touched, tsdf_src=seen_t, obs_src=seen_o)
    assert sweeps == 3 and changed.any()


def test_window_overflow_matches_jax(scene):
    """A window too small for the dirty set: the overflow count (the
    model's cue to grow the window) and the partial update agree."""
    state, touched = scene
    *_, ov = _compare(state, np.zeros(SHAPE, np.float32),
                      np.zeros(SHAPE, np.int8), dims=(2, 2, 2),
                      dirty_blocks=touched)
    assert ov > 0


@pytest.mark.parametrize("z,capacity", [(0.8, 8192), (1.15, 8192),
                                        (1.15, 300)])
def test_esdf_slice_export_matches_jax(scene, z, capacity):
    state, _ = scene
    e, _, part, *_ = _compare(state, np.zeros(SHAPE, np.float32),
                              np.zeros(SHAPE, np.int8))
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    base_R = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    base_T = np.zeros((8, 3), np.float32)
    base_R[0] = q.astype(np.float32)
    base_T[0] = [0.3, -0.1, 0.2]
    want = je.esdf_slice_export(JCFG, capacity, 128, state, jnp.asarray(e),
                                jnp.asarray(part), jnp.asarray(base_R),
                                jnp.asarray(base_T), jnp.int32(0),
                                jnp.float32(z), jnp.float32(0.5))
    got = te.esdf_slice_export(TCFG, capacity, 128,
                               bridge.grid_state_from_numpy(state,
                                                            device="cpu"),
                               torch.from_numpy(e), torch.from_numpy(part),
                               torch.from_numpy(base_R),
                               torch.from_numpy(base_T), 0, z, 0.5)
    assert int(want[5]) == int(got[5]) > 0
    assert int(got[5]) <= capacity
    for a, b in zip(want[:5], got[:5]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)
