"""TSDF integration: the PyTorch port against the JAX package.

JAX runs its Pallas accumulation in interpret mode (``pallas_accum="on"``).
Bounds: block tables, coordinates, observed / occupancy flags and every
stat are exact; TSDF agrees to 2e-3 at float32 storage (the two paths sum
f32 values in different orders) and 4e-3 at float16 (one f16 ulp near
1.5 m on top of that); W to rtol 2e-3 and atol 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402

BASE = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_ray_length=1.5, min_ray_length=0.3, recast_step=2,
            max_blocks=64, max_bins=1024, max_submap_num=4,
            max_touched_blocks=64)
K = np.asarray([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)


def _frames(n=2):
    rng = np.random.default_rng(7)
    out = []
    for f in range(n):
        depth = rng.integers(400, 1400, (48, 64)).astype(np.uint16)
        th = 0.3 * f
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th),
                                                      0], [0, 0, 1]],
                     np.float32)
        T = np.asarray([0.03 + 0.05 * f, -0.01, 0.02], np.float32)
        out.append((depth, R, T))
    return out


def _run_jax(cfg, frames):
    st = jt.make_tsdf_state(cfg)
    stats = []
    for depth, R, T in frames:
        st, s = jt.integrate_depth(cfg, st, jnp.asarray(depth),
                                   jnp.zeros((1, 1, 3), jnp.uint8),
                                   jnp.asarray(R), jnp.asarray(T),
                                   jnp.asarray(K), jnp.asarray(K),
                                   jnp.int32(1))
        stats.append({k: np.asarray(v) for k, v in s.items()})
    return st, stats


def _run_port(cfg, frames):
    st = tt.make_tsdf_state(cfg, device="cpu")
    stats = []
    for depth, R, T in frames:
        st, s = tt.integrate_depth(cfg, st,
                                   torch.from_numpy(depth.astype(np.int32)),
                                   None, torch.from_numpy(R),
                                   torch.from_numpy(T), torch.from_numpy(K),
                                   torch.from_numpy(K), 1)
        stats.append({k: v.numpy() for k, v in s.items()})
    return bridge.grid_state_to_numpy(st), stats


def _assert_states_match(js, ps, tsdf_atol):
    for name in ("table", "block_coords", "block_active", "num_blocks",
                 "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ps, name), err_msg=name)
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(js.channels[name]),
                                      ps.channels[name], err_msg=name)
    assert ps.channels["TSDF"].dtype == np.asarray(js.channels["TSDF"]).dtype
    np.testing.assert_allclose(
        np.asarray(js.channels["TSDF"], np.float32),
        ps.channels["TSDF"].astype(np.float32), atol=tsdf_atol)
    np.testing.assert_allclose(
        np.asarray(js.channels["W_TSDF"], np.float32),
        ps.channels["W_TSDF"].astype(np.float32), rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-3),
                                        ("float16", 4e-3)])
def test_integrate_depth_matches_jax(dtype, atol):
    kw = dict(BASE, storage_dtype=dtype)
    frames = _frames(2)
    js, jstats = _run_jax(JConfig(pallas_accum="on", **kw), frames)
    ps, pstats = _run_port(TConfig(**kw), frames)
    _assert_states_match(js, ps, atol)
    assert int(ps.num_blocks) > 4
    for a, b in zip(jstats, pstats):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_integrate_capacity_drops_match_jax():
    """Undersized lane cap, touched-block cap and bin bucket: the drop
    stats, and what survives them, agree exactly."""
    kw = dict(BASE, max_march_lanes=2048, max_touched_blocks=4,
              max_bins=256)
    frames = _frames(1)
    js, jstats = _run_jax(JConfig(pallas_accum="on", **kw), frames)
    ps, pstats = _run_port(TConfig(**kw), frames)
    s = pstats[0]
    assert s["lanes_dropped"] > 0 and s["touched_dropped"] > 0
    assert s["bins_dropped"] > 0
    for k in jstats[0]:
        np.testing.assert_array_equal(jstats[0][k], s[k], err_msg=k)
    _assert_states_match(js, ps, 2e-3)


def test_unprojection_bins_and_weights_match_jax():
    """Jitted, as integrate runs them: XLA's compiled rounding (constant
    divisions as reciprocal multiplies, contracted FMAs) is the reference."""
    import jax
    cfg_j = JConfig(pallas_accum="on", **BASE)
    cfg_t = TConfig(**BASE)
    depth, R, T = _frames(1)[0]
    (jx, jy, jz), jdep, _, jvalid = jax.jit(
        jt.depth_to_points_c, static_argnums=0)(
        cfg_j, jnp.asarray(depth), None, jnp.asarray(K), jnp.asarray(K))
    (tx, ty, tz), tdep, _, tvalid = tt.depth_to_points_c(
        cfg_t, torch.from_numpy(depth.astype(np.int32)), None,
        torch.from_numpy(K), torch.from_numpy(K))
    for a, b in ((jx, tx), (jy, ty), (jz, tz), (jvalid, tvalid)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jb = jax.jit(jt.bin_points_c, static_argnums=0)(
        cfg_j, jx, jy, jz, jdep, None, jvalid)
    tb = tt.bin_points_c(cfg_t, tx, ty, tz, tdep, None, tvalid)
    np.testing.assert_array_equal(np.asarray(jb.count), tb.count.numpy())
    np.testing.assert_allclose(np.asarray(jb.sum_pos), tb.sum_pos.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(jb.sum_z), tb.sum_z.numpy(),
                               atol=1e-4)
    assert int(jb.dropped) == int(tb.dropped)
    d = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    z = np.linspace(0.3, 1.5, 101, dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jt.w_x_p, static_argnums=0)(
            cfg_j, jnp.asarray(d), jnp.asarray(z))),
        tt.w_x_p(cfg_t, torch.from_numpy(d), torch.from_numpy(z)).numpy())

