"""Parity of the PyTorch port's core modules with the JAX package.

Same seeded numpy inputs through both packages; every function here is
integer or exactly rounded float math, so agreement is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core import compaction as jcomp  # noqa: E402
from taichislam_tpu.core import config as jconfig  # noqa: E402
from taichislam_tpu.core import geometry as jgeo  # noqa: E402
from taichislam_tpu.core import grid as jgrid  # noqa: E402
from taichislam_tpu.core.colormap import jet_lut_np as jet_jax  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core import compaction as tcomp  # noqa: E402
from taichislam_tpu_torch.core import config as tconfig  # noqa: E402
from taichislam_tpu_torch.core import geometry as tgeo  # noqa: E402
from taichislam_tpu_torch.core import grid as tgrid  # noqa: E402
from taichislam_tpu_torch.core.colormap import jet_lut_np as jet_port  # noqa: E402,E501

CFG_KW = dict(map_scale=(3.2, 1.6), voxel_scale=0.1, num_voxel_per_blk_axis=8,
              max_ray_length=1.5, min_ray_length=0.3, max_blocks=64,
              max_bins=1024, max_submap_num=4, max_touched_blocks=64,
              storage_dtype="float16")


def t(a):
    return torch.from_numpy(np.array(a))


def test_configs_share_fields_and_derived_sizes():
    jc, tc = jconfig.TSDFConfig(**CFG_KW), tconfig.TSDFConfig(**CFG_KW)
    j_fields = {f.name for f in dataclasses.fields(jc)}
    t_fields = {f.name for f in dataclasses.fields(tc)}
    assert j_fields == t_fields
    assert dataclasses.asdict(jc.grid) == dataclasses.asdict(tc.grid)
    assert tc.dtype == torch.float16
    assert tc.max_ray_steps == jc.max_ray_steps
    assert tc.grid.table_size == jc.grid.table_size


def test_sign_and_round_half_away():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-40, 40, 5000),
                        np.arange(-20, 21) + 0.5, [0.0, -0.0]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jgeo.sign(jnp.asarray(x))),
                                  tgeo.sign(t(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jgeo.round_half_away(jnp.asarray(x))),
        tgeo.round_half_away(t(x)).numpy())


@pytest.mark.parametrize("step,shape", [(2, (48, 64)), (3, (47, 65))])
def test_strided_depth_and_pixel_grid(step, shape):
    rng = np.random.default_rng(step)
    depth = rng.integers(0, 4000, shape).astype(np.uint16)
    want = np.asarray(jgeo.strided_depth_f32(jnp.asarray(depth), step))
    got = tgeo.strided_depth_f32(t(depth.astype(np.int32)), step)
    np.testing.assert_array_equal(want, got.numpy())
    jj, ii = jgeo.pixel_grid(*shape, step)
    tj, ti = tgeo.pixel_grid(*shape, step)
    np.testing.assert_array_equal(np.asarray(jj), tj.numpy())
    np.testing.assert_array_equal(np.asarray(ii), ti.numpy())


def test_convert_by_base():
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    args = (q, rng.standard_normal(3), np.eye(3), rng.standard_normal(3))
    for a, b in zip(jgeo.convert_by_base(*args), tgeo.convert_by_base(*args)):
        np.testing.assert_array_equal(a, b)


def test_jet_lut_matches_matplotlib_sampling():
    np.testing.assert_allclose(jet_port(), jet_jax(), atol=1e-6)


@pytest.mark.parametrize("capacity", [5, 64, 200])
def test_compact_mask(capacity):
    mask = np.random.default_rng(capacity).random(150) < 0.3
    want = jcomp.compact_mask(jnp.asarray(mask), capacity)
    got = tcomp.compact_mask(t(mask), capacity)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _spec_pair():
    return (jconfig.TSDFConfig(**CFG_KW).grid,
            tconfig.TSDFConfig(**CFG_KW).grid)


def test_voxel_addressing():
    js, ts = _spec_pair()
    rng = np.random.default_rng(4)
    v = rng.integers(-25, 25, (3, 3000)).astype(np.int32)
    s = rng.integers(-1, 5, 3000).astype(np.int32)
    want = jgrid.voxel_to_block_c(js, jnp.asarray(s), *map(jnp.asarray, v))
    got = tgrid.voxel_to_block_c(ts, t(s), *map(t, v))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    blin = np.asarray(want[0])
    ok = blin >= 0
    np.testing.assert_array_equal(
        np.asarray(jgrid.block_lin_to_coords(js, jnp.asarray(blin[ok]))),
        tgrid.block_lin_to_coords(ts, t(blin[ok])).numpy())
    np.testing.assert_array_equal(
        np.asarray(jgrid.flat_voxel_index(js, jnp.asarray(blin),
                                          want[1])),
        tgrid.flat_voxel_index(ts, t(blin), got[1]).numpy())


@pytest.mark.parametrize("n_cand,submap", [(40, 1), (400, 2)])
def test_allocation_and_lookup(n_cand, submap):
    """Prefix-sum allocation, incl. capacity overflow (400 candidates over
    a 64-block grid), then slot lookup: all exact."""
    js, ts = _spec_pair()
    rng = np.random.default_rng(n_cand)
    bps = js.blocks_per_submap
    cand = (submap * bps + rng.integers(-5, bps + 5, n_cand)).astype(
        np.int32)
    valid = rng.random(n_cand) < 0.9
    defs_j = {"TSDF": (jnp.float16, ())}
    jst = jgrid.make_grid_state(js, defs_j)
    tst = tgrid.make_grid_state(ts, {"TSDF": (torch.float16, ())},
                                device="cpu")
    for _ in range(2):   # second round re-touches allocated blocks
        jst = jgrid.allocate_blocks(js, jst, jnp.asarray(cand),
                                    jnp.asarray(valid), jnp.int32(submap))
        tst = tgrid.allocate_blocks(ts, tst, t(cand), t(valid), submap)
        cand = cand + 3
    got = bridge.grid_state_to_numpy(tst)
    for name in ("table", "block_coords", "block_active", "num_blocks",
                 "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      getattr(got, name), err_msg=name)
    probe = np.concatenate([cand, [-1]]).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jgrid.lookup_slots(js, jst.table, jnp.asarray(probe))),
        tgrid.lookup_slots(ts, tst.table, t(probe)).numpy())


def test_scatter_max():
    rng = np.random.default_rng(5)
    ch = rng.integers(0, 2, (8, 64)).astype(np.int8)
    idx = rng.integers(0, ch.size, 300).astype(np.int32)
    val = rng.integers(0, 3, 300).astype(np.int8)
    want = jgrid.scatter_max(jnp.asarray(ch), jnp.asarray(idx),
                             jnp.asarray(val))
    got = tgrid.scatter_max(t(ch.copy()), t(idx), t(val))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_bridge_round_trip_is_exact():
    js, _ = _spec_pair()
    rng = np.random.default_rng(6)
    jst = jgrid.make_grid_state(js, {"TSDF": (jnp.float16, ()),
                                     "W_TSDF": (jnp.float32, ()),
                                     "occupy": (jnp.int8, ())})
    jst = jgrid.allocate_blocks(
        js, jst, jnp.asarray(rng.integers(0, 50, 30).astype(np.int32)),
        jnp.ones(30, bool), jnp.int32(0))
    jst = jst._replace(channels={
        k: jnp.asarray(rng.standard_normal(v.shape).astype(v.dtype))
        for k, v in jst.channels.items()})
    back = bridge.grid_state_to_numpy(
        bridge.grid_state_from_numpy(jst, device="cpu"))
    for name in ("table", "block_coords", "block_active", "num_blocks",
                 "alloc_overflow"):
        a, b = np.asarray(getattr(jst, name)), getattr(back, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for k, v in jst.channels.items():
        a = np.asarray(v)
        assert back.channels[k].dtype == a.dtype
        np.testing.assert_array_equal(back.channels[k], a)
    esdf = {"esdf": rng.standard_normal((4, 8)).astype(np.float32),
            "fixed": rng.integers(0, 2, (4, 8)).astype(np.int8),
            "pending": rng.random(4) < 0.5,
            "seen_obs": rng.random((4, 8)) < 0.5}
    back = bridge.esdf_state_to_numpy(
        bridge.esdf_state_from_numpy(esdf, device="cpu"))
    for k, v in esdf.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    with pytest.raises(KeyError):
        bridge.esdf_state_from_numpy({"bogus": esdf["esdf"]}, device="cpu")


def test_synthetic_scene_matches_jax_package():
    from taichislam_tpu.utils import synthetic_scene as js_scene
    from taichislam_tpu_torch.utils import synthetic_scene as ts_scene
    K = js_scene.D435_K * np.float32(0.1)
    K[8] = 1.0
    a = js_scene.orbit_sequence(n_frames=2, h=24, w=32, K=K)
    b = ts_scene.orbit_sequence(n_frames=2, h=24, w=32, K=K)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
