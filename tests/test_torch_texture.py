"""Textured fusion: the PyTorch port against the JAX package.

JAX runs its Pallas accumulation in interpret mode (``pallas_accum="on"``):
the per-frame weighted-mean color, the port's semantics. Both packages get
the same seeded numpy frames and textures. Bounds: block tables, observed
flags and ``num_blocks`` exact; TSDF and color to atol 2e-3, W to rtol
2e-3 (the two sum f32 values in different orders); color indices and jet
lookups exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core import colormap as jcm  # noqa: E402
from taichislam_tpu.core import geometry as jgeo  # noqa: E402
from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core import colormap as tcm  # noqa: E402
from taichislam_tpu_torch.core import geometry as tgeo  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402

BASE = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_ray_length=1.5, min_ray_length=0.3, recast_step=2,
            max_blocks=64, max_bins=1024, max_submap_num=4,
            max_touched_blocks=64, texture_enabled=True)
K = np.asarray([20.0, 0, 16.0, 0, 20.0, 12.0, 0, 0, 1], np.float32)
KC = np.asarray([22.5, 0, 15.3, 0, 21.7, 12.6, 0, 0, 1], np.float32)


def _texture(rng, h=24, w=32):
    """Smooth, non-constant RGB with noise: neighbouring pixels differ."""
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([ii * 7.0, jj * 9.0, (ii + jj) * 4.0], -1)
    return np.clip(base + rng.integers(0, 40, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _frames(n=2):
    rng = np.random.default_rng(5)
    out = []
    for f in range(n):
        depth = rng.integers(400, 1400, (24, 32)).astype(np.uint16)
        th = 0.25 * f
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th),
                                                      0], [0, 0, 1]],
                     np.float32)
        T = np.asarray([0.02 + 0.04 * f, -0.01, 0.03], np.float32)
        out.append((depth, _texture(rng), R, T))
    return out


def _assert_states_match(js, ps, atol=2e-3):
    for name in ("table", "block_coords", "block_active", "num_blocks",
                 "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ps, name), err_msg=name)
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(js.channels[name]),
                                      ps.channels[name], err_msg=name)
    for name in ("TSDF", "color"):
        a = np.asarray(js.channels[name])
        assert ps.channels[name].dtype == a.dtype
        np.testing.assert_allclose(a.astype(np.float32),
                                   ps.channels[name].astype(np.float32),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(
        np.asarray(js.channels["W_TSDF"], np.float32),
        ps.channels["W_TSDF"].astype(np.float32), rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("same_proj", [True, False])
def test_textured_integrate_depth_matches_jax(dtype, same_proj):
    kw = dict(BASE, storage_dtype=dtype, color_same_proj=same_proj)
    cj, ct = JConfig(pallas_accum="on", **kw), TConfig(**kw)
    js, ps = jt.make_tsdf_state(cj), tt.make_tsdf_state(ct, device="cpu")
    for depth, tex, R, T in _frames(2):
        js, jstats = jt.integrate_depth(
            cj, js, jnp.asarray(depth), jnp.asarray(tex), jnp.asarray(R),
            jnp.asarray(T), jnp.asarray(K), jnp.asarray(KC), jnp.int32(1))
        ps, pstats = tt.integrate_depth(
            ct, ps, torch.from_numpy(depth.astype(np.int32)),
            torch.from_numpy(tex), torch.from_numpy(R), torch.from_numpy(T),
            torch.from_numpy(K), torch.from_numpy(KC), 1)
        for k in jstats:
            np.testing.assert_array_equal(np.asarray(jstats[k]),
                                          pstats[k].numpy(), err_msg=k)
    ps = bridge.grid_state_to_numpy(ps)
    _assert_states_match(js, ps)
    obs = ps.channels["TSDF_observed"] > 0
    assert obs.sum() > 200
    col = ps.channels["color"].astype(np.float32).transpose(0, 2, 1)[obs]
    assert col.std(axis=0).min() > 0.02       # the texture varies
    assert ((col >= 0) & (col <= 1.0 + 1e-3)).all()


def test_color_reprojection_indices_exact():
    """``(i - cx) / fx * fx_c + cx_c`` truncated, as jitted XLA contracts
    it: every pixel picks the same color index."""
    jj, ii = np.meshgrid(np.arange(0, 480, 2), np.arange(0, 640, 2),
                         indexing="ij")
    ii, jj = ii.reshape(-1).astype(np.float32), jj.reshape(-1).astype(
        np.float32)
    kd = np.asarray([384.2377, 0, 323.4873, 0, 384.2377, 235.0628, 0, 0, 1],
                    np.float32)
    kc = np.asarray([611.3, 0, 318.9, 0, 610.8, 241.7, 0, 0, 1], np.float32)
    fn = jax.jit(jgeo.color_ind_from_depth_pt, static_argnums=(4, 5))
    want = fn(jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kd),
              jnp.asarray(kc), 640, 480)
    got = tgeo.color_ind_from_depth_pt(
        torch.from_numpy(ii), torch.from_numpy(jj), torch.from_numpy(kd),
        torch.from_numpy(kc), 640, 480)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (got[1].numpy() > 0).sum() > 1000


@pytest.mark.parametrize("jitted", [True, False])
def test_color_from_colormap_exact(jitted):
    z = np.random.default_rng(2).uniform(-0.7, 0.7, 20000).astype(np.float32)
    fn = jcm.color_from_colormap
    if jitted:
        fn = jax.jit(fn, static_argnums=(1, 2))
    want = np.asarray(fn(jnp.asarray(z), -0.5, 0.5))
    got = tcm.color_from_colormap(torch.from_numpy(z), -0.5, 0.5,
                                  reciprocal=jitted).numpy()
    np.testing.assert_allclose(want, got, atol=1e-6)


@pytest.mark.parametrize("jitted", [True, False])
def test_color_from_colormap_custom_lut(jitted):
    """A given (n, 3) LUT replaces jet, and its length sets the scale
    ``n - 1``: both packages called as ``f(z, min, max, lut)``."""
    rng = np.random.default_rng(4)
    z = rng.uniform(-1.3, 1.6, 20000).astype(np.float32)
    lut = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    fn = jcm.color_from_colormap
    if jitted:
        fn = jax.jit(fn, static_argnums=(1, 2))
    want = np.asarray(fn(jnp.asarray(z), -1.0, 1.25, jnp.asarray(lut)))
    got = tcm.color_from_colormap(torch.from_numpy(z), -1.0, 1.25,
                                  torch.from_numpy(lut),
                                  reciprocal=jitted).numpy()
    assert got.shape == (len(z), 3)
    np.testing.assert_allclose(want, got, atol=1e-6)


@pytest.mark.parametrize("textured", [False, True])
def test_pcl_to_points_by_jax_keywords(textured):
    cj = JConfig(**dict(BASE, texture_enabled=textured))
    ct = TConfig(**dict(BASE, texture_enabled=textured))
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-2, 2, (50, 3))
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    wp, wc = jt.pcl_to_points(cj, xyz_array=jnp.asarray(xyz, jnp.float32),
                              rgb_array=jnp.asarray(rgb))
    gp, gc = tt.pcl_to_points(ct, xyz_array=torch.from_numpy(xyz).float(),
                              rgb_array=torch.from_numpy(rgb))
    np.testing.assert_array_equal(np.asarray(wp), gp.numpy())
    assert gp.dtype == torch.float32
    if textured:
        assert gc.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(wc), gc.numpy())
    else:
        assert wc is None and gc is None


def test_textured_integrate_pcl_matches_jax():
    cj, ct = JConfig(pallas_accum="on", **BASE), TConfig(**BASE)
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1.2, 1.2, (900, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (900, 3)).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    T = np.asarray([0.05, -0.02, 0.01], np.float32)
    js, jstats = jt.integrate_pcl(cj, jt.make_tsdf_state(cj),
                                  jnp.asarray(xyz), jnp.asarray(rgb),
                                  jnp.asarray(R), jnp.asarray(T),
                                  jnp.int32(0))
    ps, pstats = tt.integrate_pcl(ct, tt.make_tsdf_state(ct, device="cpu"),
                                  torch.from_numpy(xyz),
                                  torch.from_numpy(rgb), torch.from_numpy(R),
                                  torch.from_numpy(T), 0)
    for k in jstats:
        np.testing.assert_array_equal(np.asarray(jstats[k]),
                                      pstats[k].numpy(), err_msg=k)
    _assert_states_match(js, bridge.grid_state_to_numpy(ps))
    assert int(ps.num_blocks) > 4


@pytest.mark.parametrize("textured", [True, False])
def test_init_sphere_matches_jax(textured):
    kw = dict(BASE, map_scale=(6.4, 6.4), max_blocks=256,
              texture_enabled=textured)
    cj, ct = JConfig(**kw), TConfig(**kw)
    js = jt.init_sphere(cj, jt.make_tsdf_state(cj), 0)
    ps = tt.init_sphere(ct, tt.make_tsdf_state(ct, device="cpu"), 0)
    ps = bridge.grid_state_to_numpy(ps)
    for name in ("table", "num_blocks", "block_coords"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ps, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(js.channels["TSDF_observed"]),
                                  ps.channels["TSDF_observed"])
    np.testing.assert_allclose(np.asarray(js.channels["TSDF"]),
                               ps.channels["TSDF"], atol=2e-3)
    if textured:
        np.testing.assert_allclose(np.asarray(js.channels["color"]),
                                   ps.channels["color"], atol=2e-3)
        assert ps.channels["color"].max() > 0.5


def test_bridge_carries_color_both_ways():
    cj = JConfig(pallas_accum="on", **BASE)
    depth, tex, R, T = _frames(1)[0]
    js, _ = jt.integrate_depth(cj, jt.make_tsdf_state(cj), jnp.asarray(depth),
                               jnp.asarray(tex), jnp.asarray(R),
                               jnp.asarray(T), jnp.asarray(K),
                               jnp.asarray(K), jnp.int32(0))
    back = bridge.grid_state_to_numpy(
        bridge.grid_state_from_numpy(js, device="cpu"))
    a = np.asarray(js.channels["color"])
    assert back.channels["color"].shape == a.shape == (65, 3, 512)
    np.testing.assert_array_equal(back.channels["color"], a)


def test_color_rows_past_the_image_clamp_as_jax():
    """A color camera with a longer focal length maps depth rows past the
    color image's last row; the reference's bounds test (rows against the
    width) lets them through and JAX's gather clamps them to the last row.
    The port clamps the same way."""
    kc = np.asarray([30.0, 0, 15.3, 0, 34.0, 12.6, 0, 0, 1], np.float32)
    kw = dict(BASE, color_same_proj=False)
    cj, ct = JConfig(pallas_accum="on", **kw), TConfig(**kw)
    depth, tex, R, T = _frames(1)[0]
    js, _ = jt.integrate_depth(
        cj, jt.make_tsdf_state(cj), jnp.asarray(depth), jnp.asarray(tex),
        jnp.asarray(R), jnp.asarray(T), jnp.asarray(K), jnp.asarray(kc),
        jnp.int32(0))
    rows = tgeo.color_ind_from_depth_pt(
        torch.arange(0, 32, 2.0).repeat(12), torch.arange(0, 24, 2.0)
        .repeat_interleave(16), torch.from_numpy(K), torch.from_numpy(kc),
        32, 24)[0]
    assert int(rows.max()) >= 24
    ps, _ = tt.integrate_depth(
        ct, tt.make_tsdf_state(ct, device="cpu"),
        torch.from_numpy(depth.astype(np.int32)),
        torch.from_numpy(tex), torch.from_numpy(R), torch.from_numpy(T),
        torch.from_numpy(K), torch.from_numpy(kc), 0)
    _assert_states_match(js, bridge.grid_state_to_numpy(ps))
