"""Submap fusion (ops/fusion.py): the PyTorch port against the JAX package.

The submap grid is built once by the JAX package (two submaps, one of them
re-posed by a rotation) and carried to the port through the numpy bridge.
At V = 8 the JAX side runs its K1 path in Pallas interpret mode
(``pallas_accum="on"``); at V = 10 (V³ = 1000) it takes its XLA scatters,
while the port always takes K1. Bounds are those of
``tests/test_pallas_accum.py``: block tables, ``num_blocks``, ``occupy``,
``TSDF_observed`` and the stats exact; TSDF atol 2e-3; W rtol 2e-3 / atol
1e-3; color atol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import fusion as jf  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import fusion as tf  # noqa: E402

K = np.asarray([20.0, 0, 16.0, 0, 20.0, 12.0, 0, 0, 1], np.float32)
SUB = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, max_ray_length=1.5,
           min_ray_length=0.3, recast_step=2, max_blocks=96, max_bins=1024,
           max_submap_num=4)
GLOB = dict(map_scale=(6.4, 6.4), voxel_scale=0.1, max_blocks=160,
            max_submap_num=1, is_global_map=True, max_touched_blocks=160)
NS = 4


def _bases():
    rng = np.random.default_rng(4)
    base_R = np.tile(np.eye(3, dtype=np.float32), (NS, 1, 1))
    base_T = np.zeros((NS, 3), np.float32)
    base_R[1] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    base_T[1] = [0.43, -0.31, 0.17]
    base_T[0] = [0.05, 0.02, -0.03]
    return base_R, base_T


_SUBMAPS = {}


def _submap_state(V, textured):
    """Three textured (or plain) frames into submaps 0 and 1, fused by the
    JAX package's XLA path; cached per (V, textured)."""
    key = (V, textured)
    if key not in _SUBMAPS:
        cfg = JConfig(num_voxel_per_blk_axis=V, texture_enabled=textured,
                      pallas_accum="off", **SUB)
        rng = np.random.default_rng(10 + V)
        st = jt.make_tsdf_state(cfg)
        for f, sub in ((0, 0), (1, 1), (2, 1)):
            depth = rng.integers(400, 1400, (24, 32)).astype(np.uint16)
            tex = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
            th = 0.4 * f
            R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]], np.float32)
            st, _ = jt.integrate_depth(
                cfg, st, jnp.asarray(depth), jnp.asarray(tex), jnp.asarray(R),
                jnp.asarray([0.04 * f, -0.02, 0.01], np.float32),
                jnp.asarray(K), jnp.asarray(K), jnp.int32(sub))
        _SUBMAPS[key] = st
    return _SUBMAPS[key]


def _configs(V, textured, **glob):
    kw = dict(GLOB, num_voxel_per_blk_axis=V, texture_enabled=textured)
    kw.update(glob)
    sub = dict(SUB, num_voxel_per_blk_axis=V, texture_enabled=textured)
    return (JConfig(pallas_accum="off", **sub), TConfig(**sub),
            JConfig(pallas_accum="on", **kw), TConfig(**kw))


def _run_both(V, textured, bcap=96, only=None, **glob):
    js_sub = _submap_state(V, textured)
    jsub, tsub, jglob, tglob = _configs(V, textured, **glob)
    bR, bT = _bases()
    want, wst = jf.fuse_submaps(
        jsub, jglob, bcap, jt.make_tsdf_state(jglob), js_sub,
        jnp.asarray(bR), jnp.asarray(bT),
        only_submap=None if only is None else jnp.int32(only))
    got, gst = tf.fuse_submaps(
        tsub, tglob, bcap,
        bridge.grid_state_from_numpy(jt.make_tsdf_state(jglob), device="cpu"),
        bridge.grid_state_from_numpy(js_sub, device="cpu"),
        torch.from_numpy(bR),
        torch.from_numpy(bT), only_submap=only)
    return want, wst, bridge.grid_state_to_numpy(got), gst


def _check(want, wst, got, gst):
    for k in ("fuse_sources", "fuse_dropped", "fuse_tiles_dropped"):
        assert int(wst[k]) == int(gst[k]), k
    for name in ("table", "block_coords", "block_active", "num_blocks",
                 "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name), err_msg=name)
    wc, gc = want.channels, got.channels
    for k in ("occupy", "TSDF_observed"):
        np.testing.assert_array_equal(np.asarray(wc[k]), gc[k], err_msg=k)
    np.testing.assert_allclose(np.asarray(wc["TSDF"]), gc["TSDF"], atol=2e-3)
    np.testing.assert_allclose(np.asarray(wc["W_TSDF"]), gc["W_TSDF"],
                               rtol=2e-3, atol=1e-3)
    if "color" in wc:
        np.testing.assert_allclose(np.asarray(wc["color"]), gc["color"],
                                   atol=1e-4)


@pytest.mark.parametrize("V,textured", [(8, False), (8, True), (10, False)],
                         ids=["v8", "v8_textured", "v10_scatter"])
def test_fuse_submaps_matches_jax(V, textured):
    want, wst, got, gst = _run_both(V, textured)
    assert int(gst["fuse_sources"]) > 1000 and int(want.num_blocks) > 10
    _check(want, wst, got, gst)


def test_fuse_only_submap_matches_jax():
    want, wst, got, gst = _run_both(8, False, only=1)
    _check(want, wst, got, gst)
    # the sources of submap 1 alone
    full = _run_both(8, False)[3]
    assert 0 < int(gst["fuse_sources"]) < int(full["fuse_sources"])


def test_touched_overflow_and_source_drop_match_jax():
    """One touched tile and a source cap of 4 blocks: both packages report
    the same overflow and write the same (truncated) map."""
    want, wst, got, gst = _run_both(8, False, bcap=4, max_touched_blocks=1)
    assert int(gst["fuse_tiles_dropped"]) > 0 and int(gst["fuse_dropped"]) > 0
    _check(want, wst, got, gst)


def test_splat_contributions_match_jax():
    """The splat lanes themselves, bit for bit against the jitted JAX
    function: target blocks, intra indices, masks, counts and weights (the
    trilinear weights hang on the same rounding of R·l + T as the voxel
    indices)."""
    js_sub = _submap_state(8, True)
    jsub, tsub, jglob, tglob = _configs(8, True)
    bR, bT = _bases()
    # jitted, as fuse_submaps runs it (XLA contracts inside jit only)
    want = jax.jit(jf.splat_contributions, static_argnums=(0, 1, 2))(
        jsub, jglob, 96, js_sub, jnp.asarray(bR), jnp.asarray(bT))
    got = tf.splat_contributions(tsub, tglob, 96,
                                 bridge.grid_state_from_numpy(
                                     js_sub, device="cpu"),
                                 torch.from_numpy(bR), torch.from_numpy(bT))
    for k in ("blin", "ok", "intra", "occ", "kept", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(want, k)),
                                      getattr(got, k).numpy(), err_msg=k)
    for k in ("w", "wd", "wc"):
        np.testing.assert_allclose(np.asarray(getattr(want, k)),
                                   getattr(got, k).numpy(), rtol=0,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("textured", [False, True])
def test_dense_accumulators_match_jax(textured):
    """The dense path the multi-drone fuse sums over ranks: the touched
    table bitmap, allocation from it, the per-voxel sums (K1 in the port,
    XLA scatters in JAX, both in lane order per voxel) and the closed-form
    merge (jitted, as the JAX fuse runs it)."""
    from taichislam_tpu.core.grid import allocate_from_touched as j_alloc
    from taichislam_tpu_torch.core.grid import allocate_from_touched
    js_sub = _submap_state(8, textured)
    jsub, tsub, jglob, tglob = _configs(8, textured)
    bR, bT = _bases()
    jc = jax.jit(jf.splat_contributions, static_argnums=(0, 1, 2))(
        jsub, jglob, 96, js_sub, jnp.asarray(bR), jnp.asarray(bT))
    tc = tf.splat_contributions(tsub, tglob, 96, bridge.grid_state_from_numpy(
        js_sub, device="cpu"), torch.from_numpy(bR), torch.from_numpy(bT))
    jg = jt.make_tsdf_state(jglob)
    tg = bridge.grid_state_from_numpy(jg, device="cpu")
    jtouched = jf.accumulate_dense(jglob, jg, jc)
    ttouched = tf.accumulate_dense(tglob, tg, tc)
    np.testing.assert_array_equal(np.asarray(jtouched), ttouched.numpy())
    jg = j_alloc(jglob.grid, jg, jtouched, jnp.int32(0))
    tg = allocate_from_touched(tglob.grid, tg, ttouched, 0)
    want = jf.scatter_accumulators(jglob, jg, jc)
    got = tf.scatter_accumulators(tglob, tg, tc)
    for k, w, g in zip(("w", "wd", "occ", "wc"), want, got):
        assert g.dtype == (torch.int32 if k == "occ" else torch.float32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert float(got[0].sum()) > 0
    jg = jax.jit(jf.combine_accumulators, static_argnums=0)(jglob, jg, *want)
    tg = tf.combine_accumulators(tglob, tg, *got)
    no_stats = dict.fromkeys(("fuse_sources", "fuse_dropped",
                              "fuse_tiles_dropped"), 0)
    _check(jg, no_stats, bridge.grid_state_to_numpy(tg), no_stats)
