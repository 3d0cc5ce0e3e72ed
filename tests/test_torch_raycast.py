"""Raycasts, point queries and the core names they need: the PyTorch port
against the JAX package.

The JAX raycasts and point queries are jitted with the config static, so
their ``xyz / voxel_scale`` is a multiply by the f32 reciprocal; an eager
JAX call divides. ``xyz_to_ijk`` rounds the second way by default and the
first with ``reciprocal=True``, which the port's predicates take; both are
checked at voxel centres and at half-voxel ties, where the two roundings
part. Hits, lengths and query answers are exact; positions that XLA forms
with a contracted multiply-add agree within 1e-6 m.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core import colormap as jcmap  # noqa: E402
from taichislam_tpu.core import compaction as jcomp  # noqa: E402
from taichislam_tpu.core import config as jconfig  # noqa: E402
from taichislam_tpu.core import geometry as jgeo  # noqa: E402
from taichislam_tpu.core import grid as jgrid  # noqa: E402
from taichislam_tpu.models.dense_tsdf import DenseTSDF as JTSDF  # noqa: E402
from taichislam_tpu.models.octomap import Octomap as JOcto  # noqa: E402
from taichislam_tpu.ops import raycast as jrc  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch.core import colormap as tcmap  # noqa: E402
from taichislam_tpu_torch.core import compaction as tcomp  # noqa: E402
from taichislam_tpu_torch.core import config as tconfig  # noqa: E402
from taichislam_tpu_torch.core import geometry as tgeo  # noqa: E402
from taichislam_tpu_torch.core import grid as tgrid  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TTSDF  # noqa: E402,E501
from taichislam_tpu_torch.models.octomap import Octomap as TOcto  # noqa: E402
from taichislam_tpu_torch.ops import raycast as trc  # noqa: E402
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402

SPEC_KW = dict(voxel_scale=0.1, map_size_xy=3.2, map_size_z=1.6,
               num_voxel_per_blk_axis=8, num_submaps=4, max_blocks=16)


def t(a):
    return torch.from_numpy(np.asarray(a))


def tie_points(vs, n=400, seed=0):
    """f32 points at voxel centres, at half-voxel ties and an ulp to
    either side of them, and at random."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-12, 12, (n, 3))
    centres = (k * np.float32(vs)).astype(np.float32)
    ties = ((k + 0.5) * np.float32(vs)).astype(np.float32)
    rand = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    return np.concatenate([centres, ties, np.nextafter(ties, np.float32(0)),
                           np.nextafter(ties, np.float32(9)), rand])


# ---------------------------------------------------------------------------
# the core names (the cases of tests/test_core_grid.py, against JAX)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vs", [0.1, 0.05, 0.07])
def test_xyz_to_ijk_matches_jax_eager_and_jitted(vs):
    xyz = tie_points(vs)
    eager = np.asarray(jgeo.xyz_to_ijk(jnp.asarray(xyz), vs))
    jitted = np.asarray(jax.jit(lambda a: jgeo.xyz_to_ijk(a, vs))(
        jnp.asarray(xyz)))
    assert (eager != jitted).any()       # the ties part the two roundings
    np.testing.assert_array_equal(tgeo.xyz_to_ijk(t(xyz), vs).numpy(), eager)
    np.testing.assert_array_equal(
        tgeo.xyz_to_ijk(t(xyz), vs, reciprocal=True).numpy(), jitted)
    back = tgeo.ijk_to_xyz(tgeo.xyz_to_ijk(t(xyz), vs), vs).numpy()
    assert np.abs(back - xyz).max() <= vs / 2 + 1e-6


def test_voxel_to_block_and_bounds_match_jax():
    js, ts = jconfig.GridSpec(**SPEC_KW), tconfig.GridSpec(**SPEC_KW)
    assert ts.voxel_bounds_lo == js.voxel_bounds_lo == (-16, -16, -8)
    assert ts.voxel_bounds_hi == js.voxel_bounds_hi == (16, 16, 8)
    rng = np.random.default_rng(1)
    ijk = np.concatenate([
        np.array([[-16, -16, -8], [15, 15, 7], [16, 0, 0], [0, 0, 0]]),
        rng.integers(-20, 20, (200, 3))]).astype(np.int32)
    s = np.concatenate([[0, 0, 0, 5],
                        rng.integers(-1, 6, 200)]).astype(np.int32)
    want = jgrid.voxel_to_block(js, jnp.asarray(s), jnp.asarray(ijk))
    got = tgrid.voxel_to_block(ts, t(s), t(ijk))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a scalar submap id, as the raycasts pass it
    want = jgrid.voxel_to_block(js, 1, jnp.asarray(ijk))
    got = tgrid.voxel_to_block(ts, 1, t(ijk))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_scatter_and_channel_helpers_match_jax():
    """scatter_add / scatter_set with repeated and out-of-range indices
    (dropped; negative ones count from the end as in JAX), the flat views
    and clear_garbage_row."""
    js, ts = jconfig.GridSpec(**SPEC_KW), tconfig.GridSpec(**SPEC_KW)
    jst = jgrid.make_grid_state(js, {"val": (jnp.float32, ()),
                                     "col": (jnp.float32, (3,))})
    tst = tgrid.make_grid_state(ts, {"val": (torch.float32, ()),
                                     "col": (torch.float32, (3,))},
                                device="cpu")
    n = jst.channels["val"].size
    rng = np.random.default_rng(2)
    idx = np.concatenate([rng.integers(0, n, 300), [5, 5, 5, n, n + 7, -3]]
                         ).astype(np.int32)
    vals = rng.standard_normal(len(idx)).astype(np.float32)
    ja = jgrid.scatter_add(jst.channels["val"], jnp.asarray(idx),
                           jnp.asarray(vals))
    ta = tgrid.scatter_add(tst.channels["val"].clone(), t(idx), t(vals))
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), atol=1e-6)
    jset = jgrid.scatter_set(jst.channels["val"], jnp.asarray(idx),
                             jnp.asarray(vals))
    tset = tgrid.scatter_set(tst.channels["val"].clone(), t(idx), t(vals))
    np.testing.assert_array_equal(np.asarray(jset), tset.numpy())
    flat = tgrid.channel_flat(tst.channels["col"])
    assert flat.shape == (17 * 3 * 512,)
    assert tgrid.channel_unflat(flat, tst.channels["col"]).shape == \
        tuple(jst.channels["col"].shape)
    for name in ("val", "col"):
        tst.channels[name].fill_(2.0)
    jst = jst._replace(channels={k: v + 2.0 for k, v in
                                 jst.channels.items()})
    jclr = jgrid.clear_garbage_row(jst)
    tclr = tgrid.clear_garbage_row(tst)
    for name in ("val", "col"):
        np.testing.assert_array_equal(np.asarray(jclr.channels[name]),
                                      tclr.channels[name].numpy())


@pytest.mark.parametrize("capacity", [3, 8, 40])
def test_compact_matches_jax(capacity):
    vals = np.arange(10, dtype=np.float32)
    for v, mask in ((vals, vals % 2 == 0),
                    (np.arange(60, dtype=np.float32).reshape(20, 3),
                     np.arange(20) % 3 == 1)):
        want = jcomp.compact(jnp.asarray(v), jnp.asarray(mask), capacity,
                             fill_value=-1)
        got = tcomp.compact(t(v), t(mask), capacity, fill_value=-1)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(3)
    K = np.array([40.0, 0, 32.0, 0, 41.0, 24.0, 0, 0, 1], np.float32)
    i = rng.integers(0, 64, 100).astype(np.int32)
    j = rng.integers(0, 48, 100).astype(np.int32)
    dep = rng.uniform(0.3, 3.0, 100).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jgeo.unproject_point_dep(jnp.asarray(i), jnp.asarray(j),
                                            jnp.asarray(dep),
                                            jnp.asarray(K))),
        tgeo.unproject_point_dep(t(i), t(j), t(dep), t(K)).numpy())
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    T = np.array([0.3, -0.2, 1.0], np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jgeo.transform_points(R, T, jnp.asarray(pts))),
        tgeo.transform_points(R, T, t(pts)).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jgeo.rotate_points(R, jnp.asarray(pts))),
        tgeo.rotate_points(R, t(pts)).numpy(), atol=1e-6)


class _Particles:
    """A particle renderer that records what it is handed."""

    def set_particles(self, p):
        self.pos = np.asarray(p)

    def set_particle_radii(self, r):
        self.radii = np.asarray(r)

    def set_particle_colors(self, c):
        self.colors = np.asarray(c)


def test_jet_lut_and_particle_render_match_jax():
    np.testing.assert_array_equal(tcmap.jet_lut(device="cpu").numpy(),
                                  np.asarray(jcmap.jet_lut()))
    x = np.concatenate([np.linspace(0, 1, 999, dtype=np.float32),
                        np.float32([1.0, 0.5, 255.5 / 256])])
    from matplotlib import cm
    np.testing.assert_array_equal(tcmap.jet_rgba_np(x), cm.jet(x))
    kw = dict(map_scale=[3.2, 3.2], voxel_scale=0.1,
              num_voxel_per_blk_axis=8, max_blocks=64, max_submap_num=4)
    pos = np.random.default_rng(4).uniform(-1, 1, (30, 3)).astype(
        np.float32)
    jp, tp = _Particles(), _Particles()
    JTSDF(**kw).render_occupy_map_to_particles(jp, pos, None, 20, 0.1)
    TTSDF(**kw, device="cpu").render_occupy_map_to_particles(tp, pos, None,
                                                             20, 0.1)
    for name in ("pos", "radii", "colors"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    none = _Particles()
    TTSDF(**kw, device="cpu").render_occupy_map_to_particles(none, pos, None,
                                                             0, 0.1)
    assert not hasattr(none, "pos")


def test_depth_to_points_and_bin_points_match_jax():
    """The stacked forms, jitted as integrate runs the JAX ones."""
    kw = dict(map_scale=(3.2, 3.2), voxel_scale=0.1,
              num_voxel_per_blk_axis=8, max_ray_length=1.5,
              min_ray_length=0.3, max_blocks=64, max_bins=1024,
              max_submap_num=4)
    cfg_j = jconfig.TSDFConfig(pallas_accum="on", **kw)
    cfg_t = tconfig.TSDFConfig(**kw)
    K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
    depth = np.random.default_rng(5).integers(400, 1400, (48, 64)).astype(
        np.uint16)
    jp, jz, _, jv = jax.jit(jt.depth_to_points, static_argnums=0)(
        cfg_j, jnp.asarray(depth), None, jnp.asarray(K), jnp.asarray(K))
    tp, tz, tc, tv = tt.depth_to_points(cfg_t, t(depth.astype(np.int32)),
                                        None, t(K), t(K))
    assert tc is None and tp.shape == (len(tz), 3)
    for a, b in ((jp, tp), (jz, tz), (jv, tv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jb = jax.jit(jt.bin_points, static_argnums=0)(cfg_j, jp, jz, None, jv)
    tb = tt.bin_points(cfg_t, tp, tz, None, tv)
    np.testing.assert_array_equal(np.asarray(jb.count), tb.count.numpy())
    np.testing.assert_allclose(np.asarray(jb.sum_pos), tb.sum_pos.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(jb.sum_z), tb.sum_z.numpy(),
                               atol=1e-4)
    assert int(jb.dropped) == int(tb.dropped)


# ---------------------------------------------------------------------------
# raycasts and point queries
# ---------------------------------------------------------------------------

ROOM = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_blocks=2048, max_submap_num=4, max_ray_length=3.0)


def _room(cls, **kw):
    """tests/test_topo.py's box room: +-1.2 m, TSDF = distance to the
    nearest wall, loaded with load_numpy."""
    m = cls(**ROOM, **kw)
    r = np.arange(-12, 13)
    ii, jj, kk = np.meshgrid(r, r, r, indexing="ij")
    ijk = np.stack([ii, jj, kk], -1).reshape(-1, 3)
    tsdf = (1.2 - np.max(np.abs(ijk * 0.1), axis=-1)).astype(np.float32)
    m.load_numpy(0, ijk, tsdf, np.ones_like(tsdf), np.zeros(len(tsdf)),
                 np.array([]))
    return m


@pytest.fixture(scope="module")
def rooms():
    return _room(JTSDF), _room(TTSDF, device="cpu")


OCTO = dict(map_scale=[6.4, 3.2], voxel_scale=0.1, min_occupy_thres=1,
            max_ray_length=2.0, min_ray_length=0.3, max_blocks=256,
            max_submap_num=8)


@pytest.fixture(scope="module")
def octos():
    """An Octomap of three depth frames in both packages."""
    K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
    jm, tm = JOcto(**OCTO), TOcto(**OCTO, device="cpu")
    rng = np.random.default_rng(0)
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K)
    for f in range(3):
        jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
        depth = (700 + 9 * f + 6.0 * ii + 3.0 * jj +
                 rng.integers(0, 40, (48, 64))).astype(np.uint16)
        th = 0.3 * f
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        T = np.array([0.07 * f, -0.05, 0.02], np.float32)
        for m in (jm, tm):
            m.recast_depth_to_map(R, T, depth, None)
    return jm, tm


def _fan(seed, n=200):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _same_cast(want, got):
    hit, pos, length = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[0].numpy(), hit)
    np.testing.assert_array_equal(got[2].numpy(), length)
    np.testing.assert_allclose(got[1].numpy(), pos, atol=1e-6)
    return hit


@pytest.mark.parametrize("origin", ["centre", "tie", "per ray"])
def test_tsdf_raycast_matches_jax(rooms, origin):
    jm, tm = rooms
    dirs = _fan(1)
    if origin == "per ray":
        pos = np.random.default_rng(2).uniform(-1, 1, (len(dirs), 3)).astype(
            np.float32)
    else:
        pos = np.zeros(3, np.float32) if origin == "centre" else \
            np.float32([0.05, -0.35, 0.25])
    for steps, maxd in ((21, 2.0), (30, 2.5)):
        want = jrc.tsdf_raycast(jm.cfg, steps, jm.state, jnp.int32(0),
                                jnp.asarray(pos), jnp.asarray(dirs),
                                jnp.float32(maxd))
        got = trc.tsdf_raycast(tm.cfg, steps, tm.state, 0, t(pos), t(dirs),
                               torch.tensor(maxd, dtype=torch.float32))
        assert _same_cast(want, got).mean() >= 0.9   # walls within 2 m
    # a per-ray bound, short enough that some rays miss
    maxd = np.random.default_rng(3).uniform(0.2, 1.5, len(dirs)).astype(
        np.float32)
    want = jrc.tsdf_raycast(jm.cfg, 16, jm.state, jnp.int32(0),
                            jnp.asarray(pos), jnp.asarray(dirs),
                            jnp.asarray(maxd))
    got = trc.tsdf_raycast(tm.cfg, 16, tm.state, 0, t(pos), t(dirs),
                           t(maxd))
    hit = _same_cast(want, got)
    assert hit.any() and not hit.all()


def test_point_queries_match_jax(rooms, octos):
    """Occupied / unobserved at voxel centres, half-voxel ties and random
    points; the Octomap's too."""
    jm, tm = rooms
    xyz = tie_points(0.1, seed=6) * 1.5
    for want, got in (
            (jrc.tsdf_point_query(jm.cfg, jm.state, jnp.int32(0),
                                  jnp.asarray(xyz)),
             trc.tsdf_point_query(tm.cfg, tm.state, 0, t(xyz))),
            (jrc.octomap_point_query(octos[0].cfg, octos[0].state,
                                     jnp.int32(0), jnp.asarray(xyz)),
             trc.octomap_point_query(octos[1].cfg, octos[1].state, 0,
                                     t(xyz)))):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    occ, unobs = trc.tsdf_point_query(tm.cfg, tm.state, 0, t(xyz))
    assert occ.any() and not occ.all() and unobs.any() and not unobs.all()


def test_octomap_raycast_matches_jax(octos):
    jm, tm = octos
    dirs = _fan(4)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.0    # towards the frames' surfaces
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos = np.float32([0.0, -0.05, 0.02])
    want = jrc.octomap_raycast(jm.cfg, 25, jm.state, jnp.int32(0),
                               jnp.asarray(pos), jnp.asarray(dirs),
                               jnp.float32(2.4))
    got = trc.octomap_raycast(tm.cfg, 25, tm.state, 0, t(pos), t(dirs),
                              torch.tensor(2.4))
    hit = _same_cast(want, got)
    assert hit.any()


def test_raycast_first_hit_is_the_first_occupied_sample():
    """argmax over the (rays, steps) lattice takes the first occupied
    sample; a predicate true on two separate shells gives the nearer."""
    dirs = _fan(5, 64)

    def shells_j(x):
        r = jnp.linalg.norm(x, axis=-1)
        return ((r > 0.42) & (r < 0.6)) | (r > 0.9)

    def shells_t(x):
        r = torch.linalg.norm(x, dim=-1)
        return ((r > 0.42) & (r < 0.6)) | (r > 0.9)
    pos = np.zeros(3, np.float32)
    want = jrc.raycast(shells_j, jnp.asarray(pos), jnp.asarray(dirs), 1.5,
                       0.1, 16)
    got = trc.raycast(shells_t, t(pos), t(dirs), 1.5, 0.1, 16)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[2].numpy(), np.float32(0.1) * 5)


def test_is_near_pos_occupy_and_is_occupy_fn(rooms, octos):
    """Radius 0 checks nothing (always False, the reference's quirk);
    radius 2 finds the wall next to a surface voxel and nothing at the
    room's centre. The JAX predicate is jitted, as its raycasts run it."""
    jm, tm = rooms
    jm.cvt_TSDF_surface_to_voxels()
    surf = jm.export_TSDF_xyz[:jm.num_TSDF_particles]
    jocc = jax.jit(jrc.make_tsdf_occupancy_fn(jm.cfg, jm.state,
                                              jnp.int32(0)))
    tocc = trc.make_tsdf_occupancy_fn(tm.cfg, tm.state, 0)
    pts = np.concatenate([surf[:40] + 0.05, np.zeros((1, 3)),
                          tie_points(0.1, 40, seed=7)]).astype(np.float32)
    for r in (0, 1, 2):
        want = np.asarray(jrc.is_near_pos_occupy(jocc, jnp.asarray(pts), 0.1,
                                                 r))
        got = trc.is_near_pos_occupy(tocc, t(pts), 0.1, r).numpy()
        np.testing.assert_array_equal(got, want)
        if r == 0:
            assert not got.any()
    assert got[:40].all() and not got[40]
    # the models' predicates on non-tie points (eager JAX divides)
    rnd = np.random.default_rng(8).uniform(-1.5, 1.5, (300, 3)).astype(
        np.float32)
    for j, p in ((jm, tm), octos):
        np.testing.assert_array_equal(
            p.is_occupy_fn()(t(rnd)).numpy(),
            np.asarray(j.is_occupy_fn()(jnp.asarray(rnd))))
