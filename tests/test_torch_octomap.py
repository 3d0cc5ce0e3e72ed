"""Occupancy (ops/occupancy.py, models/octomap.py): the PyTorch port against
the JAX package.

Hit counts are integer-valued f32, so every comparison is exact: block
tables, counts, colors (the last of several lanes that hit one voxel wins,
as in the JAX package's scatter on the CPU), LOD exports and the count
splat of submap fusion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.models.octomap import Octomap as JOcto  # noqa: E402
from taichislam_tpu.ops import occupancy as jo  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.models.octomap import Octomap as TOcto  # noqa: E402
from taichislam_tpu_torch.ops import occupancy as to  # noqa: E402

K_DEP = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
K_COL = np.array([44.0, 0, 30.0, 0, 43.0, 25.0, 0, 0, 1], np.float32)
OPTS = dict(map_scale=[6.4, 3.2], voxel_scale=0.1, min_occupy_thres=1,
            max_ray_length=2.0, min_ray_length=0.3, max_blocks=256,
            max_submap_num=8, max_disp_particles=65536)

# every port model here runs on the CPU, asked for explicitly (the models
# default to the CUDA card)
DEV = torch.device("cpu")


def _pair(**kw):
    o = dict(OPTS, **kw)
    jm, tm = JOcto(**o), TOcto(**o, device=DEV)
    for m in (jm, tm):
        m.set_dep_camera_intrinsic(K_DEP)
        m.set_color_camera_intrinsic(K_COL)
    return jm, tm


def _same_state(jstate, tstate):
    ts = bridge.grid_state_to_numpy(tstate)
    for name in ("table", "block_coords", "block_active", "num_blocks",
                 "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jstate, name)),
                                      getattr(ts, name), err_msg=name)
    assert jstate.channels.keys() == ts.channels.keys()
    for k, v in jstate.channels.items():
        np.testing.assert_array_equal(np.asarray(v), ts.channels[k],
                                      err_msg=k)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n):
        jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
        depth = (700 + 9 * f + 6.0 * ii + 3.0 * jj +
                 rng.integers(0, 40, (48, 64))).astype(np.uint16)
        depth[rng.random((48, 64)) < 0.05] = 0
        tex = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
        th = 0.3 * f
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th),
                                                     0], [0, 0, 1]],
                     np.float32)
        out.append((R, np.array([0.07 * f, -0.05, 0.02], np.float32), depth,
                    tex))
    return out


@pytest.mark.parametrize("same_proj", [True, False])
def test_integrate_depth_textured_matches_jax(same_proj):
    """Textured depth frames: many endpoints share a voxel, so the colors
    exercise the last-lane rule."""
    jm, tm = _pair(texture_enabled=True, color_same_proj=same_proj)
    for R, T, depth, tex in _frames(3):
        for m in (jm, tm):
            m.recast_depth_to_map(R, T, depth, tex)
    occ = np.asarray(jm.state.channels["occupy"])
    assert occ.max() >= 3 and int(jm.state.num_blocks) >= 3
    _same_state(jm.state, tm.state)


def test_integrate_pcl_duplicates_match_jax():
    """Point clouds with repeated points of different colors, and a second
    submap."""
    jm, tm = _pair(texture_enabled=True)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.2, 1.2, (600, 3)).astype(np.float32)
    pts = np.concatenate([pts, pts[:200], pts[:50]])
    rgb = rng.uniform(0, 255, (len(pts), 3)).astype(np.float32)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    for sub in (0, 1):
        for m in (jm, tm):
            m.active_submap_id = sub
            m.recast_pcl_to_map(R, np.array([0.13, -0.21, 0.07 * sub],
                                            np.float32), pts, rgb, len(pts))
    _same_state(jm.state, tm.state)


@pytest.mark.parametrize("level", [0, 1])
def test_occupy_export_matches_jax(level):
    jm, tm = _pair(texture_enabled=False, min_occupy_thres=0)
    for R, T, depth, _ in _frames(2, seed=5):
        for m in (jm, tm):
            m.recast_depth_to_map(R, T, depth, None)
    for m in (jm, tm):
        m.cvt_occupy_to_voxels(level)
    assert jm.num_export_particles == tm.num_export_particles > 0
    np.testing.assert_array_equal(jm.export_x, tm.export_x)
    np.testing.assert_array_equal(jm.export_color, tm.export_color)
    # the LOD lattice keeps fewer voxels than level 0
    if level:
        tm.cvt_occupy_to_voxels(0)
        assert tm.num_export_particles > jm.num_export_particles


@pytest.mark.parametrize("only", [None, 1], ids=["full", "only_submap"])
def test_fuse_submaps_matches_jax(only):
    """The count splat into a global map of another extent, through a
    rotated and a shifted base pose; textured, so colors overwrite."""
    jm, tm = _pair(texture_enabled=True, min_occupy_thres=0)
    for f, (R, T, depth, tex) in enumerate(_frames(3, seed=2)):
        for m in (jm, tm):
            m.active_submap_id = min(f, 1)
            m.recast_depth_to_map(R, T, depth, tex)
    gkw = dict(OPTS, map_scale=[12.8, 3.2], max_blocks=512,
               is_global_map=True, texture_enabled=True, min_occupy_thres=0)
    jg, tg = JOcto(**gkw), TOcto(**gkw, device=DEV)
    rng = np.random.default_rng(9)
    R1 = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    for g in (jg, tg):
        g.set_base_pose_submap(1, R1, np.array([0.37, -0.11, 0.05]))
        g.set_base_pose_submap(0, np.eye(3), np.array([0.2, 0.0, 0.0]))
    if only is None:
        for g in (jg, tg):
            g.fuse_submaps(jm if g is jg else tm)
    else:
        jg.fuse_submaps_incremental(jm, only)
        tg.fuse_submaps_incremental(tm, only)
    assert int(jg.state.num_blocks) >= 3
    _same_state(jg.state, tg.state)


def test_octomap_state_bridge_round_trip():
    jm, tm = _pair(texture_enabled=True)
    R, T, depth, tex = _frames(1)[0]
    jm.recast_depth_to_map(R, T, depth, tex)
    ts = bridge.octomap_state_from_numpy(jm.state, device="cpu")
    back = bridge.grid_state_to_numpy(ts)
    _same_state(jm.state, ts)
    for k, v in back.channels.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(jm.state.channels[k]), v)
    with pytest.raises(TypeError):
        bridge.octomap_state_from_numpy(back._replace(channels={
            "occupy": back.channels["occupy"].astype(np.int8)}), device="cpu")


def test_octomap_config_matches_jax():
    """K**R tree sizing, re-derived voxel scale, block-size halving."""
    from taichislam_tpu.core.config import OctomapConfig as JC
    from taichislam_tpu_torch.core.config import OctomapConfig as TC
    for kw in (dict(map_scale=(100, 10), voxel_scale=0.05),
               dict(map_scale=(6.4, 3.2), voxel_scale=0.1),
               dict(map_scale=(10, 1.0), voxel_scale=0.05, K=3),
               dict(map_scale=(3.0, 0.2), voxel_scale=0.05)):
        j, t = JC(**kw), TC(**kw)
        for k in ("Rxy", "Rz", "N", "Nz", "voxel_scale"):
            assert getattr(j, k) == getattr(t, k), (kw, k)
        for k in ("N", "Nz", "bn_xy", "bn_z", "num_voxel_per_blk_axis",
                  "voxel_scale", "map_size_xy", "map_size_z"):
            assert getattr(j.grid, k) == getattr(t.grid, k), (kw, k)


def test_scatter_hits_functional_matches_jax():
    """The op layer directly: integrate_pcl on a state from the bridge."""
    jm, _ = _pair(texture_enabled=True)
    rng = np.random.default_rng(4)
    xyz = np.round(rng.uniform(-1, 1, (500, 3)), 1).astype(np.float32)
    rgb = rng.uniform(0, 255, (500, 3)).astype(np.float32)
    R, T = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    want = jo.integrate_pcl(jm.cfg, jo.make_octomap_state(jm.cfg),
                            jnp.asarray(xyz), jnp.asarray(rgb),
                            jnp.asarray(R), jnp.asarray(T), jnp.int32(2))
    from taichislam_tpu_torch.core.config import OctomapConfig
    cfg = OctomapConfig(**{k: getattr(jm.cfg, k) for k in (
        "map_scale", "min_occupy_thres", "texture_enabled", "max_blocks",
        "max_submap_num", "K")}, voxel_scale=0.1)
    got = to.integrate_pcl(cfg, to.make_octomap_state(cfg, device="cpu"),
                           torch.from_numpy(xyz), torch.from_numpy(rgb),
                           torch.from_numpy(R), torch.from_numpy(T), 2)
    _same_state(want, got)
