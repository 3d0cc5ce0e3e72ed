"""Multi-drone SPMD mapping: the port against the JAX package's
``parallel/multi_drone.py``.

The scenes are those of tests/test_parallel.py (SUB/GLOB configurations,
24x32 depth from numpy seeds), with 4 drones: JAX on a 4-device mesh of
the 8 virtual CPU devices, the port on 4 spawned gloo ranks, one drone
each. The drones integrate through the single-device integrate, whose K1
route rounds march values to f16 in the port, so JAX takes
``pallas_accum="on"`` (its Pallas accumulation in interpret mode, inside
shard_map), as tests/test_torch_tsdf.py does. ``multi_drone_step`` and
``multi_drone_fuse`` run on the JAX mesh; the lifecycle is held against
the JAX single-device host chain of each drone, which tests/test_parallel.py
holds bit for bit to ``multi_drone_lifecycle_step`` (a second lifecycle
step built in one process fails its second call with a sharding error,
so the JAX step itself is not driven here).

Bounds, those of the integrate and node parity tests: tables, block
counts, observed flags, triangle counts and the lifecycle registry exact;
TSDF within 2e-3; W within rtol 2e-3 / atol 1e-3; the ESDF within 4e-3 and
mesh vertices within 1e-3 m. The fused global map as tests/test_parallel.py
checks it: block count and observed count exact, TSDF sum within rtol
1e-4. Separately, each rank's drone equals the same drone run alone
through the port's single-device ops, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import esdf as je  # noqa: E402
from taichislam_tpu.ops import marching_cubes as jmc  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu.parallel import multi_drone as jmd  # noqa: E402
from taichislam_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402
from taichislam_tpu_torch.ops import marching_cubes as tmc  # noqa: E402
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402
from taichislam_tpu_torch.parallel import mesh as pm  # noqa: E402
from taichislam_tpu_torch.parallel.multi_drone import (  # noqa: E402
    lifecycle_pose, make_lifecycle_states)

SUB = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
           max_ray_length=1.5, min_ray_length=0.3, recast_step=2,
           max_blocks=64, max_bins=1024, max_submap_num=4)
GLOB = dict(map_scale=(6.4, 6.4), voxel_scale=0.1, num_voxel_per_blk_axis=8,
            max_ray_length=1.5, max_blocks=128, max_submap_num=1,
            is_global_map=True)
N = 4


def _jcfg(kw):
    return JConfig(pallas_accum="on", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state(j, p, exact=False):
    for name in ("table", "block_coords", "block_active", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(p, name), err_msg=name)
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(j.channels[name]),
                                      p.channels[name], err_msg=name)
    a, b = np.asarray(j.channels["TSDF"]), p.channels["TSDF"]
    w1, w2 = np.asarray(j.channels["W_TSDF"]), p.channels["W_TSDF"]
    if exact:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(w1, w2)
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-3)
        np.testing.assert_allclose(w2, w1, rtol=2e-3, atol=1e-3)


def _assert_fused(j, p):
    assert int(np.asarray(j.num_blocks)) == int(p.num_blocks) > 0
    np.testing.assert_array_equal(np.asarray(j.table), p.table)
    assert int((np.asarray(j.channels["TSDF_observed"]) > 0).sum()) == \
        int((p.channels["TSDF_observed"] > 0).sum())
    want = np.asarray(j.channels["TSDF"], np.float64).sum()
    np.testing.assert_allclose(p.channels["TSDF"].astype(np.float64).sum(),
                               want, rtol=1e-4)


def _spawn(tmp_path, fn, *args):
    return pm.spawn_mesh(fn, N, backend="gloo", device="cpu", args=args,
                         axis="drone", store_dir=tmp_path)


def test_step_matches_jax(tmp_path):
    """multi_drone_step: each drone integrates, all drones fuse."""
    rng = np.random.default_rng(0)
    depth = rng.integers(400, 1400, size=(N, 24, 32)).astype(np.uint16)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (N, 3, 3)).copy()
    T = np.linspace(0, 0.5, 3 * N, dtype=np.float32).reshape(N, 3)
    bR = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    bT = np.zeros((4, 3), np.float32)

    mesh = jax_mesh(N, "drone")
    sub, glob = _jcfg(SUB), _jcfg(GLOB)
    dstates, g = jmd.multi_drone_step(sub, glob, 64, mesh)(
        jmd.make_drone_states(sub, N), jt.make_tsdf_state(glob),
        jnp.asarray(depth), jnp.asarray(R), jnp.asarray(T),
        jnp.asarray(workers.K),
        jnp.asarray(bR), jnp.asarray(bT))
    dstates, g = _np(dstates), _np(g)

    res = _spawn(tmp_path, workers.drone_step, SUB, GLOB, depth, R, T, bR,
                 bT, 64)
    for d, r in enumerate(res):
        _assert_state(jax.tree_util.tree_map(lambda x: x[d], dstates),
                      r["state"])
        _assert_fused(g, r["glob"])
        _assert_state(res[0]["glob"], r["glob"], exact=True)


def _lifecycle_frames(seed, F, rotate):
    rng = np.random.default_rng(seed)
    depths = rng.integers(500, 1300, size=(F, N, 24, 32)).astype(np.uint16)
    Rs = np.zeros((F, N, 3, 3), np.float32)
    Ts = np.zeros((F, N, 3), np.float32)
    for f in range(F):
        for d in range(N):
            a = 0.05 * f + 0.02 * d if rotate else 0.0
            Rs[f, d] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]]
            Ts[f, d] = [0.1 * f, 0.05 * d, 0.0] if rotate else \
                [0.08 * f, 0.05 * d, 0.0]
    return depths, Rs, Ts


def _jax_lifecycle(frames, kstep, sweeps, cap, triangles, bcap, fuse):
    """Each drone through the JAX single-device host chain of its
    lifecycle step (keyframe policy, base-pose registry, world -> submap
    pose, integrate, ESDF, mesh patch), which tests/test_parallel.py holds
    bit for bit to ``multi_drone_lifecycle_step``; then the JAX
    ``multi_drone_fuse`` over the stacked drones on the 4-device mesh."""
    depths, Rs, Ts = frames
    sub = _jcfg(SUB)
    S = sub.max_submap_num
    nb, V3 = sub.grid.max_blocks + 1, sub.grid.voxels_per_block
    K = jnp.asarray(workers.K)
    tex = jnp.zeros((1, 1, 3), jnp.uint8)
    drones = []
    for d in range(N):
        st = jt.make_tsdf_state(sub)
        bR = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
        bT = np.zeros((S, 3), np.float32)
        e = jnp.zeros((nb, V3), jnp.float32)
        fx = jnp.zeros((nb, V3), jnp.int8)
        pending = jnp.zeros((nb,), bool)
        act = 0
        for f in range(len(depths)):
            new = f == 0 or f % kstep == 0
            act = min(act + 1 if new and f > 0 else act, S - 1)
            if new:
                bR[act], bT[act] = Rs[f][d], Ts[f][d]
            st, stats = jt.integrate_depth(
                sub, st, jnp.asarray(depths[f][d]), tex,
                jnp.asarray(bR[act].T @ Rs[f][d]),
                jnp.asarray(bR[act].T @ (Ts[f][d] - bT[act])), K, K,
                jnp.int32(act))
            if sweeps:
                dirty = stats["touched_blocks"] | pending
                e, fx, _, sw, ch, ov = je.esdf_update(
                    sub, sweeps, cap, st, e, fx, jnp.int32(act), dirty)
                pending = jnp.where(ov > 0, ch | dirty, ch)
        one = dict(state=st, active=act, base_R=bR, base_T=bT, esdf=e,
                   fixed=fx, pending=pending)
        if triangles:
            dil = jmc.dilate_blocks(sub, st, jnp.int32(act),
                                    stats["touched_blocks"])
            m = jmc.extract_mesh(sub, triangles, 1, bcap, st, jnp.int32(act),
                                 jnp.float32(sub.tsdf_surface_thres),
                                 block_mask=dil)
            one["counts"] = np.asarray([
                int(m["num_triangles"]), int(m["surface_blocks_dropped"]),
                max(int(m["total_triangles"]) - int(m["num_triangles"]), 0)])
            one["vertices"] = np.asarray(m["vertices"])
        drones.append(_np(one))
    g = None
    if fuse:
        mesh = jax_mesh(N, "drone")
        sh = NamedSharding(mesh, P("drone"))
        keys = ["state", "active", "fcount", "base_R", "base_T"]
        life = {k: jax.tree_util.tree_map(
            lambda *x: jax.device_put(np.stack(x), sh),
            *[dict(drones[d], fcount=len(depths))[k] for d in range(N)])
            for k in keys}
        life["active"] = jax.device_put(
            np.asarray([dr["active"] for dr in drones], np.int32), sh)
        life["fcount"] = jax.device_put(np.full((N,), len(depths),
                                                np.int32), sh)
        g = _np(jmd.multi_drone_fuse(sub, _jcfg(GLOB), fuse, mesh)(
            life, jt.make_tsdf_state(_jcfg(GLOB))))
    return drones, g


def _sequential(d, frames, kstep, sweeps, cap, triangles, bcap):
    """Drone ``d`` alone through the port's single-device ops."""
    depths, Rs, Ts = frames
    cfg = TConfig(**SUB)
    life = make_lifecycle_states(cfg, with_esdf=bool(sweeps), device="cpu")
    st = life["state"]
    Kt = torch.from_numpy(workers.K)
    tex = torch.zeros((1, 1, 3), dtype=torch.uint8)
    for f in range(len(depths)):
        act, R_in, T_in = lifecycle_pose(life, kstep, cfg.max_submap_num,
                                         Rs[f][d], Ts[f][d], True)
        st, stats = tt.integrate_depth(
            cfg, st, torch.from_numpy(depths[f][d].astype(np.int32)), tex,
            torch.from_numpy(R_in), torch.from_numpy(T_in), Kt, Kt, act)
        if sweeps:
            dirty = stats["touched_blocks"] | life["pending"]
            e, fx, _, sw, ch, ov = te.esdf_update(cfg, sweeps, cap, st,
                                                  life["esdf"], life["fixed"],
                                                  act, dirty)
            life["pending"] = torch.where(ov > 0, ch | dirty, ch)
            life["esdf_stats"] = torch.stack([sw.to(torch.int32),
                                              ov.to(torch.int32)])
    out = dict(state=st, life=life)
    if triangles:
        dil = tmc.dilate_blocks(cfg, st, act, stats["touched_blocks"])
        out["mesh"] = tmc.extract_mesh(cfg, triangles, 1, bcap, st, act,
                                       cfg.tsdf_surface_thres,
                                       block_mask=dil)
    return out


def _assert_rank_is_sequential(r, s):
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(getattr(r["state"], name),
                                      getattr(s["state"], name).numpy())
    for k, v in s["state"].channels.items():
        np.testing.assert_array_equal(r["state"].channels[k], v.numpy(),
                                      err_msg=k)
    life = s["life"]
    assert (r["active"], r["fcount"]) == (life["active"], life["fcount"])
    for k in ("esdf", "fixed", "pending", "esdf_stats"):
        if k in r:
            np.testing.assert_array_equal(r[k], life[k].numpy(), err_msg=k)
    if "vertices" in r:
        nt = int(s["mesh"]["num_triangles"])
        assert int(r["counts"][0]) == nt > 0
        np.testing.assert_array_equal(r["vertices"],
                                      s["mesh"]["vertices"].numpy())


def _sorted_rows(v):
    return v[np.lexsort(v.T[::-1])]


def test_lifecycle_esdf_matches_jax(tmp_path):
    """Lifecycle with each drone's ESDF (budget 6): tests/test_parallel.py
    :363-431's scene."""
    frames = _lifecycle_frames(7, 3, rotate=False)
    args = (10, 6, 64, 0, 32, 0)
    jax_d, _ = _jax_lifecycle(frames, *args)
    res = _spawn(tmp_path, workers.drone_lifecycle, SUB, GLOB, *frames,
                 *args)
    for d, r in enumerate(res):
        _assert_state(jax_d[d]["state"], r["state"])
        assert np.all(r["esdf_stats"][0] > 0) and r["esdf_stats"][1] == 0
        obs = r["state"].channels["TSDF_observed"] > 0
        np.testing.assert_allclose(r["esdf"][obs], jax_d[d]["esdf"][obs],
                                   rtol=0, atol=4e-3)
        np.testing.assert_array_equal(r["fixed"], jax_d[d]["fixed"])
        np.testing.assert_array_equal(r["pending"], jax_d[d]["pending"])
        prop = r["esdf"][r["fixed"] == 0]
        assert np.any(np.abs(prop) > SUB["voxel_scale"])
        _assert_rank_is_sequential(r, _sequential(d, frames, 10, 6, 64, 0,
                                                  32))


def test_lifecycle_mesh_matches_jax(tmp_path):
    """Lifecycle with each drone's mesh patch: :622-683's scene."""
    frames = _lifecycle_frames(9, 2, rotate=False)
    args = (10, 6, 64, 4096, 32, 0)
    jax_d, _ = _jax_lifecycle(frames, *args)
    res = _spawn(tmp_path, workers.drone_lifecycle, SUB, GLOB, *frames,
                 *args)
    for d, r in enumerate(res):
        nt = int(jax_d[d]["counts"][0])
        np.testing.assert_array_equal(r["counts"], jax_d[d]["counts"])
        assert nt > 0 and not r["counts"][1:].any()
        np.testing.assert_allclose(
            _sorted_rows(r["vertices"][:nt * 3]),
            _sorted_rows(jax_d[d]["vertices"][:nt * 3]), rtol=0, atol=1e-3)
        _assert_rank_is_sequential(r, _sequential(d, frames, 10, 6, 64,
                                                  4096, 32))


def test_lifecycle_registry_and_fuse_match_jax(tmp_path):
    """Keyframe switching, base-pose registries and the all-drone fuse:
    :434-533's scene at 4 drones."""
    frames = _lifecycle_frames(3, 5, rotate=True)
    args = (2, 0, 64, 0, 32, 64)
    jax_d, g = _jax_lifecycle(frames, *args)
    res = _spawn(tmp_path, workers.drone_lifecycle, SUB, GLOB, *frames,
                 *args)
    for d, r in enumerate(res):
        assert r["active"] == int(jax_d[d]["active"]) == 2
        np.testing.assert_array_equal(r["base_R"], jax_d[d]["base_R"])
        np.testing.assert_array_equal(r["base_T"], jax_d[d]["base_T"])
        _assert_state(jax_d[d]["state"], r["state"])
        _assert_fused(g, r["glob"])
        _assert_state(res[0]["glob"], r["glob"], exact=True)
        _assert_rank_is_sequential(r, _sequential(d, frames, 2, 0, 64, 0,
                                                  32))
