"""Sharded ESDF: the port against the JAX package's
``parallel/sharded_esdf.py`` and against the port's single-device update.

JAX integrates the scene of tests/test_parallel.py (with 32 slots, so
4 ranks hold 8 rows each and the dirty set spans two) on a mesh of n of the 8
virtual CPU devices and runs its sharded update there (its XLA sweep body,
the CPU mesh's default). The port takes each frame's JAX map, field, flags
and dirty bitmap across with the bridge, on n gloo ranks (one in this
process, or 4 spawned), and runs its sharded update (K2's twin on each
rank's rows). Field, fixed flags, observed mask, sweep count, re-queue
bitmap and overflow are exact against JAX, and exact against the port's
single-device ``esdf_update`` (K3's twin) on the same inputs — at 2 frames
incrementally with a dirty set that spans shards, in full mode, and at a
cap that overflows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu.parallel import block_sharded as jbs  # noqa: E402
from taichislam_tpu.parallel import sharded_esdf as jse  # noqa: E402
from taichislam_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402
from taichislam_tpu_torch.parallel import mesh as pm  # noqa: E402

KW = dict(map_scale=(3.2, 3.2), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=1.5, min_ray_length=0.3, recast_step=2,
          max_blocks=31, max_bins=1024, max_submap_num=4)
NB, V3 = 32, 512
SWEEPS = 16


def _jax(n, incremental, cap):
    """JAX's frames: per update its inputs (the carried steps) and its
    outputs."""
    cfg = JConfig(**KW)
    mesh = jax_mesh(n, "block")
    sh = jse.esdf_sharding(mesh, "block")
    state = jbs.shard_state(jt.make_tsdf_state(cfg), mesh, "block")
    e = jax.device_put(jnp.zeros((NB, V3), jnp.float32), sh)
    f = jax.device_put(jnp.zeros((NB, V3), jnp.int8), sh)
    pending = jnp.zeros((NB,), bool)
    istep = jbs.sharded_integrate_depth(cfg, mesh, "block")
    estep = jse.sharded_esdf_update(cfg, SWEEPS, cap, mesh, incremental)
    K = jnp.asarray(workers.K)
    rng = np.random.default_rng(1 if incremental else 2)
    Ts = ([[0.0, 0.0, 0.0], [0.15, 0.1, 0.0]] if incremental
          else [[0.0, 0.0, 0.0]])
    steps, outs = [], []
    for T in Ts:
        depth = jnp.asarray(rng.integers(400, 1400, size=(24, 32))
                            .astype(np.uint16))
        state, touched = istep(state, depth, jnp.zeros((1, 1, 3), jnp.uint8),
                               jnp.eye(3, dtype=jnp.float32),
                               jnp.asarray(T, jnp.float32), K, K,
                               jnp.int32(0))
        st_np = bridge.grid_state_to_numpy(bridge.grid_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, state), device="cpu"))
        dirty = touched | pending if incremental else None
        steps.append((st_np, np.asarray(e), np.asarray(f),
                      None if dirty is None else np.asarray(dirty)))
        args = (state, e, f, jnp.int32(0)) + ((dirty,) if incremental
                                              else ())
        e, f, obs, sw, changed, ov = estep(*args)
        pending = changed
        outs.append(dict(esdf=np.asarray(e), fixed=np.asarray(f),
                         obs=np.asarray(obs), sweeps=int(sw),
                         changed=np.asarray(changed), overflow=int(ov)))
    return steps, outs


def _single_device(cap, steps, incremental):
    """The port's single-device update on the same carried inputs."""
    cfg = TConfig(**KW)
    outs = []
    for st_np, e, f, dirty in steps:
        st = bridge.grid_state_from_numpy(st_np, device="cpu")
        res = te.esdf_update(cfg, SWEEPS, cap, st, torch.from_numpy(e.copy()),
                             torch.from_numpy(f.copy()), 0,
                             None if dirty is None else
                             torch.from_numpy(dirty.copy()))
        e2, f2, obs, sw, ch, ov = res
        outs.append(dict(esdf=e2.numpy(), fixed=f2.numpy(), obs=obs.numpy(),
                         sweeps=int(sw), changed=ch.numpy(),
                         overflow=int(ov)))
    return outs


def _assert_same(want, got):
    for w, g in zip(want, got):
        assert g["sweeps"] == w["sweeps"] > 0
        assert g["overflow"] == w["overflow"]
        for k in ("esdf", "fixed", "obs", "changed"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


CASES = [(1, True, 64), (1, False, 64), (1, True, 8), (4, True, 64),
         (4, False, 64)]


@pytest.mark.parametrize("n,incremental,cap", CASES)
def test_sharded_esdf_matches_jax_and_single_device(n, incremental, cap,
                                                    tmp_path):
    steps, want = _jax(n, incremental, cap)
    args = (KW, steps, SWEEPS, cap, incremental)
    if n == 1:
        res = [workers.sharded_esdf(pm.make_mesh(1, "block", device="cpu"),
                                    *args)]
    else:
        res = pm.spawn_mesh(workers.sharded_esdf, n, backend="gloo",
                            device="cpu", args=args, axis="block",
                            store_dir=tmp_path)
    for got in res:                        # every rank gathers the same
        _assert_same(want, got)
        for g in got:
            assert g["overflow_pre"] == g["overflow"]
    _assert_same(_single_device(cap, steps, incremental), res[0])
    if cap == 8:
        assert all(w["overflow"] > 0 for w in want)
    if incremental:
        # the second frame's dirty working set spans shard boundaries
        # (rows of 8 slots per rank at n = 4), so the halo exchange
        # crosses ranks
        assert len(set(np.nonzero(steps[-1][3])[0] // (NB // 4))) >= 2
        # the distance field is non-trivial past the fixed band
        e, fx = want[-1]["esdf"], want[-1]["fixed"]
        assert np.any(np.abs(e[fx == 0]) > KW["voxel_scale"])
