"""The port's mesh: one rank of a torch.distributed group per JAX device.

One rank runs in this process (``make_mesh(1)`` starts a one-rank gloo
group); 2 and 4 ranks are spawned on the CPU with gloo, each test over a
FileStore of its own. The collectives are held against the JAX ones on a
mesh of the same size from the 8 virtual CPU devices (tests/conftest.py):
the tiled all_gather, psum and the psum-OR.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from taichislam_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from taichislam_tpu_torch.parallel import mesh as pm  # noqa: E402


def _jax_collectives(n):
    """The JAX side of workers.collectives on an n-device mesh."""
    mesh = jax_mesh(n, "drone")
    x = jnp.stack([jnp.arange(3, dtype=jnp.float32) + 10 * r
                   for r in range(n)])                       # (n, 3)
    b = jnp.stack([jnp.array([r == 0, r == 1, False]) for r in range(n)])

    def local(x, b):
        g = jax.lax.all_gather(x.reshape(3, 1), "drone", axis=0, tiled=True)
        s = jax.lax.psum(x, "drone")
        a = jax.lax.psum(b.astype(jnp.int32), "drone") > 0
        return g[None], s, a[None]
    g, s, a = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("drone"),
                                                            P("drone")),
                                out_specs=(P("drone"), P(), P("drone")),
                                check_vma=False))(x, b)
    return np.asarray(g), np.asarray(s).reshape(-1), np.asarray(a)


def _check(res, n):
    g, s, a = _jax_collectives(n)
    assert [r["rank"] for r in res] == list(range(n))
    for r, out in enumerate(res):
        assert out["size"] == n
        np.testing.assert_array_equal(out["gather"], g[r])
        np.testing.assert_array_equal(out["psum"], s)
        np.testing.assert_array_equal(out["any"], a[r].reshape(-1))
        assert out["gather_b"].dtype == np.bool_
        np.testing.assert_array_equal(
            out["gather_b"], np.concatenate(
                [[q == 0, q == 1, False] for q in range(n)]))
        assert out["gather_i8"].dtype == np.int8
        np.testing.assert_array_equal(
            out["gather_i8"], np.repeat(np.arange(1, n + 1, dtype=np.int8),
                                        2)[:, None].repeat(2, 1))
        np.testing.assert_array_equal(
            out["psum_i8"], np.full((2, 2), n * (n + 1) // 2, np.int8))


def test_one_rank_in_process():
    mesh = pm.make_mesh(1, "drone", device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis, mesh.backend) == \
        (1, 0, "drone", "gloo")
    assert mesh.device == torch.device("cpu")
    _check([workers.collectives(mesh)], 1)


@pytest.mark.parametrize("n", [2, 4])
def test_spawned_ranks_match_jax(n, tmp_path):
    res = pm.spawn_mesh(workers.collectives, n, backend="gloo", device="cpu",
                        store_dir=tmp_path)
    _check(res, n)


def test_failed_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="mesh ranks failed"):
        pm.spawn_mesh(workers.fail_on_rank, 2, backend="gloo", device="cpu",
                      args=(1,), store_dir=tmp_path, timeout_s=120)


def test_make_mesh_checks_its_arguments():
    pm.make_mesh(1, "block", device="cpu")       # the in-process group
    with pytest.raises(ValueError, match="every rank"):
        pm.make_mesh(2, "block", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pm.make_mesh(1, "block", device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="backend"):
        pm.spawn_mesh(workers.mesh_device, 1, backend="mpi", device="cpu")
    assert pm.default_backend("cpu") == "gloo"
    assert pm.default_backend("cuda:0") == "nccl"
    assert pm._rank_device("cuda", "nccl", 3) == torch.device("cuda", 3)
    assert pm._rank_device("cuda:0", "gloo", 3) == torch.device("cuda", 0)
