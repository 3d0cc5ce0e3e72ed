"""Optimizer (opti/transformations.py, opti/nnls.py, opti/ba_demo.py): the
PyTorch port against the JAX package.

The cases of tests/test_opti.py, each run through both packages: the
quaternion functions agree within 1e-6 (f32, the same formulas), the loss
and gradient of ``evaluate_test`` within rtol 1e-5, and the solvers'
results within 1e-4 (f32 sums in another order over 10-25 steps). The
bundle-adjustment demo's manifold gradient descent follows the JAX
example's loss curve within rtol 1e-4.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.opti import nnls as jn  # noqa: E402
from taichislam_tpu.opti import transformations as jtf  # noqa: E402
from taichislam_tpu_torch.opti import ba_demo  # noqa: E402
from taichislam_tpu_torch.opti import nnls as tn  # noqa: E402
from taichislam_tpu_torch.opti import transformations as ttf  # noqa: E402

CPU = torch.device("cpu")


def random_unit_quat(rng, n=1):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def test_quaternion_matrix_rotate_agree():
    rng = np.random.default_rng(0)
    q = random_unit_quat(rng, 8)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    R = ttf.quaternion_matrix(t(q))
    Rv = torch.einsum("bij,bj->bi", R, t(v))
    qv = ttf.quaternion_rotate(t(q), t(v))
    close(Rv, qv, 1e-5)
    close(R, jtf.quaternion_matrix(jnp.asarray(q)))
    close(qv, jtf.quaternion_rotate(jnp.asarray(q), jnp.asarray(v)))


def test_quaternion_multiply_inverse():
    rng = np.random.default_rng(1)
    q = random_unit_quat(rng, 4)
    ident = ttf.quaternion_multiply(t(q), ttf.quaternion_inverse(t(q)))
    close(ident[..., :3], 0)
    close(ident[..., 3].abs(), 1)
    close(ident, jtf.quaternion_multiply(
        jnp.asarray(q), jtf.quaternion_inverse(jnp.asarray(q))))
    close(ttf.quaternion_inverse(t(q)), jtf.quaternion_inverse(jnp.asarray(q)))


def test_retraction_small_angle():
    rng = np.random.default_rng(2)
    q = random_unit_quat(rng, 1)[0]
    d = np.float32([1e-3, -2e-3, 5e-4])
    q2 = ttf.quaternion_retraction(t(q), t(d))
    dq = ttf.quaternion_multiply(ttf.quaternion_inverse(t(q)), q2)
    close(dq[:3] * 2, d)
    assert abs(float(torch.linalg.norm(q2)) - 1) < 1e-6
    close(q2, jtf.quaternion_retraction(jnp.asarray(q), jnp.asarray(d)))


def test_plus_quaternion_jacobian_matches_autodiff():
    rng = np.random.default_rng(3)
    q = random_unit_quat(rng, 1)[0]
    J = ttf.plus_quaternion_jacobian(t(q))
    J_auto = torch.func.jacfwd(lambda d: ttf.quaternion_retraction(t(q), d))(
        torch.zeros(3))
    close(J, J_auto, 1e-5)
    close(J, jtf.plus_quaternion_jacobian(jnp.asarray(q)))
    close(J_auto, jax.jacobian(lambda d: jtf.quaternion_retraction(
        jnp.asarray(q), d))(jnp.zeros(3, jnp.float32)))


def test_quaternion_from_matrix_roundtrip():
    rng = np.random.default_rng(4)
    q = random_unit_quat(rng, 1)[0]
    R = ttf.quaternion_matrix_np(q)
    close(R, jtf.quaternion_matrix_np(q))
    assert R.dtype == np.float32
    q2 = ttf.quaternion_from_matrix(R)
    np.testing.assert_array_equal(q2, jtf.quaternion_from_matrix(R))
    if np.dot(q, q2) < 0:
        q2 = -q2
    close(q, q2, 1e-5)
    # every branch of Shepperd's method
    for qq in random_unit_quat(rng, 32):
        Rq = ttf.quaternion_matrix_np(qq)
        np.testing.assert_array_equal(ttf.quaternion_from_matrix(Rq),
                                      jtf.quaternion_from_matrix(Rq))


def _linear_fit(pkg):
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(50,)).astype(np.float32)
    ys = 2.0 * xs + 1.0
    if pkg is tn:
        xs_, ys_ = t(xs), t(ys)
        nnls = tn.NNLS(device="cpu")
    else:
        xs_, ys_ = xs, ys
        nnls = jn.NNLS()
    nnls.add_parameter_block("ab", np.zeros(2, np.float32))
    nnls.add_cost_function(pkg.CostFunction(
        lambda ab: ab[0] * xs_ + ab[1] - ys_, ["ab"]))
    return nnls


def test_nnls_solves_linear_fit():
    tnn, jnn = _linear_fit(tn), _linear_fit(jn)
    loss0, grad0 = tnn.evaluate_test()
    assert loss0 > 1.0 and np.linalg.norm(grad0) > 0
    jloss0, jgrad0 = jnn.evaluate_test()
    np.testing.assert_allclose(loss0, jloss0, rtol=1e-5)
    np.testing.assert_allclose(grad0, jgrad0, rtol=1e-5)
    out = tnn.solve_lm(iters=10)
    np.testing.assert_allclose(out["ab"], [2.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(out["ab"], jnn.solve_lm(iters=10)["ab"],
                               atol=1e-4)
    assert tnn.device == CPU and isinstance(out["ab"], np.ndarray)


def test_nnls_gradient_descent_matches_jax():
    tnn, jnn = _linear_fit(tn), _linear_fit(jn)
    got = tnn.solve(iters=100, lr=5e-3)["ab"]
    np.testing.assert_allclose(got, jnn.solve(iters=100, lr=5e-3)["ab"],
                               atol=1e-4)
    assert np.linalg.norm(got - [2.0, 1.0]) < 1.0


def _ba(pkg):
    """Mini bundle adjustment: a camera rotation from reprojected points
    (tests/test_opti.py's scene)."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, size=(30, 3)).astype(np.float32) + \
        np.array([0, 0, 4], np.float32)
    q_true = np.array([0.05, -0.03, 0.02, 1.0], np.float32)
    q_true /= np.linalg.norm(q_true)
    if pkg is tn:
        def project(q, p):
            p = ttf.quaternion_rotate(q.expand(p.shape[0], 4), p)
            return p[:, :2] / p[:, 2:3]
        P = t(pts)
        uv = project(t(q_true), P)
        nnls = tn.NNLS(device="cpu")
        norm = torch.linalg.norm
    else:
        def project(q, p):
            p = jtf.quaternion_rotate(jnp.broadcast_to(q, (p.shape[0], 4)),
                                      jnp.asarray(p))
            return p[:, :2] / p[:, 2:3]
        P = pts
        uv = np.asarray(project(jnp.asarray(q_true), pts))
        nnls = jn.NNLS()
        norm = jnp.linalg.norm
    nnls.add_parameter_block("q", np.array([0, 0, 0, 1], np.float32))
    nnls.add_cost_function(pkg.CostFunction(
        lambda q: (project(q / norm(q), P) - uv), ["q"]))
    return nnls, q_true


def test_nnls_reprojection_ba():
    (tnn, q_true), (jnn, _) = _ba(tn), _ba(jn)
    tl, tg = tnn.evaluate_test()
    jl, jg = jnn.evaluate_test()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
    out = tnn.solve_lm(iters=25)
    q_est = out["q"] / np.linalg.norm(out["q"])
    if np.dot(q_est, q_true) < 0:
        q_est = -q_est
    np.testing.assert_allclose(q_est, q_true, atol=1e-4)
    np.testing.assert_allclose(out["q"], jnn.solve_lm(iters=25)["q"],
                               atol=1e-4)


def test_ba_demo_follows_the_jax_example():
    """ba_demo's scene equals the JAX example's, and 40 steps of its
    manifold gradient descent follow the example's losses."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    try:
        import gradient_descent_BA as jba
    finally:
        sys.path.pop(0)
    qs, ts, pts, obs = ba_demo.make_scene(device="cpu")
    jqs, jts, jpts, jobs = jba.make_scene()
    np.testing.assert_array_equal(qs, jqs)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-6)
    q0, t0 = ba_demo.initial_guess(qs, ts, device="cpu")
    rng = np.random.default_rng(1)
    jq0 = jnp.asarray(jqs + rng.normal(scale=0.01, size=jqs.shape)
                      .astype(np.float32))
    jq0 = jq0 / jnp.linalg.norm(jq0, axis=-1, keepdims=True)
    jt0 = jnp.asarray(jts + rng.normal(scale=0.05, size=jts.shape)
                      .astype(np.float32))
    close(q0, jq0)
    close(t0, jt0)
    _, _, losses = ba_demo.gradient_descent(q0, t0, t(pts), obs, iters=40)
    _, _, jlosses = jba.gradient_descent(jq0, jt0, jnp.asarray(jpts), jobs,
                                         iters=40)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < 0.25 * losses[0]
