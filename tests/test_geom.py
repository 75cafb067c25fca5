"""Unit tests for the SO3/SE3 core vs finite differences and scipy-free
closed-form identities."""

import numpy as np
import jax
import jax.numpy as jnp

import isvins_tpu  # noqa: F401  (enables x64)
from isvins_tpu.geom import (
    g2R,
    left_jacobian_so3,
    mat_to_quat,
    mat_to_ypr,
    quat_conj,
    quat_log,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    right_jacobian_inv_so3,
    right_jacobian_so3,
    se3_adjoint,
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
    se3_relative,
    skew,
    so3_exp_mat,
    so3_exp_quat,
    so3_log_mat,
    ypr_to_mat,
)

from conftest import random_quat


def test_quat_mat_roundtrip(rng):
    q = random_quat(rng, 64)
    R = quat_to_mat(jnp.asarray(q))
    q2 = mat_to_quat(R)
    np.testing.assert_allclose(np.abs(np.sum(np.asarray(q2) * q, axis=-1)), 1.0, atol=1e-12)
    # rotation property
    np.testing.assert_allclose(
        np.asarray(R @ jnp.swapaxes(R, -1, -2)), np.broadcast_to(np.eye(3), R.shape), atol=1e-12
    )


def test_quat_rotate_matches_matrix(rng):
    q = jnp.asarray(random_quat(rng, 32))
    v = jnp.asarray(rng.normal(size=(32, 3)))
    np.testing.assert_allclose(
        np.asarray(quat_rotate(q, v)),
        np.asarray(jnp.einsum("nij,nj->ni", quat_to_mat(q), v)),
        atol=1e-12,
    )


def test_exp_log_roundtrip(rng):
    phi = rng.normal(size=(64, 3))
    # log returns the principal branch; keep |phi| < pi for exact roundtrip
    phi = phi / np.maximum(np.linalg.norm(phi, axis=-1, keepdims=True), 1e-9) * rng.uniform(
        0, 3.0, size=(64, 1)
    )
    phi[0] = 0.0
    phi[1] = [1e-10, 0, 0]
    phi = jnp.asarray(phi)
    np.testing.assert_allclose(np.asarray(quat_log(so3_exp_quat(phi))), np.asarray(phi), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(so3_log_mat(so3_exp_mat(phi))), np.asarray(phi), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(so3_exp_mat(phi)), np.asarray(quat_to_mat(so3_exp_quat(phi))), atol=1e-12
    )


def test_right_jacobian_definition(rng):
    """Exp(phi + J_r(phi) d) ≈ Exp(phi) Exp(d) to first order — checked via FD."""
    phi = jnp.asarray(rng.normal(size=3))
    d = jnp.asarray(rng.normal(size=3)) * 1e-6
    Jr = right_jacobian_so3(phi)
    # Exp(phi + d) ≈ Exp(phi) · Exp(Jr(phi) d)
    lhs = so3_exp_mat(phi + d)
    rhs = so3_exp_mat(phi) @ so3_exp_mat(Jr @ d)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-10)
    # inverse consistency
    np.testing.assert_allclose(
        np.asarray(right_jacobian_inv_so3(phi) @ Jr), np.eye(3), atol=1e-9
    )
    # small-angle branch
    np.testing.assert_allclose(np.asarray(right_jacobian_so3(jnp.zeros(3))), np.eye(3), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(right_jacobian_inv_so3(jnp.zeros(3))), np.eye(3), atol=1e-12
    )


def test_left_jacobian(rng):
    phi = jnp.asarray(rng.normal(size=3))
    np.testing.assert_allclose(
        np.asarray(left_jacobian_so3(phi)),
        np.asarray(quat_to_mat(so3_exp_quat(phi)) @ right_jacobian_so3(phi)),
        atol=1e-10,
    )


def test_ypr_roundtrip(rng):
    ypr = jnp.asarray([[30.0, 20.0, -40.0], [0.0, 0.0, 0.0], [-120.0, 10.0, 5.0]])
    np.testing.assert_allclose(np.asarray(mat_to_ypr(ypr_to_mat(ypr))), np.asarray(ypr), atol=1e-9)


def test_g2R(rng):
    g = jnp.asarray([0.1, -0.2, 9.7])
    R0 = g2R(g)
    aligned = R0 @ (g / jnp.linalg.norm(g))
    np.testing.assert_allclose(np.asarray(aligned), [0, 0, 1], atol=1e-10)
    assert abs(float(mat_to_ypr(R0)[0])) < 1e-8


def test_se3_ops(rng):
    p1, q1 = jnp.asarray(rng.normal(size=3)), jnp.asarray(random_quat(rng))
    p2, q2 = jnp.asarray(rng.normal(size=3)), jnp.asarray(random_quat(rng))
    pc, qc = se3_compose(p1, q1, p2, q2)
    pi, qi = se3_inverse(p1, q1)
    pr, qr = se3_relative(p1, q1, pc, qc)
    np.testing.assert_allclose(np.asarray(pr), np.asarray(p2), atol=1e-12)
    assert abs(float(jnp.abs(jnp.sum(qr * q2)) - 1.0)) < 1e-12
    # compose(T, T^-1) = identity
    pid, qid = se3_compose(p1, q1, pi, qi)
    np.testing.assert_allclose(np.asarray(pid), 0.0, atol=1e-12)

    xi = se3_log(p1, q1)
    pe, qe = se3_exp(xi)
    np.testing.assert_allclose(np.asarray(pe), np.asarray(p1), atol=1e-10)
    assert abs(float(jnp.abs(jnp.sum(qe * q1)) - 1.0)) < 1e-10


def test_se3_adjoint(rng):
    """Adj(T) xi == log(T Exp(xi) T^{-1}) to first order."""
    p, q = jnp.asarray(rng.normal(size=3)), jnp.asarray(random_quat(rng))
    xi = jnp.asarray(rng.normal(size=6)) * 1e-6
    Adj = se3_adjoint(p, q)
    pe, qe = se3_exp(xi)
    pa, qa = se3_compose(*se3_compose(p, q, pe, qe), *se3_inverse(p, q))
    np.testing.assert_allclose(np.asarray(se3_log(pa, qa)), np.asarray(Adj @ xi), rtol=1e-4, atol=1e-14)


def test_jittable_and_gradable():
    f = jax.jit(lambda phi: jnp.sum(so3_exp_mat(phi)))
    g = jax.grad(f)(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g)))
    g2 = jax.grad(lambda phi: jnp.sum(quat_log(so3_exp_quat(phi))))(jnp.zeros(3) + 1e-12)
    assert np.all(np.isfinite(np.asarray(g2)))


def test_hostmath_numpy_twins_match_jnp():
    """geom.hostmath numpy twins must agree with the jnp implementations
    (the host state machine uses them to avoid per-call device dispatch)."""
    import numpy as np
    import jax.numpy as jnp
    from isvins_tpu import geom
    from isvins_tpu.geom import hostmath as hm

    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4); q /= np.linalg.norm(q)
        p = rng.normal(size=4); p /= np.linalg.norm(p)
        v = rng.normal(size=3)
        phi = rng.normal(size=3) * rng.choice([1e-14, 0.1, 2.0])
        np.testing.assert_allclose(hm.quat_mul_np(q, p), np.asarray(geom.quat_mul(jnp.asarray(q), jnp.asarray(p))), atol=1e-12)
        np.testing.assert_allclose(hm.quat_to_mat_np(q), np.asarray(geom.quat_to_mat(jnp.asarray(q))), atol=1e-12)
        np.testing.assert_allclose(hm.quat_rotate_np(q, v), np.asarray(geom.quat_rotate(jnp.asarray(q), jnp.asarray(v))), atol=1e-12)
        np.testing.assert_allclose(hm.so3_exp_quat_np(phi), np.asarray(geom.so3_exp_quat(jnp.asarray(phi))), atol=1e-9)
        R = hm.quat_to_mat_np(q)
        q2 = hm.mat_to_quat_np(R)
        qj = np.asarray(geom.mat_to_quat(jnp.asarray(R)))
        if qj[0] < 0: qj = -qj
        np.testing.assert_allclose(q2, qj, atol=1e-9)
        np.testing.assert_allclose(hm.mat_to_ypr_np(R), np.asarray(geom.mat_to_ypr(jnp.asarray(R))), atol=1e-9)
        ypr = hm.mat_to_ypr_np(R)
        np.testing.assert_allclose(hm.ypr_to_mat_np(ypr), np.asarray(geom.ypr_to_mat(jnp.asarray(ypr))), atol=1e-9)
        t1 = rng.normal(size=3); t2 = rng.normal(size=3)
        pn, qn = hm.se3_compose_np(t1, q, t2, p)
        pj, qj2 = geom.se3_compose(jnp.asarray(t1), jnp.asarray(q), jnp.asarray(t2), jnp.asarray(p))
        np.testing.assert_allclose(pn, np.asarray(pj), atol=1e-12)
        np.testing.assert_allclose(qn, np.asarray(qj2), atol=1e-12)
        np.testing.assert_allclose(hm.se3_adjoint_np(t1, q), np.asarray(geom.se3_adjoint(jnp.asarray(t1), jnp.asarray(q))), atol=1e-12)


def test_host_cpu_placement():
    """host_cpu() places new arrays on the CPU backend (a no-op context when
    the CPU is the default backend, as in the tests)."""
    import jax
    import jax.numpy as jnp
    from isvins_tpu.utils.devices import host_cpu

    with host_cpu():
        a = jnp.ones(3) + 1
    assert a.devices() == {jax.devices("cpu")[0]}
