"""SE(3) poses as (p, q) pairs: translation (...,3) + unit quaternion (...,4) wxyz.

Tangent ordering is **[translation(3); rotation(3)]** throughout the engine —
matching the reference's residual layout (relative_pose_factor.h:41–42 head =
translation, tail = SO3 log) and Sophus' (v, w) tangent used by the reference's
adjoint covariance transport (pose_graph_factors.h:27–51).
"""

from __future__ import annotations

import jax.numpy as jnp

from .so3 import (
    left_jacobian_so3,
    left_jacobian_inv_so3,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    mat_to_quat,
    skew,
    so3_exp_quat,
    quat_log,
)


def se3_compose(p1, q1, p2, q2):
    """T1 * T2."""
    return p1 + quat_rotate(q1, p2), quat_normalize(quat_mul(q1, q2))


def se3_inverse(p, q):
    qi = quat_conj(q)
    return -quat_rotate(qi, p), qi


def se3_apply(p, q, x):
    return p + quat_rotate(q, x)


def se3_relative(p1, q1, p2, q2):
    """T1^{-1} * T2 = (R1^T (p2-p1), q1^{-1} q2)."""
    qi = quat_conj(q1)
    return quat_rotate(qi, p2 - p1), quat_normalize(quat_mul(qi, q2))


def se3_adjoint(p, q):
    """6x6 adjoint of T=(p,q) in [trans; rot] ordering:
    Adj = [[R, [p]x R], [0, R]]  (Sophus SE3::Adj)."""
    R = quat_to_mat(q)
    top = jnp.concatenate([R, skew(p) @ R], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_exp(xi):
    """SE(3) exp, xi = (...,6) [v; w] -> (p, q)."""
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(w)
    # p = Jl(w) v   (left Jacobian of SO3)
    p = jnp.einsum("...ij,...j->...i", left_jacobian_so3(w), v)
    return p, q


def se3_log(p, q):
    """Inverse of se3_exp: (p,q) -> (...,6) [v; w]."""
    w = quat_log(q)
    # closed form (no LU solve)
    v = jnp.einsum("...ij,...j->...i", left_jacobian_inv_so3(w), p)
    return jnp.concatenate([v, w], axis=-1)


def se3_from_mat(T):
    """(...,4,4) -> (p, q)."""
    return T[..., :3, 3], mat_to_quat(T[..., :3, :3])


def se3_to_mat(p, q):
    R = quat_to_mat(q)
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=p.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(p)
    T = T.at[..., 3, 3].set(1.0)
    return T
