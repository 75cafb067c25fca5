"""Component-planes projection-factor evaluation.

The naive vmapped evaluation (factors/projection.py) operates on (N,3) and
(N,3,3) tensors, so every op works on 3-element minor dimensions. This module
evaluates the same math as pure elementwise chains over (N,)-shaped
component planes, which XLA fuses into few kernels — and exploits that
every rotation matrix in the Jacobian chain is a *composition of rotations*,
so it can be formed by quaternion products instead of 3x3 matmuls:

    A = Ric^T Rj^T = R(conj(Qj ⊗ qic))
    B = A Ri       = R(conj(Qj ⊗ qic) ⊗ Qi)
    C = B Ric      = R(conj(Qj ⊗ qic) ⊗ Qi ⊗ qic)

Validated against the reference-faithful implementation in tests.
When the extrinsic is fixed (the EuRoC default), its Jacobian block is
skipped entirely.
"""

from __future__ import annotations

import jax.numpy as jnp


def _qmul(a, b):
    """Component-tuple Hamilton product: a, b = (w,x,y,z) of (N,) arrays."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _qconj(a):
    aw, ax, ay, az = a
    return (aw, -ax, -ay, -az)


def _qrot(q, v):
    """Rotate component-tuple vector v by quaternion tuple q."""
    w, x, y, z = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return (
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    )


def _qmat(q):
    """Rotation-matrix component planes (r00..r22) from quaternion tuple."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return (
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def eval_proj_rows(pts_i, pts_j, Pi, Qi, Pj, Qj, tic, qic, dep, valid):
    """All-components projection evaluation.

    Inputs are per-observation gathered arrays: pts_i/pts_j (N,3), Pi/Pj
    (N,3), Qi/Qj (N,4) wxyz, tic (3,), qic (4,), dep (N,), valid (N,) bool.

    Returns (r (N,2), J_pi (N,2,6), J_pj (N,2,6), J_dep (N,2)) — unweighted,
    matching factors.projection.projection_residual_jacobians (the extrinsic
    block is omitted; callers needing it use the reference path)."""
    d = jnp.where(valid & (jnp.abs(dep) > 1e-8), dep, 1.0)

    qi = tuple(Qi[:, k] for k in range(4))
    qj = tuple(Qj[:, k] for k in range(4))
    qc = tuple(jnp.full(Pi.shape[0], qic[k], Pi.dtype) for k in range(4))
    tc = tuple(jnp.full(Pi.shape[0], tic[k], Pi.dtype) for k in range(3))

    pi = tuple(pts_i[:, k] / d for k in range(3))  # pts_cam_i
    # camera -> body -> world
    bi = _qrot(qc, pi)
    bi = (bi[0] + tc[0], bi[1] + tc[1], bi[2] + tc[2])  # pts_imu_i
    wpt = _qrot(qi, bi)
    wpt = (wpt[0] + Pi[:, 0], wpt[1] + Pi[:, 1], wpt[2] + Pi[:, 2])
    bj = _qrot(_qconj(qj), (wpt[0] - Pj[:, 0], wpt[1] - Pj[:, 1], wpt[2] - Pj[:, 2]))
    cj = _qrot(_qconj(qc), (bj[0] - tc[0], bj[1] - tc[1], bj[2] - tc[2]))

    z = cj[2]
    z = jnp.where(jnp.abs(z) > 1e-6, z, jnp.where(z >= 0, 1e-6, -1e-6))
    inv_z = 1.0 / z
    u = cj[0] * inv_z
    v = cj[1] * inv_z
    r = jnp.stack([u - pts_j[:, 0], v - pts_j[:, 1]], axis=-1)

    # rotation compositions as quaternions
    q_a = _qconj(_qmul(qj, qc))          # Ric^T Rj^T
    q_b = _qmul(q_a, qi)                 # Ric^T Rj^T Ri
    q_c = _qmul(q_b, qc)                 # Ric^T Rj^T Ri Ric

    A = _qmat(q_a)
    B = _qmat(q_b)
    Cm = _qmat(q_c)

    def reduce_rows(M):
        """(2x3) = reduce @ M for M given as 9 planes: rows r0 = M0/z - u M2/z,
        r1 = M1/z - v M2/z (componentwise)."""
        m00, m01, m02, m10, m11, m12, m20, m21, m22 = M
        r0 = ((m00 - u * m20) * inv_z, (m01 - u * m21) * inv_z, (m02 - u * m22) * inv_z)
        r1 = ((m10 - v * m20) * inv_z, (m11 - v * m21) * inv_z, (m12 - v * m22) * inv_z)
        return r0, r1

    RA0, RA1 = reduce_rows(A)   # reduce @ Ric^T Rj^T
    RB0, RB1 = reduce_rows(B)   # reduce @ Ric^T Rj^T Ri

    # J_pi: [ RA | rows_k = cross(bi, RB_k) ]   (RB @ -skew(bi), row-wise)
    JpiR0 = _cross(bi, RB0)
    JpiR1 = _cross(bi, RB1)
    J_pi = jnp.stack(
        [jnp.stack(RA0 + JpiR0, axis=-1), jnp.stack(RA1 + JpiR1, axis=-1)], axis=1
    )

    # J_pj: [ -RA | rows_k = -cross(bj, RC_k) ] with RC = reduce @ Ric^T
    # (reduce @ Ric^T) rows: Ric^T = R(conj(qc))
    RC = _qmat(_qconj(qc))
    RC0, RC1 = reduce_rows(RC)
    JpjR0 = _cross(bj, RC0)
    JpjR1 = _cross(bj, RC1)
    J_pj = jnp.stack(
        [
            jnp.stack(tuple(-a for a in RA0) + tuple(-a for a in JpjR0), axis=-1),
            jnp.stack(tuple(-a for a in RA1) + tuple(-a for a in JpjR1), axis=-1),
        ],
        axis=1,
    )

    # J_dep = reduce @ (C @ pts_i) * (-1/d^2)
    c00, c01, c02, c10, c11, c12, c20, c21, c22 = Cm
    px, py, pz = pts_i[:, 0], pts_i[:, 1], pts_i[:, 2]
    w0 = c00 * px + c01 * py + c02 * pz
    w1 = c10 * px + c11 * py + c12 * pz
    w2 = c20 * px + c21 * py + c22 * pz
    s = -1.0 / (d * d)
    J_dep = jnp.stack(
        [(w0 - u * w2) * inv_z * s, (w1 - v * w2) * inv_z * s], axis=-1
    )
    return r, J_pi, J_pj, J_dep
