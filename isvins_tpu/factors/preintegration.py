"""IMU preintegration as a `lax.scan` over (padded, fixed-capacity) sample
buffers, with 15x15 error-state bias Jacobian and covariance propagation.

Math contract follows the reference's midpoint scheme
(include/factor/integration_base.h:54–128): error state ordered
[p(0:3), theta(3:6), v(6:9), ba(9:12), bg(12:15)], 18-dim noise
[na0, ng0, na1, ng1, nba, nbg]. The only deliberate deviation: the per-step
rotation update uses the exact quaternion exponential instead of the
reference's normalized first-order quaternion (same to O(dt^3); dt ~ 5 ms).

Padding convention: steps with dt == 0 are exact no-ops (F = I, V = 0), so a
fixed-capacity buffer zero-padded at the tail integrates exactly the valid
prefix — no masks needed. This is what makes the whole thing jit/vmap-able
with static shapes (SURVEY.md §7 hard part (a)).

Re-linearization (`repropagate`, integration_base.h:38–52) is just calling
`integrate_segment` again with new (ba, bg) on the stored buffers — the
functional design makes it free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import (
    quat_conj,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    right_jacobian_so3,
    skew,
    so3_exp_quat,
)


class ImuNoise(NamedTuple):
    """Continuous-time noise sigmas (euroc_config.yaml acc_n/gyr_n/acc_w/gyr_w)."""

    acc_n: jnp.ndarray
    gyr_n: jnp.ndarray
    acc_w: jnp.ndarray
    gyr_w: jnp.ndarray

    @staticmethod
    def from_config(noise_cfg, dtype=None) -> "ImuNoise":
        # host (numpy) constants: these are closed over by jitted
        # preintegration programs, which embed them at trace time instead of
        # capturing committed device arrays
        import numpy as _np

        dt = _np.dtype(dtype or _np.float64)
        return ImuNoise(
            _np.asarray(noise_cfg.acc_n, dt),
            _np.asarray(noise_cfg.gyr_n, dt),
            _np.asarray(noise_cfg.acc_w, dt),
            _np.asarray(noise_cfg.gyr_w, dt),
        )

    def block_diag18(self, dtype) -> jnp.ndarray:
        d = jnp.concatenate(
            [
                jnp.full((3,), self.acc_n**2, dtype),
                jnp.full((3,), self.gyr_n**2, dtype),
                jnp.full((3,), self.acc_n**2, dtype),
                jnp.full((3,), self.gyr_n**2, dtype),
                jnp.full((3,), self.acc_w**2, dtype),
                jnp.full((3,), self.gyr_w**2, dtype),
            ]
        )
        return jnp.diag(d)


class Preintegration(NamedTuple):
    """Result of integrating one inter-frame IMU segment at a fixed bias
    linearization point. A pytree; vmap-able across window segments."""

    delta_p: jnp.ndarray  # (3,)
    delta_q: jnp.ndarray  # (4,) wxyz
    delta_v: jnp.ndarray  # (3,)
    jac: jnp.ndarray  # (15,15) d(state)/d(initial error state), bias cols used
    cov: jnp.ndarray  # (15,15)
    sum_dt: jnp.ndarray  # ()
    ba: jnp.ndarray  # (3,) linearization accel bias
    bg: jnp.ndarray  # (3,) linearization gyro bias


def _midpoint_step(carry, inp, ba, bg, N18):
    """One midpoint step (integration_base.h:54–128)."""
    dp, dq, dv, J, P, acc0, gyr0 = carry
    dt, acc1, gyr1 = inp
    dtype = dp.dtype

    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq_new = quat_normalize(quat_mul(dq, so3_exp_quat(un_gyr * dt)))
    un_acc0 = quat_rotate(dq, acc0 - ba)
    un_acc1 = quat_rotate(dq_new, acc1 - ba)
    un_acc = 0.5 * (un_acc0 + un_acc1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt

    R0 = quat_to_mat(dq)
    R1 = quat_to_mat(dq_new)
    Wx = skew(un_gyr)
    A0x = skew(acc0 - ba)
    A1x = skew(acc1 - ba)
    I3 = jnp.eye(3, dtype=dtype)
    dt2 = dt * dt

    R1A1 = R1 @ A1x
    ImW = I3 - Wx * dt

    F = jnp.zeros((15, 15), dtype)
    F = F.at[0:3, 0:3].set(I3)
    F = F.at[0:3, 3:6].set(-0.25 * (R0 @ A0x) * dt2 - 0.25 * (R1A1 @ ImW) * dt2)
    F = F.at[0:3, 6:9].set(I3 * dt)
    F = F.at[0:3, 9:12].set(-0.25 * (R0 + R1) * dt2)
    F = F.at[0:3, 12:15].set(0.25 * R1A1 * dt2 * dt)
    F = F.at[3:6, 3:6].set(ImW)
    F = F.at[3:6, 12:15].set(-I3 * dt)
    F = F.at[6:9, 3:6].set(-0.5 * (R0 @ A0x) * dt - 0.5 * (R1A1 @ ImW) * dt)
    F = F.at[6:9, 6:9].set(I3)
    F = F.at[6:9, 9:12].set(-0.5 * (R0 + R1) * dt)
    F = F.at[6:9, 12:15].set(0.5 * R1A1 * dt2)
    F = F.at[9:12, 9:12].set(I3)
    F = F.at[12:15, 12:15].set(I3)

    V = jnp.zeros((15, 18), dtype)
    V = V.at[0:3, 0:3].set(0.25 * R0 * dt2)
    v03 = -0.125 * R1A1 * dt2 * dt
    V = V.at[0:3, 3:6].set(v03)
    V = V.at[0:3, 6:9].set(0.25 * R1 * dt2)
    V = V.at[0:3, 9:12].set(v03)
    V = V.at[3:6, 3:6].set(0.5 * I3 * dt)
    V = V.at[3:6, 9:12].set(0.5 * I3 * dt)
    V = V.at[6:9, 0:3].set(0.5 * R0 * dt)
    v63 = -0.25 * R1A1 * dt2
    V = V.at[6:9, 3:6].set(v63)
    V = V.at[6:9, 6:9].set(0.5 * R1 * dt)
    V = V.at[6:9, 9:12].set(v63)
    V = V.at[9:12, 12:15].set(I3 * dt)
    V = V.at[12:15, 15:18].set(I3 * dt)

    J_new = F @ J
    P_new = F @ P @ F.T + V @ N18 @ V.T
    return (dp_new, dq_new, dv_new, J_new, P_new, acc1, gyr1), None


def integrate_segment(
    dts: jnp.ndarray,  # (M,) inter-sample dt, zero-padded tail
    accs: jnp.ndarray,  # (M,3) samples at the *end* of each dt
    gyrs: jnp.ndarray,  # (M,3)
    acc0: jnp.ndarray,  # (3,) sample at segment start
    gyr0: jnp.ndarray,  # (3,)
    ba: jnp.ndarray,  # (3,) linearization point
    bg: jnp.ndarray,  # (3,)
    noise: ImuNoise,
) -> Preintegration:
    dtype = dts.dtype
    N18 = noise.block_diag18(dtype)
    init = (
        jnp.zeros(3, dtype),
        quat_identity(dtype),
        jnp.zeros(3, dtype),
        jnp.eye(15, dtype=dtype),
        jnp.zeros((15, 15), dtype),
        acc0.astype(dtype),
        gyr0.astype(dtype),
    )
    step = lambda c, x: _midpoint_step(c, x, ba.astype(dtype), bg.astype(dtype), N18)
    (dp, dq, dv, J, P, _, _), _ = jax.lax.scan(step, init, (dts, accs, gyrs))
    return Preintegration(dp, dq, dv, J, P, jnp.sum(dts), ba.astype(dtype), bg.astype(dtype))


def bias_corrected_delta(pre: Preintegration, Bai, Bgi):
    """First-order bias correction of (dp, dq, dv) (integration_base.h:173–178)."""
    dba = Bai - pre.ba
    dbg = Bgi - pre.bg
    dp = pre.delta_p + pre.jac[0:3, 9:12] @ dba + pre.jac[0:3, 12:15] @ dbg
    dq = quat_normalize(quat_mul(pre.delta_q, so3_exp_quat(pre.jac[3:6, 12:15] @ dbg)))
    dv = pre.delta_v + pre.jac[6:9, 9:12] @ dba + pre.jac[6:9, 12:15] @ dbg
    return dp, dq, dv


def imu_residual(pre: Preintegration, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """Unweighted 15-residual (integration_base.h:160–186). G is the gravity
    vector in world frame, e.g. [0,0,9.81]."""
    dp, dq, dv = bias_corrected_delta(pre, Bai, Bgi)
    dt = pre.sum_dt
    Qi_inv = quat_conj(Qi)
    r_p = quat_rotate(Qi_inv, 0.5 * G * dt * dt + Pj - Pi - Vi * dt) - dp
    r_q = 2.0 * quat_mul(quat_conj(dq), quat_mul(Qi_inv, Qj))[1:4]
    r_v = quat_rotate(Qi_inv, G * dt + Vj - Vi) - dv
    return jnp.concatenate([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi])


def _qleft(q):
    """Utility::Qleft — 4x4 left-multiplication matrix of quaternion (wxyz
    rows/cols). Stack-assembled: .at[].set() construction lowers to one
    scatter kernel per block under the solver's vmap (16 serialized tiny
    dispatches per LM iteration, profiled)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([w, -x, -y, -z]),
        jnp.stack([x, w, -z, y]),
        jnp.stack([y, z, w, -x]),
        jnp.stack([z, -y, x, w]),
    ])


def _qright(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([w, -x, -y, -z]),
        jnp.stack([x, w, z, -y]),
        jnp.stack([y, -z, w, x]),
        jnp.stack([z, y, -x, w]),
    ])


def imu_residual_jacobians(pre: Preintegration, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """Residual + minimal-coordinate Jacobians wrt (pose_i[6], vb_i[9],
    pose_j[6], vb_j[9]); right-perturbation q -> q*Exp(dtheta).
    Matches imu_factor.h:161–265 (un-weighted; the solver applies sqrt-info
    from `pre.cov`)."""
    dtype = Pi.dtype
    r = imu_residual(pre, G, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)
    dt = pre.sum_dt
    Ri_T = quat_to_mat(Qi).T
    dq_dbg = pre.jac[3:6, 12:15]
    dp_dba = pre.jac[0:3, 9:12]
    dp_dbg = pre.jac[0:3, 12:15]
    dv_dba = pre.jac[6:9, 9:12]
    dv_dbg = pre.jac[6:9, 12:15]

    corr_dq = quat_normalize(
        quat_mul(pre.delta_q, so3_exp_quat(dq_dbg @ (Bgi - pre.bg)))
    )
    Qj_inv_Qi = quat_mul(quat_conj(Qj), Qi)

    # Block assembly uses jnp.block (concatenation) rather than
    # zeros().at[...].set(): under the solver's vmap over factors, each
    # block-set lowers to a standalone scatter kernel — profiled at ~100 us
    # of serialized tiny dispatches per LM iteration; concatenates fuse.
    Z33 = jnp.zeros((3, 3), dtype)
    I3 = jnp.eye(3, dtype=dtype)

    J_pi = jnp.block([
        [-Ri_T, skew(quat_rotate(quat_conj(Qi), 0.5 * G * dt * dt + Pj - Pi - Vi * dt))],
        [Z33, -(_qleft(Qj_inv_Qi) @ _qright(corr_dq))[1:4, 1:4]],
        [Z33, skew(quat_rotate(quat_conj(Qi), G * dt + Vj - Vi))],
        [Z33, Z33],
        [Z33, Z33],
    ])

    # NB reference (imu_factor.h:105) uses the *uncorrected* delta_q and drops
    # the right-Jacobian of the bias-correction exp, making this block ~1% off
    # for dbg ~ 5e-3; the exact form is -Qleft(Qj^-1 Qi corr_dq) Jr(a) dq_dbg
    # with a = dq_dbg (Bgi - bg_lin)
    a_corr = dq_dbg @ (Bgi - pre.bg)
    J_q_bg = (
        -_qleft(quat_mul(Qj_inv_Qi, corr_dq))[1:4, 1:4]
        @ right_jacobian_so3(a_corr)
        @ dq_dbg
    )
    J_vbi = jnp.block([
        [-Ri_T * dt, -dp_dba, -dp_dbg],
        [Z33, Z33, J_q_bg],
        [-Ri_T, -dv_dba, -dv_dbg],
        [Z33, -I3, Z33],
        [Z33, Z33, -I3],
    ])

    J_pj = jnp.block([
        [Ri_T, Z33],
        [Z33, _qleft(quat_mul(quat_conj(corr_dq), quat_mul(quat_conj(Qi), Qj)))[1:4, 1:4]],
        [Z33, Z33],
        [Z33, Z33],
        [Z33, Z33],
    ])

    J_vbj = jnp.block([
        [Z33, Z33, Z33],
        [Z33, Z33, Z33],
        [Ri_T, Z33, Z33],
        [Z33, I3, Z33],
        [Z33, Z33, I3],
    ])

    return r, J_pi, J_vbi, J_pj, J_vbj


def sqrt_info_from_cov(cov: jnp.ndarray, rel_jitter: float = 0.0) -> jnp.ndarray:
    """S with S^T S = cov^{-1} (imu_factor.h:44 computes chol(cov^{-1})^T; we
    use the numerically superior S = chol(cov)^{-1}, identical in exact
    arithmetic: cov = C C^T  =>  C^{-T} C^{-1} = cov^{-1}). Whitening is then
    r -> S r. Works batched over leading dims.

    rel_jitter is *relative* to mean(diag(cov)) — an absolute jitter gets
    amplified by 1/lambda_min when whitening (the preintegration cov has
    lambda_min ~ 1e-11). Callers with possibly-singular cov (masked/empty
    segments) should pass e.g. 1e-12."""
    n = cov.shape[-1]
    covs = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    scale = jnp.trace(covs, axis1=-2, axis2=-1)[..., None, None] / n
    covr = covs + (rel_jitter * scale + jnp.finfo(cov.dtype).tiny) * jnp.eye(n, dtype=cov.dtype)
    C = jnp.linalg.cholesky(covr)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=cov.dtype), covr.shape)
    return jax.scipy.linalg.solve_triangular(C, eye, lower=True)
