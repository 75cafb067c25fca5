"""Two-stage marginalization + information sparsification — the core of the
IS scheme (SURVEY.md §3.3; reference estimator.cpp:667–1539).

Instead of keeping a dense linearized marginalization prior (classic
fixed-lag smoothing), the information of the marginalized variables is
*re-expressed* as a sparse set of nonlinear pseudo-measurement factors:

- `init_sparsify`  (initFactorGraph, estimator.cpp:667–1001): after the first
  full-window BA, build the information matrix of the Vo-segment IMU chain,
  Schur-eliminate the interior speed/bias blocks, and recover {Vo-1
  relative-pose edges, an SE3 prior on pose 0, a speed/bias prior on frame
  Vo-1} whose stacked Jacobian reproduces the eigen-truncated marginal
  information (keep eigenvalues > ALPHA).

- `marg_forward`   (estimator.cpp:1149–1352): when the oldest frame is
  marginalized, collapse {pose 0, its co-visible frame-0/1 landmarks} into a
  refreshed SE3 prior on pose 1, and export a consistently-weighted
  relative-pose edge (0,1) + roll-pitch + covariance packet to the pose graph
  (the pseudo-inverse projection of the 12x12 pair information onto the
  relative-pose Jacobian).

- `marg_backward`  (estimator.cpp:1354–1539): collapse the speed/bias of
  frame Vo-1 through the IMU factor (Vo-1 -> Vo) into {relative-pose edge
  (Vo-1,Vo), speed/bias prior on Vo, roll-pitch on Vo-1}; yaw and absolute
  position rows participate in the information budget but their factors are
  deliberately dropped (gauge directions).

All of it is dense linear algebra on tiny matrices (<= (12+L)x(12+L)), pure
jax.numpy in float64, jit-able. The KLD between the recovered factor set and
the true truncated marginal is returned as a diagnostic — the reference
computes and discards it (estimator.cpp:974–988); our tests assert on it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..factors.preintegration import (
    Preintegration,
    imu_residual_jacobians,
    sqrt_info_from_cov,
)
from ..factors.projection import projection_residual_jacobians
from ..factors.priors import (
    relpose_residual_jacobians,
    rollpitch_residual_jacobians,
    se3_prior_residual_jacobians,
    yaw_residual_jacobians,
)
from ..geom import quat_conj, quat_mul, quat_normalize, quat_rotate
from ..solver.window import PriorState, RollPitchFactors, WindowState


class PoseGraphPacket(NamedTuple):
    """CombinedFactors equivalent (pose_graph_factors.h:6–18): one VIO edge
    exported to the pose graph per MARGIN_OLD keyframe."""

    rel_dt: jnp.ndarray  # (3,) measured relative translation (frame 0 -> 1)
    rel_dq: jnp.ndarray  # (4,) measured delta_q (i<-j sense of the factor)
    cov_rel: jnp.ndarray  # (6,6) edge covariance
    has_rollpitch: jnp.ndarray  # () bool
    rp_q: jnp.ndarray  # (4,) roll-pitch measurement of frame 0
    cov_abs: jnp.ndarray  # (2,2) roll-pitch covariance
    anchor_t: jnp.ndarray  # (3,) Ps[0]
    anchor_q: jnp.ndarray  # (4,) Rs[0]
    ts: jnp.ndarray  # () frame-0 timestamp
    distance: jnp.ndarray  # () |rel_dt|


def _info(sqrt):
    return sqrt.T @ sqrt


def _accum(Lam, blocks):
    """blocks: list of (row_offset, col_offset, matrix). Adds M and (if
    off-diagonal) M^T like the reference's OrderMap double loop."""
    for (r, c, M) in blocks:
        Lam = Lam.at[r : r + M.shape[0], c : c + M.shape[1]].add(M)
        if r != c:
            Lam = Lam.at[c : c + M.shape[1], r : r + M.shape[0]].add(M.T)
    return Lam


def _hessian_blocks(jacs_with_offsets, W):
    """Given [(offset, J_block)], produce upper-triangle Hessian blocks
    J_j^T W J_k for the _accum helper."""
    out = []
    for a, (ra, Ja) in enumerate(jacs_with_offsets):
        JtW = Ja.T @ W
        for b, (rb, Jb) in enumerate(jacs_with_offsets):
            if b < a:
                continue
            out.append((ra, rb, JtW @ Jb))
    return out


def _spd_solve(M, B, rel_eps: float = 0.0):
    """Cholesky solve of a symmetric PSD system (the SPD structure makes
    Cholesky the cheaper and more stable factorization than LU)."""
    n = M.shape[0]
    if rel_eps:
        M = M + rel_eps * jnp.maximum(jnp.max(jnp.abs(jnp.diag(M))), 1.0) * jnp.eye(
            n, dtype=M.dtype
        )
    return jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(M), True), B)


def _spd_inv(M, rel_eps: float = 0.0):
    return _spd_solve(M, jnp.eye(M.shape[0], dtype=M.dtype), rel_eps)


def _schur_keep_head(Lam, keep: int, rel_eps: float = 1e-10):
    """Marginalize the tail block: Lam_rr - Lam_rm Lam_mm^{-1} Lam_mr.
    (Reference uses fullPivLu; the jittered block is SPD so Cholesky.)"""
    rr = Lam[:keep, :keep]
    rm = Lam[:keep, keep:]
    mm = Lam[keep:, keep:]
    m = mm.shape[0]
    # guard: empty/zero diagonal slots (masked landmarks) -> identity rows
    scale = jnp.clip(jnp.diag(mm), 0.0, None)
    jitter = rel_eps * jnp.maximum(jnp.max(scale), 1.0)
    mm = mm + jitter * jnp.eye(m, dtype=Lam.dtype)
    sol = _spd_solve(mm, rm.T)
    out = rr - rm @ sol
    return 0.5 * (out + out.T)


def _eig_truncated(Lam_prior, alpha):
    """eigh + keep lambda > alpha (estimator.cpp:920–938). Returns
    (U_masked (n,n), inv_eigs_masked (n,)) with zero columns for dropped
    directions — statically shaped."""
    w, V = jnp.linalg.eigh(Lam_prior)
    keep = w > alpha
    w_safe = jnp.where(keep, w, 1.0)
    inv_w = jnp.where(keep, 1.0 / w_safe, 0.0)
    U = V * keep[None, :].astype(Lam_prior.dtype)
    return U, inv_w, keep


def _recovered_cov(J_i, U, inv_w):
    """cov_i = (J_i U) D^{-1} (J_i U)^T with truncated directions zeroed."""
    JU = J_i @ U
    return (JU * inv_w[None, :]) @ JU.T


def _kld_diagnostic(Jr, U, inv_w, keep, infos_with_offsets, n_dim):
    """Reference's consistency check (estimator.cpp:974–988): X = blockdiag of
    recovered infos; A = (Jr U)^T X (Jr U) should equal D."""
    X = jnp.zeros((Jr.shape[0], Jr.shape[0]), Jr.dtype)
    for off, info in infos_with_offsets:
        X = X.at[off : off + info.shape[0], off : off + info.shape[0]].add(info)
    JU = Jr @ U
    A = JU.T @ X @ JU
    # restrict to kept subspace
    k = keep.astype(Jr.dtype)
    A_k = A * k[:, None] * k[None, :] + jnp.diag(1.0 - k)
    D_k = jnp.where(keep, 1.0 / jnp.where(keep, inv_w, 1.0), 1.0)
    a = jnp.sum(jnp.diag(A_k) * jnp.where(keep, inv_w, 0.0))
    # A_k is SPD (kept subspace + identity padding): Cholesky logdet instead
    # of the LU-based slogdet
    L = jnp.linalg.cholesky(A_k + 1e-14 * jnp.eye(A_k.shape[0], dtype=Jr.dtype))
    logdet_b = 2.0 * jnp.sum(jnp.log(jnp.diag(L)))
    logdet_Dinv = jnp.sum(jnp.where(keep, jnp.log(inv_w), 0.0))
    n_keep = jnp.sum(keep)
    return 0.5 * (a - logdet_b - logdet_Dinv - n_keep)


# --------------------------------------------------------------------------
def init_sparsify(
    state: WindowState,
    pre_vo: Preintegration,  # stacked (Vo-1,) preintegrations, frames k -> k+1
    G,
    Vo: int,
    alpha: float,
):
    """initFactorGraph (estimator.cpp:745–999): from the Vo-segment IMU chain
    at the current (post-BA) state, recover the initial sparse prior set.

    Returns (PriorState, kld)."""
    dtype = state.P.dtype
    n_pose = 6 * Vo
    asize = n_pose + 9
    total = 15 * Vo

    # column order: T0..T_{Vo-1} | VB_{Vo-1} | VB_0..VB_{Vo-2}  (:749–758)
    def vb_off(i):
        return asize + 9 * i if i < Vo - 1 else n_pose

    Lam = jnp.zeros((total, total), dtype)
    S = sqrt_info_from_cov(pre_vo.cov, rel_jitter=1e-12)
    for k in range(Vo - 1):
        pre_k = jax.tree_util.tree_map(lambda a: a[k], pre_vo)
        _, J_pi, J_vbi, J_pj, J_vbj = imu_residual_jacobians(
            pre_k, G,
            state.P[k], state.Q[k], state.V[k], state.Ba[k], state.Bg[k],
            state.P[k + 1], state.Q[k + 1], state.V[k + 1], state.Ba[k + 1],
            state.Bg[k + 1],
        )
        W = S[k].T @ S[k]
        jacs = [
            (6 * k, J_pi),
            (vb_off(k), J_vbi),
            (6 * (k + 1), J_pj),
            (vb_off(k + 1), J_vbj),
        ]
        Lam = _accum(Lam, _hessian_blocks(jacs, W))

    Lam_prior = _schur_keep_head(Lam, asize)

    # define the recovered factors at the current state (residual = 0)
    rel_dt = []
    rel_dq = []
    J_list = []  # (offset_rows, Jr rows)
    Jr = jnp.zeros((asize, asize), dtype)
    rows = 0
    for k in range(1, Vo):
        i = k - 1
        dt_m = quat_rotate(quat_conj(state.Q[i]), state.P[k] - state.P[i])
        dq_m = quat_normalize(quat_mul(quat_conj(state.Q[i]), state.Q[k]))
        # factor residual Log(dR Rj^T Ri): dR = Ri^T Rj gives zero residual
        rel_dt.append(dt_m)
        rel_dq.append(dq_m)
        _, Ji, Jj = relpose_residual_jacobians(
            dt_m, dq_m, state.P[i], state.Q[i], state.P[k], state.Q[k]
        )
        Jr = Jr.at[rows : rows + 6, 6 * i : 6 * i + 6].add(Ji)
        Jr = Jr.at[rows : rows + 6, 6 * k : 6 * k + 6].add(Jj)
        rows += 6

    _, J_se3 = se3_prior_residual_jacobians(state.P[0], state.Q[0], state.P[0], state.Q[0])
    Jr = Jr.at[rows : rows + 6, 0:6].add(J_se3)
    se3_row = rows
    rows += 6
    Jr = Jr.at[rows : rows + 9, n_pose : n_pose + 9].add(jnp.eye(9, dtype=dtype))
    vb_row = rows
    rows += 9

    U, inv_w, keep = _eig_truncated(Lam_prior, alpha)

    rel_sqrt = [jnp.zeros((6, 6), dtype)]
    rel_dt_arr = [jnp.zeros(3, dtype)]
    rel_dq_arr = [jnp.array([1.0, 0, 0, 0], dtype)]
    infos = []
    r = 0
    for k in range(1, Vo):
        cov_k = _recovered_cov(Jr[r : r + 6, :], U, inv_w)
        sq = sqrt_info_from_cov(cov_k, rel_jitter=1e-10)
        rel_sqrt.append(sq)
        rel_dt_arr.append(rel_dt[k - 1])
        rel_dq_arr.append(rel_dq[k - 1])
        infos.append((r, _info(sq)))
        r += 6
    cov_se3 = _recovered_cov(Jr[se3_row : se3_row + 6, :], U, inv_w)
    se3_sqrt = sqrt_info_from_cov(cov_se3, rel_jitter=1e-10)
    infos.append((se3_row, _info(se3_sqrt)))
    cov_vb = _recovered_cov(Jr[vb_row : vb_row + 9, :], U, inv_w)
    vb_sqrt = sqrt_info_from_cov(cov_vb, rel_jitter=1e-10)
    infos.append((vb_row, _info(vb_sqrt)))

    kld = _kld_diagnostic(Jr, U, inv_w, keep, infos, asize)

    priors = PriorState(
        se3_t=state.P[0],
        se3_q=state.Q[0],
        se3_sqrt=se3_sqrt,
        se3_valid=jnp.asarray(True),
        vb=jnp.concatenate([state.V[Vo - 1], state.Ba[Vo - 1], state.Bg[Vo - 1]]),
        vb_sqrt=vb_sqrt,
        vb_valid=jnp.asarray(True),
        rel_dt=jnp.stack(rel_dt_arr),
        rel_dq=jnp.stack(rel_dq_arr),
        rel_sqrt=jnp.stack(rel_sqrt),
        rel_valid=jnp.arange(Vo) >= 1,
        rp=RollPitchFactors(
            q_meas=jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (Vo, 1)),
            sqrt_info=jnp.zeros((Vo, 2, 2), dtype),
            idx=jnp.zeros(Vo, jnp.int32),
            valid=jnp.zeros(Vo, bool),
        ),
    )
    return priors, kld


# --------------------------------------------------------------------------
def marg_forward(
    state: WindowState,
    priors: PriorState,
    marg_pts_i,  # (L,3) host-frame bearings of landmarks to marginalize
    marg_pts_j,  # (L,3) their frame-1 observations
    marg_fidx,  # (L,) landmark slots
    marg_valid,  # (L,) bool
    pixel_sqrt_info,
    alpha: float,
    ts0,
):
    """MargForward (estimator.cpp:1149–1352). Marginalizes pose 0 and the
    frame-0-hosted landmarks observed at frame 1.

    Returns (se3_t1, se3_q1, se3_sqrt1, packet: PoseGraphPacket, kld)."""
    dtype = state.P.dtype
    L = marg_pts_i.shape[0]
    dim = 12 + L

    # order: T1 (0:6) | T0 (6:12) | landmarks (12:12+L)  (:1153–1162)
    Lam = jnp.zeros((dim, dim), dtype)

    def proj_block(carry, inp):
        return carry, None

    # projection factors, vmapped then accumulated densely
    def one(pi, pj, f, v):
        d = state.dep[f]
        d = jnp.where(v & (jnp.abs(d) > 1e-8), d, 1.0)
        r, J_pi, J_pj, J_ex, J_dep = projection_residual_jacobians(
            pi, pj, state.P[0], state.Q[0], state.P[1], state.Q[1],
            state.tic, state.qic, d,
        )
        m = v.astype(dtype)
        return J_pi * m, J_pj * m, J_dep * m

    J_p0, J_p1, J_d = jax.vmap(one)(marg_pts_i, marg_pts_j, marg_fidx, marg_valid)
    w2 = pixel_sqrt_info**2
    # blocks: T1 x T1 (from J_pj), T1 x T0, T1 x dep_l, T0 x T0, T0 x dep_l, dep x dep
    Lam = Lam.at[0:6, 0:6].add(w2 * jnp.einsum("nri,nrj->ij", J_p1, J_p1))
    Lam = Lam.at[6:12, 6:12].add(w2 * jnp.einsum("nri,nrj->ij", J_p0, J_p0))
    c01 = w2 * jnp.einsum("nri,nrj->ij", J_p1, J_p0)
    Lam = Lam.at[0:6, 6:12].add(c01)
    Lam = Lam.at[6:12, 0:6].add(c01.T)
    g1 = w2 * jnp.einsum("nri,nr->ni", J_p1, J_d)  # (L,6)
    g0 = w2 * jnp.einsum("nri,nr->ni", J_p0, J_d)
    hl = w2 * jnp.sum(J_d * J_d, axis=-1)  # (L,)
    idx = jnp.arange(L)
    Lam = Lam.at[0:6, 12:].add(g1.T)
    Lam = Lam.at[12:, 0:6].add(g1)
    Lam = Lam.at[6:12, 12:].add(g0.T)
    Lam = Lam.at[12:, 6:12].add(g0)
    Lam = Lam.at[12 + idx, 12 + idx].add(hl)

    # SE3 prior on T0 (:1203–1211)
    _, J_se3 = se3_prior_residual_jacobians(priors.se3_t, priors.se3_q, state.P[0], state.Q[0])
    Lam = Lam.at[6:12, 6:12].add(J_se3.T @ _info(priors.se3_sqrt) @ J_se3)

    # relpose edge (0,1) (:1212–1238)
    _, Ji, Jj = relpose_residual_jacobians(
        priors.rel_dt[1], priors.rel_dq[1], state.P[0], state.Q[0], state.P[1], state.Q[1]
    )
    W_rel = _info(priors.rel_sqrt[1])
    Lam = _accum(Lam, _hessian_blocks([(6, Ji), (0, Jj)], W_rel))

    # ------- pose-graph edge via pseudo-inverse projection (:1243–1259)
    Lam_rp = Lam[0:12, 0:12]
    dt_m = quat_rotate(quat_conj(state.Q[0]), state.P[1] - state.P[0])
    dq_m = quat_normalize(quat_mul(quat_conj(state.Q[0]), state.Q[1]))
    _, Jpi, Jpj = relpose_residual_jacobians(
        dt_m, dq_m, state.P[0], state.Q[0], state.P[1], state.Q[1]
    )
    Jpg = jnp.zeros((6, 12), dtype)
    Jpg = Jpg.at[:, 6:12].set(Jpi)  # T0 columns
    Jpg = Jpg.at[:, 0:6].set(Jpj)  # T1 columns
    Jpinv = jnp.linalg.pinv(Jpg, rcond=1e-8)
    rp_omega = Jpinv.T @ Lam_rp @ Jpinv
    rp_omega = 0.5 * (rp_omega + rp_omega.T)
    rp_cov = _spd_inv(
        rp_omega + 1e-12 * jnp.trace(rp_omega) / 6 * jnp.eye(6, dtype=dtype)
    )

    # roll-pitch packet entry: edge with window index 0, if any (:1265–1271)
    has_rp = jnp.any((priors.rp.idx == 0) & priors.rp.valid)
    rp_slot = jnp.argmax((priors.rp.idx == 0) & priors.rp.valid)
    rp_q = priors.rp.q_meas[rp_slot]
    rp_info = _info(priors.rp.sqrt_info[rp_slot])
    cov_abs = _spd_inv(rp_info + (1.0 - has_rp) * jnp.eye(2, dtype=dtype) + 1e-12 * jnp.eye(2, dtype=dtype))

    packet = PoseGraphPacket(
        rel_dt=dt_m,
        rel_dq=dq_m,
        cov_rel=rp_cov,
        has_rollpitch=has_rp,
        rp_q=rp_q,
        cov_abs=cov_abs,
        anchor_t=state.P[0],
        anchor_q=state.Q[0],
        ts=jnp.asarray(ts0, dtype),
        distance=jnp.linalg.norm(dt_m),
    )

    # ------- Schur-eliminate [T0, landmarks] -> prior on T1 (:1286–1288)
    Lam_prior = _schur_keep_head(Lam, 6)

    # recover SE3 prior on T1 (:1290–1349)
    _, Jr1 = se3_prior_residual_jacobians(state.P[1], state.Q[1], state.P[1], state.Q[1])
    U, inv_w, keep = _eig_truncated(Lam_prior, alpha)
    cov1 = _recovered_cov(Jr1, U, inv_w)
    se3_sqrt1 = sqrt_info_from_cov(cov1, rel_jitter=1e-10)
    kld = _kld_diagnostic(Jr1, U, inv_w, keep, [(0, _info(se3_sqrt1))], 6)

    return state.P[1], state.Q[1], se3_sqrt1, packet, kld


# --------------------------------------------------------------------------
def marg_backward(
    state: WindowState,
    pre_vo: Preintegration,  # the IMU factor Vo-1 -> Vo
    priors: PriorState,
    G,
    Vo: int,
    alpha: float,
):
    """MargBackward (estimator.cpp:1354–1539). Marginalizes VB_{Vo-1}.

    Returns (rel_dt, rel_dq, rel_sqrt  [edge (Vo-1, Vo)],
             vb, vb_sqrt              [prior on frame Vo],
             rp_q, rp_sqrt            [roll-pitch on frame Vo-1],
             kld)."""
    dtype = state.P.dtype
    i, j = Vo - 1, Vo
    # order: T_Vo (0:6) | VB_Vo (6:15) | T_{Vo-1} (15:21) | VB_{Vo-1} (21:30)
    Lam = jnp.zeros((30, 30), dtype)

    # VB prior on VB_{Vo-1} (:1372–1380)
    Lam = Lam.at[21:30, 21:30].add(_info(priors.vb_sqrt))

    # IMU factor (Vo-1 -> Vo) (:1382–1412)
    S = sqrt_info_from_cov(pre_vo.cov, rel_jitter=1e-12)
    W = S.T @ S
    _, J_pi, J_vbi, J_pj, J_vbj = imu_residual_jacobians(
        pre_vo, G,
        state.P[i], state.Q[i], state.V[i], state.Ba[i], state.Bg[i],
        state.P[j], state.Q[j], state.V[j], state.Ba[j], state.Bg[j],
    )
    Lam = _accum(
        Lam, _hessian_blocks([(15, J_pi), (21, J_vbi), (0, J_pj), (6, J_vbj)], W)
    )

    Lam_prior = _schur_keep_head(Lam, 21)

    # recovered factor definitions at current state
    dt_m = quat_rotate(quat_conj(state.Q[i]), state.P[j] - state.P[i])
    dq_m = quat_normalize(quat_mul(quat_conj(state.Q[i]), state.Q[j]))
    _, Jri, Jrj = relpose_residual_jacobians(
        dt_m, dq_m, state.P[i], state.Q[i], state.P[j], state.Q[j]
    )
    vb_m = jnp.concatenate([state.V[j], state.Ba[j], state.Bg[j]])
    rp_q = state.Q[i]
    _, J_rp = rollpitch_residual_jacobians(rp_q, state.Q[i])
    _, J_yaw = yaw_residual_jacobians(state.Q[i], state.Q[i])

    # Jr rows: relpose(6) | vb(9) | rollpitch(2) | abs-pos(3) | yaw(1) (:1454–1464)
    Jr = jnp.zeros((21, 21), dtype)
    Jr = Jr.at[0:6, 15:21].add(Jri)
    Jr = Jr.at[0:6, 0:6].add(Jrj)
    Jr = Jr.at[6:15, 6:15].add(jnp.eye(9, dtype=dtype))
    Jr = Jr.at[15:17, 15:21].add(J_rp)
    Jr = Jr.at[17:20, 15:18].add(jnp.eye(3, dtype=dtype))
    Jr = Jr.at[20:21, 15:21].add(J_yaw)

    U, inv_w, keep = _eig_truncated(Lam_prior, alpha)

    cov_rel = _recovered_cov(Jr[0:6], U, inv_w)
    rel_sqrt = sqrt_info_from_cov(cov_rel, rel_jitter=1e-10)
    cov_vb = _recovered_cov(Jr[6:15], U, inv_w)
    vb_sqrt = sqrt_info_from_cov(cov_vb, rel_jitter=1e-10)
    cov_rp = _recovered_cov(Jr[15:17], U, inv_w)
    rp_sqrt = sqrt_info_from_cov(cov_rp, rel_jitter=1e-10)
    cov_abs = _recovered_cov(Jr[17:20], U, inv_w)
    cov_yaw = _recovered_cov(Jr[20:21], U, inv_w)

    infos = [
        (0, _info(rel_sqrt)),
        (6, _info(vb_sqrt)),
        (15, _info(rp_sqrt)),
        (17, _spd_inv(cov_abs + 1e-12 * jnp.eye(3, dtype=dtype))),
        (20, _spd_inv(cov_yaw + 1e-12 * jnp.eye(1, dtype=dtype))),
    ]
    kld = _kld_diagnostic(Jr, U, inv_w, keep, infos, 21)

    return dt_m, dq_m, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt, kld
