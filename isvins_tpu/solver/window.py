"""Batched sliding-window bundle-adjustment solver.

Problem structure mirrors estimator.cpp problemSolve (:1004–1146) /
initFactorGraph's full-window BA (:667–743):

- B pose blocks (6-dof) + B speed/bias blocks (9-dof) + 1 extrinsic (6-dof)
- B-1 IMU factors between consecutive frames (no robust loss)
- up to N inverse-depth projection factors, Cauchy(1.0), whitened by
  PIXEL_SQRT_INFO (estimator.cpp:35)
- sparse nonlinear priors (IS scheme): SE3 prior on pose 0, speed/bias prior
  on frame Vo-1, Vo-1 relative-pose edges over the VO segment, roll-pitch
  edges — all with Cauchy(1.0) like the reference (estimator.cpp:1102–1117)

Architecture: every factor family is evaluated with `vmap`, its block
Jacobians are expanded into dense rows of the pose system with one-hot
einsums (dense products, no scatters), the Gauss-Newton Hessian is one
`J^T J` matmul, landmarks are Schur-eliminated with a single (D,F)x(F,D)
matmul, and the Levenberg–Marquardt accept/reject loop is branchless inside
`lax.while_loop`. All shapes static; masks handle validity. Float32 dots run
at the package's pinned matmul precision (isvins_tpu/__init__.py).

Column layout of the reduced system (D = 15*B + 6):
  pose i  -> [6i, 6i+6)
  vb   i  -> [6B + 9i, 6B + 9i + 9)
  ex      -> [15B, 15B+6)
"""

from __future__ import annotations

import functools
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
    linear9_residual_jacobians,
    relpose_residual_jacobians,
    rollpitch_residual_jacobians,
    se3_prior_residual_jacobians,
)
from ..geom import quat_mul, quat_normalize, so3_exp_quat
from .proj_fast import eval_proj_rows

class WindowDims(NamedTuple):
    """Static problem shapes (python ints; captured at trace time)."""

    B: int  # window frames (ALL_BUF_SIZE = 18)
    Vo: int  # VO segment (Vo_SIZE = 8)
    F: int  # landmark capacity (NUM_OF_F = 1000)
    N: int  # projection-observation capacity

    @property
    def D(self) -> int:
        return 15 * self.B + 6


class WindowState(NamedTuple):
    P: jnp.ndarray  # (B,3)
    Q: jnp.ndarray  # (B,4) wxyz
    V: jnp.ndarray  # (B,3)
    Ba: jnp.ndarray  # (B,3)
    Bg: jnp.ndarray  # (B,3)
    tic: jnp.ndarray  # (3,)
    qic: jnp.ndarray  # (4,)
    dep: jnp.ndarray  # (F,) inverse depths


class ProjFactors(NamedTuple):
    idx_i: jnp.ndarray  # (N,) int32 host frame
    idx_j: jnp.ndarray  # (N,) int32 observing frame
    fidx: jnp.ndarray  # (N,) int32 landmark slot
    pts_i: jnp.ndarray  # (N,3) normalized bearing in host frame
    pts_j: jnp.ndarray  # (N,3)
    valid: jnp.ndarray  # (N,) bool


class ImuFactors(NamedTuple):
    pre: Preintegration  # stacked (B-1, ...), factor k connects frames k,k+1
    valid: jnp.ndarray  # (B-1,) bool
    sqrt: jnp.ndarray  # (B-1,15,15) precomputed whitening (cov is fixed per solve)

    @staticmethod
    def create(pre: Preintegration, valid) -> "ImuFactors":
        eye15 = jnp.eye(15, dtype=pre.cov.dtype)
        cov = jnp.where(valid[:, None, None], pre.cov, eye15)
        S = sqrt_info_from_cov(cov, rel_jitter=1e-12)
        return ImuFactors(pre=pre, valid=valid, sqrt=S)


class RollPitchFactors(NamedTuple):
    q_meas: jnp.ndarray  # (K,4)
    sqrt_info: jnp.ndarray  # (K,2,2)
    idx: jnp.ndarray  # (K,) int32 frame index
    valid: jnp.ndarray  # (K,) bool


class PriorState(NamedTuple):
    """The IS sparse nonlinear prior set (estimator.h:134–138)."""

    se3_t: jnp.ndarray  # (3,)
    se3_q: jnp.ndarray  # (4,)
    se3_sqrt: jnp.ndarray  # (6,6)
    se3_valid: jnp.ndarray  # () bool
    vb: jnp.ndarray  # (9,)
    vb_sqrt: jnp.ndarray  # (9,9)
    vb_valid: jnp.ndarray  # () bool
    rel_dt: jnp.ndarray  # (Vo,3)   edge k connects (k-1, k); slot 0 unused
    rel_dq: jnp.ndarray  # (Vo,4)
    rel_sqrt: jnp.ndarray  # (Vo,6,6)
    rel_valid: jnp.ndarray  # (Vo,) bool
    rp: RollPitchFactors  # capacity Vo

    @staticmethod
    def empty(Vo: int, dtype=None) -> "PriorState":
        """Host-side (numpy) empty prior set. Numpy leaves keep the host
        state machine off the accelerator: the estimator stores and mutates
        priors in host memory and only the jitted solve/marg calls move them
        across the device boundary."""
        import numpy as _np

        dtype = dtype or _np.float64
        return PriorState(
            se3_t=_np.zeros(3, dtype),
            se3_q=_np.array([1.0, 0, 0, 0], dtype),
            se3_sqrt=_np.zeros((6, 6), dtype),
            se3_valid=_np.asarray(False),
            vb=_np.zeros(9, dtype),
            vb_sqrt=_np.zeros((9, 9), dtype),
            vb_valid=_np.asarray(False),
            rel_dt=_np.zeros((Vo, 3), dtype),
            rel_dq=_np.tile(_np.array([1.0, 0, 0, 0], dtype), (Vo, 1)),
            rel_sqrt=_np.zeros((Vo, 6, 6), dtype),
            rel_valid=_np.zeros(Vo, bool),
            rp=RollPitchFactors(
                q_meas=_np.tile(_np.array([1.0, 0, 0, 0], dtype), (Vo, 1)),
                sqrt_info=_np.zeros((Vo, 2, 2), dtype),
                idx=_np.zeros(Vo, _np.int32),
                valid=_np.zeros(Vo, bool),
            ),
        )


def _cauchy_weight(r_sq):
    """Ceres CauchyLoss(1): rho(s) = log(1+s); IRLS weight sqrt(rho'(s))."""
    return jnp.sqrt(1.0 / (1.0 + r_sq))


def _cauchy_rho(r_sq):
    return jnp.log1p(r_sq)


def _pose_cols_onehot(idx, B, dtype):
    """(n,) frame indices -> (n, B) one-hot for einsum expansion."""
    return jax.nn.one_hot(idx, B, dtype=dtype)


def _expand_pose_block(Jb, onehot):
    """(n, r, 6) block + (n, B) one-hot -> (n, r, 6B) dense pose columns."""
    n, r, _ = Jb.shape
    out = jnp.einsum("nrk,nb->nrbk", Jb, onehot)
    return out.reshape(n, r, -1)


def retract_state(state: WindowState, dx: jnp.ndarray, dl: jnp.ndarray, dims: WindowDims):
    """Apply the manifold plus: p+dp, q*Exp(dtheta) (pose_local_parameterization),
    additive on v/ba/bg/ex-trans/depth."""
    B = dims.B
    d_pose = dx[: 6 * B].reshape(B, 6)
    d_vb = dx[6 * B : 15 * B].reshape(B, 9)
    d_ex = dx[15 * B :]
    return WindowState(
        P=state.P + d_pose[:, :3],
        Q=quat_normalize(quat_mul(state.Q, so3_exp_quat(d_pose[:, 3:]))),
        V=state.V + d_vb[:, :3],
        Ba=state.Ba + d_vb[:, 3:6],
        Bg=state.Bg + d_vb[:, 6:9],
        tic=state.tic + d_ex[:3],
        qic=quat_normalize(quat_mul(state.qic, so3_exp_quat(d_ex[3:]))),
        dep=state.dep + dl,
    )


def _eval_imu(state: WindowState, imu: ImuFactors, G, dims: WindowDims):
    """Whitened residuals (B-1,15) + dense rows (B-1,15,D) + cost."""
    B, D = dims.B, dims.D
    dtype = state.P.dtype
    i_idx = jnp.arange(B - 1)
    j_idx = i_idx + 1
    S = imu.sqrt  # precomputed: cov is constant across LM iterations

    def one(k):
        pre_k = jax.tree_util.tree_map(lambda a: a[k], imu.pre)
        return imu_residual_jacobians(
            pre_k, G,
            state.P[k], state.Q[k], state.V[k], state.Ba[k], state.Bg[k],
            state.P[k + 1], state.Q[k + 1], state.V[k + 1], state.Ba[k + 1], state.Bg[k + 1],
        )

    r, J_pi, J_vbi, J_pj, J_vbj = jax.vmap(one)(i_idx)
    Jcat = jnp.concatenate([J_pi, J_vbi, J_pj, J_vbj], axis=2)  # (n,15,30)
    w = imu.valid.astype(dtype)[:, None]
    # single whitening matmul over the concatenated (15, 6+9+6+9) block
    Jcat = jnp.einsum("nab,nbk->nak", S, Jcat) * w[..., None]
    r_w = jnp.einsum("nab,nb->na", S, r) * w
    J_pi, J_vbi = Jcat[:, :, :6], Jcat[:, :, 6:15]
    J_pj, J_vbj = Jcat[:, :, 15:21], Jcat[:, :, 21:30]

    # each factor touches frames (k, k+1): stack the two endpoints and let
    # the einsum sum them — one expansion per block family instead of four
    oh2 = jnp.stack(
        [_pose_cols_onehot(i_idx, B, dtype), _pose_cols_onehot(j_idx, B, dtype)],
        axis=1,
    )  # (n, 2, B)
    Jp2 = jnp.stack([J_pi, J_pj], axis=1)  # (n, 2, 15, 6)
    Jv2 = jnp.stack([J_vbi, J_vbj], axis=1)  # (n, 2, 15, 9)
    pose_part = jnp.einsum("nsrk,nsb->nrbk", Jp2, oh2).reshape(B - 1, 15, 6 * B)
    vb_part = jnp.einsum("nsrk,nsb->nrbk", Jv2, oh2).reshape(B - 1, 15, 9 * B)
    Jrows = jnp.concatenate(
        [pose_part, vb_part, jnp.zeros((B - 1, 15, 6), dtype)], axis=2
    )
    # cost as a per-factor VECTOR: the callers concatenate every family's
    # contributions and reduce ONCE instead of one scalar reduction per
    # family
    cvec = 0.5 * jnp.sum(r_w * r_w, axis=1)
    return r_w, Jrows, cvec


def _eval_proj(state: WindowState, proj: ProjFactors, pixel_sqrt_info, dims: WindowDims,
               estimate_extrinsic: bool = False):
    """Whitened+robust projection residuals (N,2) and COMPACT block
    Jacobians J_pi/J_pj/J_ex (N,2,6) + landmark partials (N,2) + cost vector.
    The caller accumulates the normal equations block-wise instead of
    materializing dense (N,2,6B) rows (see build_normal_equations)."""
    B, F, D = dims.B, dims.F, dims.D
    dtype = state.P.dtype

    # Per-observation state lookups as one-hot matmuls, not gathers: the
    # one-hots are reused by the block accumulation in
    # build_normal_equations. They are exact only at full float32 precision
    # (a TF32 product would round a 3 m position to the millimetre), hence the
    # package-wide HIGHEST matmul pin. Gather vs one-hot on the H100 is
    # unmeasured (ROADMAP Queue 1 item 3).
    oh_i = _pose_cols_onehot(proj.idx_i, B, dtype)
    oh_j = _pose_cols_onehot(proj.idx_j, B, dtype)
    oh_f = jax.nn.one_hot(proj.fidx, F, dtype=dtype)
    P_i = oh_i @ state.P
    Q_i = oh_i @ state.Q
    P_j = oh_j @ state.P
    Q_j = oh_j @ state.Q
    dep_g = oh_f @ state.dep

    if not estimate_extrinsic:
        # component-planes fast path (solver/proj_fast.py): elementwise over
        # N observations, rotations composed as quaternion products
        r, J_pi, J_pj, J_dep = eval_proj_rows(
            proj.pts_i, proj.pts_j, P_i, Q_i, P_j, Q_j,
            state.tic, state.qic, dep_g, proj.valid,
        )
        J_ex = jnp.zeros((proj.pts_i.shape[0], 2, 6), dtype)
    else:

        def one(pi, pj, Pi, Qi, Pj, Qj, d, v):
            # sanitize BEFORE evaluation: masked rows must not produce NaN
            # (NaN * 0 = NaN would leak through the validity mask)
            d = jnp.where(v & (jnp.abs(d) > 1e-8), d, 1.0)
            return projection_residual_jacobians(
                pi, pj, Pi, Qi, Pj, Qj, state.tic, state.qic, d,
            )

        r, J_pi, J_pj, J_ex, J_dep = jax.vmap(one)(
            proj.pts_i, proj.pts_j, P_i, Q_i, P_j, Q_j, dep_g, proj.valid
        )
    s = pixel_sqrt_info
    vw = proj.valid.astype(dtype)
    r_sq = jnp.sum((s * r) ** 2, axis=-1)
    w = (s * _cauchy_weight(r_sq)) * vw  # scalar whiten * robust * mask
    r_w = r * w[:, None]
    J_pi = J_pi * w[:, None, None]
    J_pj = J_pj * w[:, None, None]
    J_ex = J_ex * w[:, None, None]
    J_dep = J_dep * w[:, None]

    cvec = 0.5 * _cauchy_rho(r_sq) * vw  # see _eval_imu cost-vector note
    return r_w, J_pi, J_pj, J_ex, J_dep, cvec, (oh_i, oh_j, oh_f)



def _atb(A, B):
    """A^T @ B as one dot_general contracting dim 0 (no transpose
    materialized)."""
    return jax.lax.dot_general(
        A, B, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=A.dtype,
    )

def _eval_priors(state: WindowState, priors: PriorState, dims: WindowDims):
    """All sparse nonlinear priors -> list of (r_w, Jrows) + cost.
    Each gets Cauchy(1.0) like the reference (estimator.cpp:1102–1117)."""
    B, Vo, D = dims.B, dims.Vo, dims.D
    dtype = state.P.dtype
    rows = []
    cvecs = []  # per-factor cost pieces; summed once by the caller

    def robustify(r_w, Jrows_list, valid):
        s = jnp.sum(r_w * r_w)
        w = _cauchy_weight(s) * valid.astype(dtype)
        c = 0.5 * _cauchy_rho(s) * valid.astype(dtype)
        return r_w * w, [J * w for J in Jrows_list], c

    # SE3 prior on pose 0
    r, J = se3_prior_residual_jacobians(priors.se3_t, priors.se3_q, state.P[0], state.Q[0])
    r_w = priors.se3_sqrt @ r
    J_w = priors.se3_sqrt @ J
    r_w, (J_w,), c = robustify(r_w, [J_w], priors.se3_valid)
    Jrow = jnp.zeros((6, D), dtype).at[:, 0:6].set(J_w)
    rows.append((r_w, Jrow))
    cvecs.append(c[None])

    # VB prior on frame Vo-1
    k = Vo - 1
    r, J = linear9_residual_jacobians(priors.vb, state.V[k], state.Ba[k], state.Bg[k])
    r_w = priors.vb_sqrt @ r
    J_w = priors.vb_sqrt @ J
    r_w, (J_w,), c = robustify(r_w, [J_w], priors.vb_valid)
    Jrow = jnp.zeros((9, D), dtype).at[:, 6 * B + 9 * k : 6 * B + 9 * k + 9].set(J_w)
    rows.append((r_w, Jrow))
    cvecs.append(c[None])

    # relative-pose edges (k-1, k), k = 1..Vo-1
    def one_rel(k):
        r, Ji, Jj = relpose_residual_jacobians(
            priors.rel_dt[k], priors.rel_dq[k],
            state.P[k - 1], state.Q[k - 1], state.P[k], state.Q[k],
        )
        S = priors.rel_sqrt[k]
        r_w = S @ r
        s = jnp.sum(r_w * r_w)
        w = _cauchy_weight(s) * priors.rel_valid[k].astype(dtype)
        c = 0.5 * _cauchy_rho(s) * priors.rel_valid[k].astype(dtype)
        return r_w * w, (S @ Ji) * w, (S @ Jj) * w, c

    ks = jnp.arange(Vo)
    rr, JJi, JJj, cc = jax.vmap(one_rel)(ks)
    oh_i = _pose_cols_onehot(ks - 1, B, dtype)  # k=0 -> one_hot(-1) = zeros: safe
    oh_j = _pose_cols_onehot(ks, B, dtype)
    Jrel = jnp.zeros((Vo, 6, D), dtype)
    Jrel = Jrel.at[:, :, : 6 * B].add(_expand_pose_block(JJi, oh_i))
    Jrel = Jrel.at[:, :, : 6 * B].add(_expand_pose_block(JJj, oh_j))
    rows.append((rr.reshape(-1), Jrel.reshape(-1, D)))
    cvecs.append(cc)

    # roll-pitch edges
    def one_rp(k):
        idx = priors.rp.idx[k]
        r, J = rollpitch_residual_jacobians(priors.rp.q_meas[k], state.Q[idx])
        S = priors.rp.sqrt_info[k]
        r_w = S @ r
        s = jnp.sum(r_w * r_w)
        w = _cauchy_weight(s) * priors.rp.valid[k].astype(dtype)
        c = 0.5 * _cauchy_rho(s) * priors.rp.valid[k].astype(dtype)
        return r_w * w, (S @ J) * w, c

    kk = jnp.arange(priors.rp.idx.shape[0])
    rr, JJ, cc = jax.vmap(one_rp)(kk)
    oh = _pose_cols_onehot(priors.rp.idx, B, dtype)
    Jrp = jnp.zeros((kk.shape[0], 2, D), dtype)
    Jrp = Jrp.at[:, :, : 6 * B].add(_expand_pose_block(JJ, oh))
    rows.append((rr.reshape(-1), Jrp.reshape(-1, D)))
    cvecs.append(cc)

    return rows, jnp.concatenate(cvecs)


def build_normal_equations(
    state: WindowState,
    imu: ImuFactors,
    proj: ProjFactors,
    priors: PriorState,
    G,
    pixel_sqrt_info,
    dims: WindowDims,
    estimate_extrinsic: bool = False,
):
    """Returns (H (D,D), b (D,), h (F,), W (F,Dr), b_l (F,), cost), with the
    landmark coupling W in the REDUCED column layout Dr = 6B+6
    ([pose | extrinsic]) — projection factors never touch speed/bias columns.

    The projection Hessian is accumulated BLOCK-WISE: per observation the
    compact 6x6 products (J_pi^T J_pj etc.) are formed first and placed into
    the (B,B) block grid with small one-hot matmuls, so the largest
    intermediate is the (N, B^2) placement one-hot instead of (N,2,6B) dense
    Jacobian rows."""
    B, F, D = dims.B, dims.F, dims.D
    Dr = 6 * B + 6
    dtype = state.P.dtype

    # named scopes: stable names for attributing device time in traces
    with jax.named_scope("imu_factors"):
        r_imu, J_imu, cv_imu = _eval_imu(state, imu, G, dims)
    with jax.named_scope("proj_factors"):
        r_proj, J_pi, J_pj, J_ex, J_dep, cv_proj, (oh_i, oh_j, oh_f) = _eval_proj(
            state, proj, pixel_sqrt_info, dims, estimate_extrinsic
        )
    prior_rows, cv_prior = _eval_priors(state, priors, dims)

    # imu + prior rows in the full layout (few rows; cheap)
    all_r = [r_imu.reshape(-1)] + [r for r, _ in prior_rows]
    all_J = [J_imu.reshape(-1, D)] + [J for _, J in prior_rows]
    Jip = jnp.concatenate(all_J, axis=0)
    rip = jnp.concatenate(all_r, axis=0)
    if not estimate_extrinsic:
        Jip = Jip * jnp.ones(D, dtype).at[15 * B :].set(0.0)[None, :]
    H = _atb(Jip, Jip)
    b = -_atb(Jip, rip)

    # ---- projection block accumulation (reduced layout) ----
    G_ii = jnp.einsum("nra,nrb->nab", J_pi, J_pi).reshape(-1, 36)
    G_jj = jnp.einsum("nra,nrb->nab", J_pj, J_pj).reshape(-1, 36)
    G_ij = jnp.einsum("nra,nrb->nab", J_pi, J_pj).reshape(-1, 36)
    g_i = jnp.einsum("nra,nr->na", J_pi, r_proj)
    g_j = jnp.einsum("nra,nr->na", J_pj, r_proj)

    diag = _atb(oh_i, G_ii) + _atb(oh_j, G_jj)  # (B, 36)
    pair = jnp.einsum("na,nb->nab", oh_i, oh_j).reshape(-1, B * B)  # (N, B^2)
    offd = _atb(pair, G_ij).reshape(B, B, 6, 6)
    # H block grid = off-diagonal (i,j) + its transpose (j,i) + diagonal
    eyeB = jnp.eye(B, dtype=dtype)
    Hblk = (
        offd
        + jnp.swapaxes(jnp.swapaxes(offd, 0, 1), 2, 3)
        + jnp.einsum("bq,bc->bcq", diag, eyeB).reshape(B, B, 6, 6)
    )
    H_pose = Hblk.transpose(0, 2, 1, 3).reshape(6 * B, 6 * B)
    b_pose = -(_atb(oh_i, g_i) + _atb(oh_j, g_j)).reshape(6 * B)

    H = H.at[: 6 * B, : 6 * B].add(H_pose)
    b = b.at[: 6 * B].add(b_pose)

    # landmark coupling rows (compact): w into block i / block j, ex tail
    wi = jnp.einsum("nr,nra->na", J_dep, J_pi)  # (N,6)
    wj = jnp.einsum("nr,nra->na", J_dep, J_pj)
    Wrows = (
        jnp.einsum("na,nb->nba", wi, oh_i) + jnp.einsum("na,nb->nba", wj, oh_j)
    ).reshape(-1, 6 * B)

    if estimate_extrinsic:
        G_ie = jnp.einsum("nra,nrb->nab", J_pi, J_ex).reshape(-1, 36)
        G_je = jnp.einsum("nra,nrb->nab", J_pj, J_ex).reshape(-1, 36)
        G_ee = jnp.einsum("nra,nrb->ab", J_ex, J_ex)
        g_e = jnp.einsum("nra,nr->a", J_ex, r_proj)
        E = (_atb(oh_i, G_ie) + _atb(oh_j, G_je)).reshape(B, 6, 6)
        E_rows = E.transpose(0, 1, 2).reshape(6 * B, 6)
        H = H.at[: 6 * B, 15 * B :].add(E_rows)
        H = H.at[15 * B :, : 6 * B].add(E_rows.T)
        H = H.at[15 * B :, 15 * B :].add(G_ee)
        b = b.at[15 * B :].add(-g_e)
        we = jnp.einsum("nr,nra->na", J_dep, J_ex)
        Wrows = jnp.concatenate([Wrows, we], axis=1)
    else:
        H = H.at[15 * B :, 15 * B :].add(jnp.eye(6, dtype=dtype))
        Wrows = jnp.concatenate(
            [Wrows, jnp.zeros((Wrows.shape[0], 6), dtype)], axis=1
        )

    # landmark system: per-feature scalar Hessian + coupling row (reduced).
    # One (F x N)(N x Dr+2) one-hot matmul replaces three segment_sum
    # scatters.
    payload = jnp.concatenate(
        [
            jnp.sum(J_dep * J_dep, axis=-1, keepdims=True),
            Wrows,
            -jnp.sum(J_dep * r_proj, axis=-1, keepdims=True),
        ],
        axis=1,
    )  # (N, 1 + Dr + 1)
    agg = _atb(oh_f, payload)  # (F, Dr + 2)
    h = agg[:, 0]
    W = agg[:, 1 : 1 + Dr]
    b_l = agg[:, 1 + Dr]

    cost = jnp.sum(jnp.concatenate([cv_imu, cv_proj, cv_prior]))
    return H, b, h, W, b_l, cost


@functools.partial(jax.jit, static_argnames=("dims",))
def window_cost(state, imu, proj, priors, G, pixel_sqrt_info, dims):
    """Robust cost only (cheap path for LM accept tests). Jitted: the
    internals vmap over edge indices, which requires traced (or jnp) operand
    leaves — host callers pass numpy pytrees."""
    _, _, cv_imu = _eval_imu(state, imu, G, dims)
    cv_proj = _eval_proj(state, proj, pixel_sqrt_info, dims)[5]
    _, cv_prior = _eval_priors(state, priors, dims)
    return jnp.sum(jnp.concatenate([cv_imu, cv_proj, cv_prior]))


def lm_linear_step(H, b, h, W, b_l, lam, dims: WindowDims):
    """One damped LM step of the reduced system: Schur-eliminate the
    landmarks, damp, Cholesky-solve the (D, D) pose system and back-substitute
    the landmark increments. W is (F, Dr) in the reduced [pose | ex] layout;
    its Schur correction touches only those rows/cols of the full system.
    Returns (dx (D,), dl (F,))."""
    B, D = dims.B, dims.D
    dtype = H.dtype
    h_d = h * (1.0 + lam)
    h_safe = jnp.where(h_d > 1e-12, h_d, 1.0)
    with jax.named_scope("schur_correction"):
        C = _atb(W, W / h_safe[:, None])  # (Dr, Dr)
        c_b = _atb(W, b_l / h_safe)  # (Dr,)
    H_s = H
    H_s = H_s.at[: 6 * B, : 6 * B].add(-C[: 6 * B, : 6 * B])
    H_s = H_s.at[: 6 * B, 15 * B :].add(-C[: 6 * B, 6 * B :])
    H_s = H_s.at[15 * B :, : 6 * B].add(-C[6 * B :, : 6 * B])
    H_s = H_s.at[15 * B :, 15 * B :].add(-C[6 * B :, 6 * B :])
    b_s = b.at[: 6 * B].add(-c_b[: 6 * B])
    b_s = b_s.at[15 * B :].add(-c_b[6 * B :])
    diagH = jnp.clip(jnp.diag(H), 1e-8, None)
    H_d = H_s + jnp.diag(lam * diagH)
    L = jnp.linalg.cholesky(H_d + 1e-12 * jnp.trace(H_d) / D * jnp.eye(D, dtype=dtype))
    dx = jax.scipy.linalg.cho_solve((L, True), b_s)
    dx_r = jnp.concatenate([dx[: 6 * B], dx[15 * B :]])
    dl = (b_l - W @ dx_r) / h_safe
    return dx, dl


@functools.partial(jax.jit, static_argnames=("dims", "iters", "estimate_extrinsic"))
def solve_window(
    state: WindowState,
    imu: ImuFactors,
    proj: ProjFactors,
    priors: PriorState,
    G,
    pixel_sqrt_info,
    dims: WindowDims,
    iters: int = 10,
    estimate_extrinsic: bool = False,
    init_lambda: float = 1e-4,
):
    """Levenberg–Marquardt with landmark Schur elimination; branchless
    accept/reject in a while_loop with a convergence early-out (the
    reference caps the solve at 8 ms / 10 iters, estimator.cpp:1124–1125 —
    easy frames converge in 3-5 iterations and the remaining budget is free
    latency). Returns (state, final_cost)."""
    dtype = state.P.dtype

    # One factor evaluation per LM iteration: the normal equations built at
    # the accepted state are carried in the loop; a trial's evaluation is
    # reused as the next linearization when accepted (vs the naive
    # build+cost-check structure which evaluates every factor twice).
    def build(st):
        return build_normal_equations(
            st, imu, proj, priors, G, pixel_sqrt_info, dims, estimate_extrinsic
        )

    def cond(carry):
        i, done, *_ = carry
        return (i < iters) & ~done

    def body(carry):
        i, done, st, ne, lam = carry
        H, b, h, W, b_l, cost0 = ne
        with jax.named_scope("lm_linear_step"):
            dx, dl = lm_linear_step(H, b, h, W, b_l, lam, dims)
        trial = retract_state(st, dx, dl, dims)
        ne_trial = build(trial)
        cost1 = ne_trial[-1]
        ok = (cost1 < cost0) & jnp.isfinite(cost1)
        new_state = jax.tree_util.tree_map(
            lambda a, bb: jnp.where(ok, bb, a), st, trial
        )
        new_ne = jax.tree_util.tree_map(
            lambda a, bb: jnp.where(ok, bb, a), ne, ne_trial
        )
        new_lam = jnp.where(ok, jnp.maximum(lam * 0.4, 1e-9), jnp.minimum(lam * 8.0, 1e6))
        # early-out: an accepted step with negligible relative decrease means
        # the iterate is converged (Ceres function_tolerance semantics)
        converged = ok & (cost0 - cost1 < 1e-6 * jnp.maximum(cost0, 1e-30))
        return i + 1, converged, new_state, new_ne, new_lam

    lam0 = jnp.asarray(init_lambda, dtype)
    ne0 = build(state)
    _, _, state, ne, lam = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), jnp.asarray(False), state, ne0, lam0)
    )
    return state, ne[-1]
