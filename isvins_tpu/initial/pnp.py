"""Perspective-n-Point via damped Gauss-Newton on SE(3), batched-friendly.

Replaces cv::solvePnP(iterative, useExtrinsicGuess) used by the SfM chain
(estimator.cpp:333) and initial_sfm.cpp:73, and cv::solvePnPRansac used by
loop verification (keyframe.cpp:201). The GN variant needs an initial guess
(always available in both call sites: the neighboring frame / the old
keyframe pose); the RANSAC variant wraps it with minimal-subset restarts and
inlier refit for robustness to outliers.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..geom import quat_mul, quat_normalize, quat_rotate, quat_conj, so3_exp_quat, skew, quat_to_mat


@jax.jit
def _pnp_gn_core(pts3d, pts2d, w, q_cw, t_cw, iters: int = 10):
    """Minimize sum w_i |proj(R_cw X_i + t_cw) - uv_i|^2 over (q_cw, t_cw)
    (world-to-camera). Damped GN, fixed iterations, branchless."""

    def residual_jac(q, t):
        def one(X, uv):
            pc = quat_rotate(q, X) + t
            z = jnp.where(jnp.abs(pc[2]) > 1e-6, pc[2], 1e-6)
            r = pc[:2] / z - uv
            # d(proj)/d(pc)
            red = jnp.array(
                [[1.0 / z, 0.0, -pc[0] / (z * z)], [0.0, 1.0 / z, -pc[1] / (z * z)]],
                pc.dtype,
            )
            # pc = R X + t; right-perturbation on R: d(pc)/dtheta = -R [X]x
            J_t = red
            J_r = red @ (quat_to_mat(q) @ (-skew(X)))
            return r, jnp.concatenate([J_t, J_r], axis=1)  # (2,), (2,6)

        r, J = jax.vmap(one)(pts3d, pts2d)
        return r * w[:, None], J * w[:, None, None]

    def body(_, carry):
        q, t = carry
        r, J = residual_jac(q, t)
        Jf = J.reshape(-1, 6)
        rf = r.reshape(-1)
        H = Jf.T @ Jf + 1e-8 * jnp.eye(6, dtype=Jf.dtype)
        g = -(Jf.T @ rf)
        # Cholesky instead of LU: H is SPD
        dx = jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(H), True), g)
        t_new = t + dx[:3]
        q_new = quat_normalize(quat_mul(q, so3_exp_quat(dx[3:])))
        return q_new, t_new

    q, t = jax.lax.fori_loop(0, iters, body, (q_cw, t_cw))
    r, _ = residual_jac(q, t)
    return q, t, jnp.sum(r * r, axis=-1)


def pnp_gn(pts3d, pts2d, q_cw0, t_cw0, weights=None, iters: int = 10):
    """pts3d (n,3) world, pts2d (n,2) normalized-plane. Initial guess
    (q_cw0, t_cw0) world-to-camera. Returns (q_cw, t_cw, per-point sq err)."""
    pts3d = jnp.asarray(pts3d)
    pts2d = jnp.asarray(pts2d)
    n = pts3d.shape[0]
    w = jnp.ones(n, pts3d.dtype) if weights is None else jnp.asarray(weights)
    return _pnp_gn_core(pts3d, pts2d, w, jnp.asarray(q_cw0), jnp.asarray(t_cw0), iters)


@jax.jit
def _pnp_dlt(pts3d, pts2d, w):
    """Closed-form weighted DLT PnP (EPnP-class, initialization-free): solve
    min ||A p|| for the 3x4 projection matrix from >= 6 weighted
    correspondences, then extract (q_cw, t_cw) by orthogonalizing the
    rotation block. Needed because GN-from-guess RANSAC restarts cannot
    verify a loop once VIO drift exceeds the GN convergence basin (the
    reference's cv::solvePnPRansac hypothesizes with initialization-free
    EPnP/P3P, keyframe.cpp:196–204)."""
    n = pts3d.shape[0]
    dtype = pts3d.dtype
    X = jnp.concatenate([pts3d, jnp.ones((n, 1), dtype)], axis=1)  # (n,4)
    u = pts2d[:, 0]
    v = pts2d[:, 1]
    Z4 = jnp.zeros((n, 4), dtype)
    row_u = jnp.concatenate([X, Z4, -u[:, None] * X], axis=1)  # (n,12)
    row_v = jnp.concatenate([Z4, X, -v[:, None] * X], axis=1)
    A = jnp.concatenate([row_u * w[:, None], row_v * w[:, None]], axis=0)
    # smallest right singular vector via eigh of A^T A (12x12)
    ATA = A.T @ A
    evals, evecs = jnp.linalg.eigh(ATA)
    p = evecs[:, 0]
    P = p.reshape(3, 4)
    M = P[:, :3]
    # sign: majority of weighted points must land in front of the camera
    z = X @ P[2]
    sgn = jnp.where(jnp.sum(jnp.sign(z) * w) >= 0, 1.0, -1.0).astype(dtype)
    M = M * sgn
    m = P[:, 3] * sgn
    # orthogonalize: M = s R with R in SO(3); det(UV^T) = -1 means s < 0
    U, S, Vt = jnp.linalg.svd(M)
    detUV = jnp.linalg.det(U @ Vt)
    R = U @ jnp.diag(jnp.stack([jnp.ones((), dtype), jnp.ones((), dtype), detUV])) @ Vt
    s = jnp.mean(S) * detUV
    t = m / jnp.where(jnp.abs(s) > 1e-12, s, 1e-12)
    q = mat_to_quat_safe(R)
    return q, t


def mat_to_quat_safe(R):
    from ..geom import mat_to_quat

    return quat_normalize(mat_to_quat(R))


@jax.jit
def _pnp_ransac_rounds(pts3d, pts2d, W, q_cw0, t_cw0):
    """All RANSAC hypotheses as ONE vmapped program (W (R,n) per-round weight
    rows). Row 0 keeps the legacy GN-from-guess behavior (exploits a good
    initial guess when one exists); every other row hypothesizes
    initialization-free via weighted DLT on its subset, then GN-polishes on
    the subset. Every hypothesis is scored against all points.
    Returns (R,n) squared errors."""

    def one(i, w):
        use_guess = i == 0

        def from_guess(_):
            return q_cw0, t_cw0

        def from_dlt(_):
            return _pnp_dlt(pts3d, pts2d, w)

        q0, t0 = jax.lax.cond(use_guess, from_guess, from_dlt, None)
        q, t, _ = _pnp_gn_core(pts3d, pts2d, w, q0, t0, 10)
        _, _, errs = _pnp_gn_core(pts3d, pts2d, jnp.ones_like(w), q, t, 0)
        return errs, q, t

    R = W.shape[0]
    return jax.vmap(one)(jnp.arange(R), W)


def pnp_ransac_gn(
    pts3d,
    pts2d,
    q_cw0,
    t_cw0,
    thresh: float = 10.0 / 460.0,
    n_rounds: int = 96,
    min_set: int = 6,
    min_inliers: int = 5,
    iters: int = 10,
    seed: int = 0,
):
    """Robust PnP: initialization-free DLT hypotheses on random minimal
    subsets (all rounds batched through one vmapped device program), score
    by inlier count, refit on the best inlier set FROM the best hypothesis —
    the provided (q_cw0, t_cw0) guess is only one hypothesis (row 0), so
    verification still succeeds when the guess is arbitrarily far (loop
    closure after meters of VIO drift; the reference's cv::solvePnPRansac is
    likewise hypothesis-driven, keyframe.cpp:196–204).

    min_set=6 (DLT minimal+1): at 90% inlier matches (match_descriptors_clean)
    a 6-subset is all-inlier with p=0.53/round; even at 50% contamination
    96 rounds give >75% success. Returns (ok, q_cw, t_cw, inlier_mask)."""
    pts3d = np.asarray(pts3d)
    pts2d = np.asarray(pts2d)[:, :2]
    n = len(pts3d)
    if n < min_set:
        return False, np.asarray(q_cw0), np.asarray(t_cw0), np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    t2 = thresh * thresh

    # pad to a pow-2-ish bucket so the jitted round program compiles once per
    # bucket, not once per distinct match count
    nb = 8
    while nb < n:
        nb *= 2
    p3 = np.concatenate([pts3d, np.tile([[0.0, 0.0, 1.0]], (nb - n, 1))])
    p2 = np.concatenate([pts2d, np.zeros((nb - n, 2))])
    W = np.zeros((n_rounds, nb))
    W[0, :n] = 1.0  # round 0: plain GN on everything from the guess
    for r_i in range(1, n_rounds):
        W[r_i, rng.choice(n, size=min(min_set, n), replace=False)] = 1.0
    errs, qs, ts = _pnp_ransac_rounds(
        jnp.asarray(p3), jnp.asarray(p2), jnp.asarray(W),
        jnp.asarray(q_cw0), jnp.asarray(t_cw0),
    )
    errs = np.asarray(errs)[:, :n]
    inl_all = errs < t2
    best = int(np.argmax(inl_all.sum(axis=1)))
    best_inl = inl_all[best]
    if best_inl.sum() < max(min_set, min_inliers):
        return False, np.asarray(q_cw0), np.asarray(t_cw0), np.zeros(n, bool)
    q, t, _ = pnp_gn(
        pts3d, pts2d, np.asarray(qs[best]), np.asarray(ts[best]),
        weights=best_inl.astype(float), iters=iters,
    )
    errs_all = np.asarray(pnp_gn(pts3d, pts2d, q, t, weights=np.ones(n), iters=0)[2])
    inl = errs_all < t2
    return True, np.asarray(q), np.asarray(t), inl
