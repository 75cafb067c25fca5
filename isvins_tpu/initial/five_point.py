"""Relative pose from 2D-2D correspondences on the normalized plane.

Replaces the reference's cv::findFundamentalMat(RANSAC) + recoverPose
(src/initial/solve_5pts.cpp:193–227) with a batched 8-point essential
matrix RANSAC: all hypotheses are solved as one vmapped batch of 8x9 SVDs,
scored with Sampson distances in one (S, n) broadcast, and the winner's
inlier set is refit. On calibrated (normalized-plane) coordinates the
fundamental matrix IS the essential matrix, so the 8-point algorithm +
rank-2/unit-singular-value projection is the standard linear solver.

Returns the pose of camera 2 expressed in camera 1 (same convention the
reference hands to GlobalSFM: R = rot^T, T = -rot^T t, solve_5pts.cpp:219–224).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _eight_point(p1, p2):
    """p1, p2: (8,2) -> E (3,3) with enforced essential structure."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    one = jnp.ones_like(x1)
    # rows: [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1] for x2^T E x1 = 0
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )
    _, _, Vh = jnp.linalg.svd(A, full_matrices=True)
    E = Vh[-1].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], E.dtype)) @ Vt
    return E


def epipolar_inliers(p1, p2, valid, samples, thresh_sq):
    """Epipolar inlier classification for the tracker's outlier rejection,
    SVD-FREE (the eigh-of-Gram nullspace) so it runs in f32 inside the
    tracker's fused device step. Hypotheses from `samples` (S,8) row indices into
    p1/p2; each 8-point solve is the smallest eigenvector of A^T A (9x9
    symmetric eigh, batched). The rank-2 essential projection is SKIPPED —
    for inlier CLASSIFICATION the nullspace E's Sampson distances separate
    at the same threshold (the projection moves E by O(sigma), far below
    the decision boundary), and it would need the 3x3 SVD we are avoiding.
    Invalid rows drawn into a hypothesis poison only that hypothesis (huge
    residuals -> low score -> loses the argmax).

    Returns (inlier_mask (n,), n_inliers) — mask is False outside `valid`.
    """
    def solve_null(pa, pb):
        x1, y1 = pa[:, 0], pa[:, 1]
        x2, y2 = pb[:, 0], pb[:, 1]
        one = jnp.ones_like(x1)
        A = jnp.stack(
            [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
        )
        G = A.T @ A
        _, V = jnp.linalg.eigh(G)
        return V[:, 0].reshape(3, 3)

    Es = jax.vmap(lambda idx: solve_null(p1[idx], p2[idx]))(samples)
    d = jax.vmap(lambda E: _sampson_sq(E, p1, p2))(Es)  # (S,n)
    inl = (d < thresh_sq) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    # refit on the best hypothesis' inliers (weighted 8-point, eigh again)
    w = inl[best].astype(p1.dtype)
    n = p1.shape[0]
    x1 = jnp.concatenate([p1, jnp.ones((n, 1), p1.dtype)], axis=1)
    x2 = jnp.concatenate([p2, jnp.ones((n, 1), p1.dtype)], axis=1)
    A = jnp.einsum("ni,nj->nij", x2, x1).reshape(n, 9) * w[:, None]
    G = A.T @ A
    _, V = jnp.linalg.eigh(G)
    E = V[:, 0].reshape(3, 3)
    d2 = _sampson_sq(E, p1, p2)
    inl2 = (d2 < thresh_sq) & valid
    return inl2, jnp.sum(inl2)


def _sampson_sq(E, p1, p2):
    """Squared Sampson distance for all correspondences. p* (n,2)."""
    n = p1.shape[0]
    x1 = jnp.concatenate([p1, jnp.ones((n, 1), p1.dtype)], axis=1)
    x2 = jnp.concatenate([p2, jnp.ones((n, 1), p1.dtype)], axis=1)
    Ex1 = x1 @ E.T  # (n,3)
    Etx2 = x2 @ E  # (n,3)
    num = jnp.sum(x2 * Ex1, axis=1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _triangulate_pair(R, t, p1, p2):
    """Midpoint-free linear triangulation: cam1 at identity, cam2 = (R, t)
    world-to-cam. Returns depths in cam1 and cam2. p* (n,2)."""
    n = p1.shape[0]
    f1 = jnp.concatenate([p1, jnp.ones((n, 1), p1.dtype)], axis=1)
    f2 = jnp.concatenate([p2, jnp.ones((n, 1), p1.dtype)], axis=1)
    # solve min |d1 (R f1) + t - d2 f2|^2 over (d1, d2):
    #   [[a, b], [b, c]] [d1, d2] = [rhs1, rhs2]
    Rf1 = f1 @ R.T
    a = jnp.sum(Rf1 * Rf1, axis=1)
    b = -jnp.sum(Rf1 * f2, axis=1)
    c = jnp.sum(f2 * f2, axis=1)
    rhs1 = -jnp.sum(Rf1 * t, axis=1)
    rhs2 = jnp.sum(f2 * t, axis=1)
    det = a * c - b * b
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    d1 = (c * rhs1 - b * rhs2) / det
    d2 = (a * rhs2 - b * rhs1) / det
    return d1, d2


def _decompose_and_vote(E, p1, p2, inl):
    """4 candidate (R,t) from E; pick by cheirality vote over inliers.
    Returns (R_21, t_21) world-to-cam2 with cam1 as world."""
    U, _, Vt = jnp.linalg.svd(E)
    detfix_U = jnp.sign(jnp.linalg.det(U))
    detfix_V = jnp.sign(jnp.linalg.det(Vt))
    U = U * detfix_U
    Vt = Vt * detfix_V
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]

    def vote(R, tt):
        d1, d2 = _triangulate_pair(R, tt, p1, p2)
        return jnp.sum(((d1 > 0) & (d2 > 0)) & inl)

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    votes = jnp.stack([vote(R, tt) for R, tt in cands])
    best = jnp.argmax(votes)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return Rs[best], ts[best], votes[best]


@jax.jit
def _ransac_core(p1, p2, valid, samples, thresh_sq):
    Es = jax.vmap(lambda idx: _eight_point(p1[idx], p2[idx]))(samples)
    d = jax.vmap(lambda E: _sampson_sq(E, p1, p2))(Es)  # (S,n)
    inl = (d < thresh_sq) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    E_best = Es[best]
    inl_best = inl[best]

    # refit on inliers (weighted 8-point over all points)
    n = p1.shape[0]
    x1 = jnp.concatenate([p1, jnp.ones((n, 1), p1.dtype)], axis=1)
    x2 = jnp.concatenate([p2, jnp.ones((n, 1), p1.dtype)], axis=1)
    A = jnp.einsum("ni,nj->nij", x2, x1).reshape(n, 9)
    A = A * inl_best[:, None]
    _, _, Vh = jnp.linalg.svd(A, full_matrices=True)
    E = Vh[-1].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], E.dtype)) @ Vt

    d2 = _sampson_sq(E, p1, p2)
    inl2 = (d2 < thresh_sq) & valid
    R21, t21, votes = _decompose_and_vote(E, p1, p2, inl2)
    return R21, t21, inl2, jnp.sum(inl2), votes


def solve_translation_with_rotation(pts1, pts2, R, thresh: float = 1.0 / 460.0,
                                    iters: int = 3, min_inliers: int = 12):
    """Relative translation direction given a known relative rotation.

    (R, returned T) = pose of cam2 in cam1, same convention as
    solve_relative_pose. With R fixed (e.g. transported from gyro
    preintegration), each correspondence gives one LINEAR constraint
    c_i · t21 = 0 with c_i = (R21 x1_i) x x2_i — a 3-dof SVD problem that is
    immune to the planar degeneracy that breaks 8-point E estimation on
    wall-dominated views (the indoor-normal case). Robustified by IRLS
    trimming on Sampson distance; sign fixed by cheirality.

    This is the VIO-native seed the reference's pure-vision
    cv::findFundamentalMat path lacks (solve_5pts.cpp:193–227): by
    initialization time gyro preintegration is available and its bias error
    (< a few mrad over a window) is far below 8-point noise on ~25 clustered
    correspondences."""
    pts1 = np.asarray(pts1)[:, :2]
    pts2 = np.asarray(pts2)[:, :2]
    n = len(pts1)
    if n < min_inliers:
        return False, R, np.zeros(3), np.zeros(n, bool)
    R21 = np.asarray(R).T
    x1 = np.concatenate([pts1, np.ones((n, 1))], axis=1)
    x2 = np.concatenate([pts2, np.ones((n, 1))], axis=1)
    Rx1 = x1 @ R21.T
    C = np.cross(Rx1, x2)  # rows c_i
    keep = np.ones(n, bool)
    t21 = None
    for _ in range(iters):
        if keep.sum() < 3:
            return False, R, np.zeros(3), np.zeros(n, bool)
        _, _, Vt = np.linalg.svd(C[keep], full_matrices=True)
        t21 = Vt[-1]
        tx = np.array([[0.0, -t21[2], t21[1]],
                       [t21[2], 0.0, -t21[0]],
                       [-t21[1], t21[0], 0.0]])
        E = tx @ R21  # [t21]x R21
        d = np.asarray(_sampson_sq(jnp.asarray(E), jnp.asarray(pts1), jnp.asarray(pts2)))
        keep = d < thresh * thresh
    inl = keep
    if inl.sum() < min_inliers:
        return False, R, np.zeros(3), inl
    # cheirality: triangulate inliers, flip t if depths vote negative
    d1, d2 = _triangulate_pair(
        jnp.asarray(R21), jnp.asarray(t21), jnp.asarray(pts1), jnp.asarray(pts2)
    )
    pos = int(np.sum(((np.asarray(d1) > 0) & (np.asarray(d2) > 0)) & inl))
    neg = int(np.sum(((np.asarray(d1) < 0) & (np.asarray(d2) < 0)) & inl))
    if neg > pos:
        t21 = -t21
    T = -np.asarray(R21).T @ t21  # T = -R21^T t21: cam2 position in cam1
    return True, np.asarray(R), T, inl


def solve_relative_pose(
    pts1,
    pts2,
    thresh: float = 0.3 / 460.0,
    n_hyp: int = 256,
    min_inliers: int = 15,
    seed: int = 0,
):
    """pts1, pts2: (n, 2|3) normalized-plane correspondences (camera 1 and 2).
    Returns (ok, R, T, inlier_mask) with (R, T) = pose of cam2 in cam1 frame
    (solve_5pts.cpp convention). Mirrors the reference gates: needs >= 15
    correspondences and > 12 inliers (:206, :225)."""
    pts1 = np.asarray(pts1)[:, :2]
    pts2 = np.asarray(pts2)[:, :2]
    n = len(pts1)
    if n < max(15, 8):
        return False, np.eye(3), np.zeros(3), np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    samples = np.stack([rng.choice(n, size=8, replace=False) for _ in range(n_hyp)])
    R21, t21, inl, n_inl, votes = _ransac_core(
        jnp.asarray(pts1), jnp.asarray(pts2), jnp.ones(n, bool),
        jnp.asarray(samples), thresh * thresh,
    )
    if int(n_inl) <= 12 or int(votes) < 0.5 * int(n_inl):
        return False, np.eye(3), np.zeros(3), np.asarray(inl)
    # convert world-to-cam2 -> pose of cam2 in cam1: R = R21^T, T = -R21^T t
    R = np.asarray(R21).T
    T = -R @ np.asarray(t21)
    return True, R, T, np.asarray(inl)
