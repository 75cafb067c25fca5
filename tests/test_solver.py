"""Window solver convergence on synthetic BA with known optimum
(SURVEY.md §7 stage 2 milestone)."""

import numpy as np
import jax.numpy as jnp

import isvins_tpu  # noqa: F401
from isvins_tpu.config import euroc_config
from isvins_tpu.factors import ImuNoise, integrate_segment
from isvins_tpu.geom import quat_conj, quat_mul, quat_normalize, quat_rotate, so3_exp_quat
from isvins_tpu.solver import (
    ImuFactors,
    PriorState,
    ProjFactors,
    WindowDims,
    WindowState,
    solve_window,
)
from isvins_tpu.utils.synthetic import make_world, project

import jax


def build_problem(B=10, F=128, N=1024, n_landmarks=120, seed=0, px_noise=0.0):
    cfg = euroc_config()
    world = make_world(n_frames=B, n_landmarks=n_landmarks, seed=seed)
    tic = np.array([0.02, -0.01, 0.01])
    # forward camera: camera z -> body x, camera x -> -body y, camera y -> -body z
    from isvins_tpu.geom import mat_to_quat
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    qic = np.asarray(mat_to_quat(jnp.asarray(R_bc)))
    rng = np.random.default_rng(seed + 1)

    # observations: host frame = first visible frame
    pts_all, vis_all = [], []
    for k in range(B):
        pts, depth, vis = project(world, k, tic, qic, px_noise=px_noise, rng=rng)
        pts_all.append(pts)
        vis_all.append(vis)
    vis_all = np.array(vis_all)  # (B,M)

    idx_i, idx_j, fidx, pi_l, pj_l = [], [], [], [], []
    dep = np.zeros(F)
    fslot = 0
    M = world.landmarks.shape[0]
    for m in range(M):
        frames = np.where(vis_all[:, m])[0]
        if len(frames) < 2 or fslot >= F:
            continue
        host = frames[0]
        # GT inverse depth in host camera
        _, depth_host, _ = project(world, host, tic, qic)
        dep[fslot] = 1.0 / depth_host[m]
        for j in frames[1:]:
            idx_i.append(host)
            idx_j.append(j)
            fidx.append(fslot)
            pi_l.append(pts_all[host][m])
            pj_l.append(pts_all[j][m])
        fslot += 1

    n = len(idx_i)
    assert n <= N
    pad = N - n
    proj_f = ProjFactors(
        idx_i=jnp.asarray(np.concatenate([idx_i, np.zeros(pad)]).astype(np.int32)),
        idx_j=jnp.asarray(np.concatenate([idx_j, np.ones(pad)]).astype(np.int32)),
        fidx=jnp.asarray(np.concatenate([fidx, np.zeros(pad)]).astype(np.int32)),
        pts_i=jnp.asarray(
            np.concatenate([np.array(pi_l).reshape(-1, 3), np.tile([[0, 0, 1.0]], (pad, 1))])
        ),
        pts_j=jnp.asarray(
            np.concatenate([np.array(pj_l).reshape(-1, 3), np.tile([[0, 0, 1.0]], (pad, 1))])
        ),
        valid=jnp.asarray(np.concatenate([np.ones(n), np.zeros(pad)]).astype(bool)),
    )

    noise = ImuNoise.from_config(cfg.noise)
    pre = jax.vmap(
        lambda d, a, g, a0, g0: integrate_segment(
            d, a, g, a0, g0, jnp.zeros(3), jnp.zeros(3), noise
        )
    )(
        jnp.asarray(world.imu_dts),
        jnp.asarray(world.imu_accs),
        jnp.asarray(world.imu_gyrs),
        jnp.asarray(world.imu_acc0),
        jnp.asarray(world.imu_gyr0),
    )
    imu_f = ImuFactors.create(pre=pre, valid=jnp.ones(B - 1, bool))

    gt = WindowState(
        P=jnp.asarray(world.P), Q=jnp.asarray(world.Q), V=jnp.asarray(world.V),
        Ba=jnp.zeros((B, 3)), Bg=jnp.zeros((B, 3)),
        tic=jnp.asarray(tic), qic=jnp.asarray(qic), dep=jnp.asarray(dep),
    )
    dims = WindowDims(B=B, Vo=4, F=F, N=N)
    return cfg, world, gt, imu_f, proj_f, dims, fslot


def anchored_priors(gt, dims):
    """Strong SE3 + VB priors to pin the 4-dof gauge for absolute comparison."""
    pr = PriorState.empty(dims.Vo)
    pr = pr._replace(
        se3_t=gt.P[0], se3_q=gt.Q[0], se3_sqrt=jnp.eye(6) * 1e3,
        se3_valid=jnp.asarray(True),
        vb=jnp.concatenate([gt.V[0], gt.Ba[0], gt.Bg[0]]),
        vb_sqrt=jnp.eye(9) * 1e2, vb_valid=jnp.asarray(True),
    )
    # VB prior acts on frame Vo-1 per problem structure; re-anchor to that frame
    k = dims.Vo - 1
    pr = pr._replace(vb=jnp.concatenate([gt.V[k], gt.Ba[k], gt.Bg[k]]))
    return pr


def perturb(gt, rng, pos=0.05, rot=0.02, vel=0.05, dep_rel=0.1):
    B = gt.P.shape[0]
    dQ = so3_exp_quat(jnp.asarray(rng.normal(size=(B, 3)) * rot))
    return gt._replace(
        P=gt.P + jnp.asarray(rng.normal(size=(B, 3)) * pos),
        Q=quat_normalize(quat_mul(gt.Q, dQ)),
        V=gt.V + jnp.asarray(rng.normal(size=(B, 3)) * vel),
        dep=gt.dep * (1.0 + jnp.asarray(rng.normal(size=gt.dep.shape) * dep_rel)),
    )


def test_solver_converges_to_gt():
    cfg, world, gt, imu_f, proj_f, dims, n_feat = build_problem()
    rng = np.random.default_rng(7)
    pr = anchored_priors(gt, dims)
    x0 = perturb(gt, rng)

    G = jnp.asarray(world.gravity)
    psi = jnp.asarray(cfg.noise.pixel_sqrt_info)
    x1, cost = solve_window(x0, imu_f, proj_f, pr, G, psi, dims, iters=15)

    # position error
    e0 = np.abs(np.asarray(x0.P) - np.asarray(gt.P)).max()
    e1 = np.abs(np.asarray(x1.P) - np.asarray(gt.P)).max()
    assert e1 < 2e-3, (e0, e1, float(cost))
    # rotation error via quaternion dot
    qdot = np.abs(np.sum(np.asarray(x1.Q) * np.asarray(gt.Q), axis=-1))
    assert np.all(qdot > 1.0 - 1e-6)
    # depths recovered
    d1 = np.asarray(x1.dep)[:n_feat]
    dg = np.asarray(gt.dep)[:n_feat]
    assert np.abs(d1 - dg).max() < 1e-2


def test_solver_with_pixel_noise_reduces_cost():
    cfg, world, gt, imu_f, proj_f, dims, _ = build_problem(px_noise=1.0 / 460.0, seed=3)
    rng = np.random.default_rng(8)
    pr = anchored_priors(gt, dims)
    x0 = perturb(gt, rng)
    G = jnp.asarray(world.gravity)
    psi = jnp.asarray(cfg.noise.pixel_sqrt_info)

    from isvins_tpu.solver import window_cost
    c0 = float(window_cost(x0, imu_f, proj_f, pr, G, psi, dims))
    x1, c1 = solve_window(x0, imu_f, proj_f, pr, G, psi, dims, iters=15)
    assert float(c1) < 0.1 * c0
    # with noise, should still land close to GT
    e1 = np.abs(np.asarray(x1.P) - np.asarray(gt.P)).max()
    assert e1 < 0.05, e1


def test_fast_proj_matches_reference(rng):
    """Component-planes fast path vs the reference-faithful vmapped path."""
    from isvins_tpu.solver.proj_fast import eval_proj_rows
    from isvins_tpu.factors.projection import projection_residual_jacobians

    cfg, world, gt, imu_f, proj_f, dims, _ = build_problem(seed=11)
    n = int(np.asarray(proj_f.valid).sum())
    Pi = gt.P[proj_f.idx_i]
    Qi = gt.Q[proj_f.idx_i]
    Pj = gt.P[proj_f.idx_j]
    Qj = gt.Q[proj_f.idx_j]
    dep = gt.dep[proj_f.fidx]
    r, J_pi, J_pj, J_dep = eval_proj_rows(
        proj_f.pts_i, proj_f.pts_j, Pi, Qi, Pj, Qj, gt.tic, gt.qic, dep, proj_f.valid
    )

    def one(k):
        return projection_residual_jacobians(
            proj_f.pts_i[k], proj_f.pts_j[k], Pi[k], Qi[k], Pj[k], Qj[k],
            gt.tic, gt.qic, dep[k],
        )

    for k in [0, 1, n // 2, n - 1]:
        r_ref, Jpi_ref, Jpj_ref, _, Jd_ref = one(k)
        np.testing.assert_allclose(np.asarray(r[k]), np.asarray(r_ref), atol=1e-10)
        np.testing.assert_allclose(np.asarray(J_pi[k]), np.asarray(Jpi_ref), atol=1e-9)
        np.testing.assert_allclose(np.asarray(J_pj[k]), np.asarray(Jpj_ref), atol=1e-9)
        np.testing.assert_allclose(np.asarray(J_dep[k]), np.asarray(Jd_ref), atol=1e-9)


def test_product_width_float32_solve_within_float64_bound():
    """The float32 product-width window solve stays within the stated bound
    of the float64 solve of the same inputs (the chip smoke check's
    window_solve phase, here on the CPU backend)."""
    from isvins_tpu.solver import reference as ref

    args = ref.product_problem()
    dev = ref.deviation(ref.solve(args), ref.solve(ref.as_float64(args)))
    assert ref.within(dev), (dev, ref.F32_TOL)
    assert dev["P"] > 0.0  # the two precisions really ran


def test_lm_linear_step_matches_dense_float64_solve(rng):
    """Schur elimination + damped Cholesky + back-substitution equals the
    damped full (pose + landmark) system solved densely in float64."""
    from isvins_tpu.solver.window import lm_linear_step

    dims = WindowDims(B=6, Vo=3, F=40, N=0)
    B, D, F = dims.B, dims.D, dims.F
    Dr = 6 * B + 6
    red = np.r_[np.arange(6 * B), np.arange(15 * B, D)]  # reduced [pose | ex]
    # a random SPD full system [[H, W^T], [W, diag(h)]] in the solver layout
    A = rng.normal(size=(D + F, D + F + 30))
    M = A @ A.T + 50.0 * np.eye(D + F)
    M[D:, D:] = np.diag(np.diag(M[D:, D:]))  # landmarks couple only via W
    keep = np.zeros(D, bool)
    keep[red] = True
    M[D:, :D][:, ~keep] = 0.0
    M[:D, D:][~keep, :] = 0.0
    H, h = M[:D, :D], np.diag(M[D:, D:]).copy()
    W = M[D:, :D][:, red]
    b, b_l = rng.normal(size=D), rng.normal(size=F)
    lam = 1e-3

    dx, dl = lm_linear_step(*map(jnp.asarray, (H, b, h, W, b_l, lam)), dims)

    Md = M.copy()
    Md[np.arange(D), np.arange(D)] += lam * np.clip(np.diag(H), 1e-8, None)
    Md[np.arange(D, D + F), np.arange(D, D + F)] *= 1.0 + lam
    sol = np.linalg.solve(Md, np.r_[b, b_l])
    np.testing.assert_allclose(np.asarray(dx), sol[:D], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(dl), sol[D:], rtol=1e-8, atol=1e-10)
    assert W.shape == (F, Dr)


def test_solve_window_dots_run_at_pinned_precision():
    """Every dot of the lowered float32 solve carries HIGHEST precision (no
    TF32), and the pin is the package default, not a per-call option."""
    from isvins_tpu.solver import reference as ref

    dims = WindowDims(B=6, Vo=3, F=32, N=64)
    args = ref.product_problem(dims)
    dots = [ln for ln in solve_window.lower(*args, dims, iters=2).as_text().splitlines()
            if "dot_general" in ln]
    assert dots and all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)
    with jax.default_matmul_precision("default"):
        dots = [ln for ln in solve_window.lower(*args, dims, iters=2).as_text().splitlines()
                if "dot_general" in ln]
    assert not any("HIGHEST" in ln for ln in dots)
