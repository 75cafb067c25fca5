#!/usr/bin/env python
"""Bring-up check of the VIO main path on NVIDIA GPUs.

    python chip_smoke.py              # phases 0-4 on one GPU
    python chip_smoke.py --multichip  # the multi-device phases only, 4 GPUs

Phases, one line each with its seconds and its comparison:

  device        require JAX's GPU backend; print the card and power limit
  window_solve  product-width LM window solve, float32 on the GPU against
                float64 on the CPU backend (solver/reference.py)
  pose_graph    dense pose-graph Gauss-Newton with per-pose covariance at
                K=256, float32 on the GPU against float64 on the CPU
  system        System at EuRoC's own camera (752x480 radtan, CLAHE, 20 Hz
                camera, 200 Hz IMU), product window, loops on, fed a
                200-frame 1.4-lap rendered world

With --multichip: sequence-parallel window solves, the domain-decomposition
pose graph and MultiSequenceSolver, each on 4 GPUs against one GPU.

Any failure raises and exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}. JAX_PLATFORMS is left alone: the CPU
backend hosts the float64 references and the float64 support math.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FRAME_CACHE = os.path.join(REPO, ".frame_cache")


def _report(name, seconds, **fields):
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {seconds:.1f}s {kv}", flush=True)


def _fmt(d):
    return "{" + ", ".join(f"{k}: {v:.3e}" for k, v in d.items()) + "}"


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ------------------------------------------------------------- window solve
def phase_window_solve(cpu):
    from isvins_tpu.solver import reference as ref

    args = ref.product_problem()
    with jax.default_device(cpu):
        want = ref.solve(ref.as_float64(args, cpu))
    pinned = ref.deviation(ref.solve(args), want)
    # the package pins HIGHEST globally; "default" lets the card use TF32
    with jax.default_matmul_precision("default"):
        unpinned = ref.deviation(ref.solve(args), want)
    _check(ref.within(pinned), f"pinned float32 solve off float64: "
                               f"{pinned} > {ref.F32_TOL}")
    return {"pinned": _fmt(pinned), "tol": _fmt(ref.F32_TOL),
            "unpinned_tf32_finding": _fmt(unpinned)}


# --------------------------------------------------------------- pose graph
def pose_graph_problem(K=256, L=32, seed=3):
    """A K-pose graph in `_optimize_core`'s argument order (float64 numpy):
    a drifting dead-reckoned initial trajectory around a 3 m circle,
    sequential edges and roll-pitch edges from noisy ground truth, and L
    loop edges between the first and the last lap."""
    from isvins_tpu.geom.hostmath import quat_mul_np, quat_normalize_np, quat_to_mat_np
    from isvins_tpu.utils.synthetic import _q_conj

    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2.6 * np.pi, K)
    t_gt = np.stack([3 * np.cos(ang), 3 * np.sin(ang), 0.3 * np.sin(3 * ang)], 1)
    yaw = ang + np.pi / 2
    q_gt = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)

    def rel(i, j, sig_t, sig_r):
        dt = quat_to_mat_np(q_gt[i]).T @ (t_gt[j] - t_gt[i]) + rng.normal(0, sig_t, 3)
        dq = quat_mul_np(_q_conj(q_gt[i]), q_gt[j])
        dq = quat_normalize_np(quat_mul_np(dq, np.r_[1.0, rng.normal(0, sig_r / 2, 3)]))
        return dt, dq

    e_dt = np.zeros((K, 3))
    e_dq = np.tile([1.0, 0, 0, 0], (K, 1))
    for k in range(K - 1):
        e_dt[k], e_dq[k] = rel(k, k + 1, 0.01, 0.002)
    e_sqrt = np.tile(np.diag([100.0] * 3 + [500.0] * 3)[None], (K, 1, 1))
    e_valid = np.arange(K) < K - 1
    # dead reckoning through the noisy edges: the drift the loops remove
    t0, q0 = np.zeros((K, 3)), np.zeros((K, 4))
    t0[0], q0[0] = t_gt[0], q_gt[0]
    for k in range(K - 1):
        t0[k + 1] = t0[k] + quat_to_mat_np(q0[k]) @ e_dt[k]
        q0[k + 1] = quat_normalize_np(quat_mul_np(q0[k], e_dq[k]))
    rp_q = q_gt.copy()
    rp_sqrt = np.tile(np.eye(2)[None] * 100.0, (K, 1, 1))
    rp_valid = np.ones(K, bool)
    lap = int(K / 1.3)
    loop_j = np.sort(rng.choice(np.arange(lap, K), L, replace=False)).astype(np.int32)
    loop_i = (loop_j - lap).astype(np.int32)
    loop_dt, loop_dq = np.zeros((L, 3)), np.zeros((L, 4))
    for n in range(L):
        loop_dt[n], loop_dq[n] = rel(loop_i[n], loop_j[n], 0.02, 0.004)
    loop_w = np.full(L, 1e4)
    active = np.ones(K, bool)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (t0, q0, active, e_dt, e_dq, e_sqrt, e_valid, rp_q, rp_sqrt,
            rp_valid, loop_i, loop_j, loop_dt, loop_dq, loop_w,
            np.ones(L, bool), fixed)


def _as(args, dtype, device=None):
    """`args` with float64 leaves cast to dtype, on `device` (default
    device, uncommitted, when None)."""
    return tuple(jax.device_put(a.astype(dtype) if a.dtype == np.float64 else a,
                                device) for a in args)


def pose_graph_solve(args, iters=10):
    """(t, q, cov, cost) of the dense core as host float64 numpy."""
    from isvins_tpu.posegraph.optimize import _optimize_core

    K, L = args[0].shape[0], args[10].shape[0]
    out = _optimize_core(*args, K=K, L=L, iters=iters)
    return tuple(np.asarray(o, np.float64) for o in out)


def pose_graph_deviation(out, ref):
    (t, q, cov, cost), (t_r, q_r, cov_r, cost_r) = out, ref
    scale = np.max(np.abs(cov_r))
    return {"t": float(np.max(np.abs(t - t_r))),
            "q": float(np.max(np.abs(q - q_r))),
            "cov_rel": float(np.max(np.abs(cov - cov_r)) / scale),
            "cost_rel": float(abs(cost - cost_r) / abs(cost_r))}


# Bounds on |float32 GPU - float64 CPU| for pose_graph_problem(K=256),
# 10 iterations: ten times the CPU backend's own float32 deviation on that
# problem (measured: t 1.53e-6 m, q 2.60e-7, covariance 1.16e-6 of its
# largest entry, cost 1.57e-7 relative). Ten, not two as for the window
# solve: this problem is well conditioned, so its float32 error is rounding
# alone, and the GPU's blocked Cholesky and tree reductions round in another
# order whose error grows with the reduction length. The bounds are still
# 1.5e-5 m on a graph whose loops move poses by 0.29 m.
POSE_GRAPH_TOL = {"t": 1.5e-5, "q": 2.6e-6, "cov_rel": 1.2e-5, "cost_rel": 1.6e-6}


def phase_pose_graph(cpu):
    prob = pose_graph_problem()
    with jax.default_device(cpu):
        want = pose_graph_solve(_as(prob, np.float64, cpu))
    dev = pose_graph_deviation(pose_graph_solve(_as(prob, np.float32)), want)
    _check(all(dev[k] <= POSE_GRAPH_TOL[k] for k in dev),
           f"float32 pose graph off float64: {dev} > {POSE_GRAPH_TOL}")
    return {"dev": _fmt(dev), "tol": _fmt(POSE_GRAPH_TOL)}


# ------------------------------------------------------------------ system
N_FRAMES = 200

# Trajectory-error bounds of the `system` phase: twice the SE3-aligned ATE
# of one CPU-backend run of the same world and configuration (VIO 1.381 m
# over 181 poses, loop-optimized keyframes 0.275 m over 66; 17 loops).
ATE_VIO_MAX_M = 2.76
ATE_LOOP_MAX_M = 0.55


def euroc_system_config():
    """EuRoC MH camera and IMU (config/euroc_config.yaml): 752x480 radtan
    intrinsics, CLAHE on, 150 tracked features, the product window."""
    from isvins_tpu.config import (CameraConfig, NoiseConfig, PoseGraphConfig,
                                   TrackerConfig, WindowConfig, euroc_config)
    from isvins_tpu.solver import WindowDims

    base = euroc_config()
    cfg = base.replace(
        camera=CameraConfig(),
        tracker=TrackerConfig(max_cnt=150, min_dist=25, freq=100, lk_levels=4,
                              lk_win=21, equalize=True, border=4),
        window=WindowConfig(vo_size=8, all_size=18, max_features=1000,
                            max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.02, gyr_n=0.002, acc_w=1e-4, gyr_w=1e-5,
                          pixel_sqrt_info=460.0),
        solver=base.solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3,
                                  skip_recent=25, min_loop_matches=15,
                                  max_keyframes=512, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0),
        ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    )
    return cfg, WindowDims(B=18, Vo=8, F=1000, N=3072)


def euroc_world(cfg, n_frames=N_FRAMES):
    """1.4 laps of a textured room at w=0.9 rad/s: the revisit closes loops.
    Returns (world, frames uint8 (n, 480, 752)). Rendering is host numpy
    (about 0.8 s a frame on one core), so frames are rendered on a thread
    pool and kept in .frame_cache/ between runs."""
    from concurrent.futures import ThreadPoolExecutor

    from isvins_tpu.frontend import make_camera
    from isvins_tpu.geom.hostmath import mat_to_quat_np
    from isvins_tpu.utils.synthetic import RoomRenderer, make_world

    cam = cfg.camera
    world = make_world(n_frames=n_frames, frame_hz=20.0, imu_hz=200.0,
                       n_landmarks=10, seed=7, traj_r=3.0, traj_w=0.9,
                       noise_acc=0.02, noise_gyr=0.002,
                       ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))
    path = os.path.join(FRAME_CACHE, f"frames_{n_frames}x{cam.width}x{cam.height}"
                                     f"_seed7_w0.9_tex512.npz")
    if os.path.exists(path):
        return world, np.load(path)["frames"]
    renderer = RoomRenderer(world, cam, np.zeros(3),
                            mat_to_quat_np(np.array(cfg.ric)), seed=11,
                            camera_model=make_camera(cam), tex_res=512)
    render = lambda k: np.clip(np.rint(renderer.render(k)[0]), 0, 255).astype(np.uint8)
    first = render(0)  # fills the renderer's ray cache before the pool starts
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
        frames = np.stack([first] + list(pool.map(render, range(1, n_frames))))
    os.makedirs(FRAME_CACHE, exist_ok=True)
    np.savez_compressed(path, frames=frames)
    return world, frames


def run_system(n_frames=N_FRAMES):
    """Drive System the way run_euroc.py does and return what it produced."""
    from isvins_tpu.estimator.estimator import NON_LINEAR
    from isvins_tpu.system import System
    from isvins_tpu.utils.evaluation import ate_rmse

    cfg, dims = euroc_system_config()
    t0 = time.perf_counter()
    world, frames = euroc_world(cfg, n_frames)
    t_render = time.perf_counter() - t0
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True)
    sys_.wait_pg_ready()
    frame_s, steady = [], False
    for k in range(n_frames):
        ta = time.perf_counter()
        if k > 0:
            acc_t = world.frame_times[k - 1]
            for s in range(int(np.sum(world.imu_dts[k - 1] > 0))):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
        sys_.pub_image(world.frame_times[k], frames[k])
        if k == n_frames - 1:
            sys_.flush()
        if steady:
            frame_s.append(time.perf_counter() - ta)
        steady = steady or sys_.estimator.solver_flag == NON_LINEAR

    est, pg = sys_.estimator, sys_.pgbuilder
    traj = sys_.vio_trajectory
    t_vio = np.array([t for t, _, _ in traj])
    p_vio = np.array([P for _, P, _ in traj])
    q_vio = np.array([Q for _, _, Q in traj])
    ts_kf, t_opt, q_opt = pg.trajectory()
    _, _, cov = pg.covariances()
    return {
        "render_s": t_render,
        "non_linear": est.solver_flag == NON_LINEAR,
        "failures": est.failure_count,
        "loops": pg.n_loops,
        "optimizations": pg.n_async_collects,
        "keyframes": pg.db.n,
        "vio_poses": len(traj),
        "finite": bool(all(np.isfinite(a).all() for a in (p_vio, q_vio, t_opt, q_opt, cov))),
        "ate_vio": float(ate_rmse(t_vio, p_vio, world.frame_times, world.P, align="se3")),
        "ate_loop": float(ate_rmse(ts_kf, t_opt, world.frame_times, world.P, align="se3")),
        "frame_ms_median": float(np.median(frame_s) * 1e3),
        "frame_ms_p90": float(np.percentile(frame_s, 90) * 1e3),
        "steady_frames": len(frame_s),
    }


def phase_system(card):
    r = run_system()
    _check(r["non_linear"] and r["failures"] == 0,
           f"estimator did not reach NON_LINEAR cleanly: {r}")
    _check(r["loops"] >= 1 and r["optimizations"] >= 1,
           f"no loop closed or no pose-graph optimization collected: {r}")
    _check(r["finite"], f"non-finite outputs: {r}")
    _check(r["ate_vio"] <= ATE_VIO_MAX_M and r["ate_loop"] <= ATE_LOOP_MAX_M,
           f"ATE over bound ({ATE_VIO_MAX_M} / {ATE_LOOP_MAX_M} m): {r}")
    fps = 1e3 / r["frame_ms_median"]
    return {k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in r.items()} | {
        "frames_per_s": f"{fps:.2f}", "card": f"'{card}'"}


# --------------------------------------------------------------- multichip
# The mesh paths are checked for agreement with one card after 3 LM
# iterations: by 10 the random problem's float32 iterates walk apart along
# its weakly constrained direction (solver/reference.py), so two float32
# runs may differ by ~0.15 m in P however they are sharded. After 3, each
# float32 solve of make_batch_problem(4) is within (CPU backend, max over
# the four sequences) cost 1.62e-6 relative, P 7.14e-5 m, Q 1.16e-5,
# inverse depth 3.72e-4 of float64; two float32 runs may differ by twice
# that, and each is allowed twice its CPU deviation, as in the window solve.
SHARD_ITERS = 3
SHARD_TOL = {"cost_rel": 6.5e-6, "P": 2.9e-4, "Q": 4.7e-5, "dep": 1.5e-3}

# Batched vs solo estimators run the same float32 program on a well-
# conditioned window: rounding noise is ~1e-6–1e-5 m, while a batching
# fault (a row given to the wrong sequence) moves poses by centimetres.
MULTI_SEQ_TOL_M = 1e-4


def phase_sharded_solve(n):
    from isvins_tpu.parallel import make_batch_problem, make_mesh, sharded_batch_solve
    from isvins_tpu.solver import reference as ref

    prob = make_batch_problem(n, ref.PRODUCT_DIMS)
    outs = []
    for mesh in (make_mesh(n), make_mesh(1)):
        step, shard = sharded_batch_solve(mesh, ref.PRODUCT_DIMS, iters=SHARD_ITERS)
        st, cost = step(*shard(prob[:4]), *prob[4:])
        outs.append(jax.tree_util.tree_map(np.asarray, (st, cost)))
    worst = {k: 0.0 for k in ref.F32_TOL}
    for s in range(n):
        pick = lambda o: (jax.tree_util.tree_map(lambda a: a[s], o[0]), float(o[1][s]))
        dev = ref.deviation(pick(outs[0]), pick(outs[1]))
        worst = {k: max(worst[k], dev[k]) for k in worst}
    _check(ref.within(worst, SHARD_TOL), f"{n}-card batch off the one-card batch: {worst}")
    return {"iters": SHARD_ITERS, "worst_dev": _fmt(worst), "tol": _fmt(SHARD_TOL)}


def phase_dd_pose_graph(n):
    from isvins_tpu.parallel import make_mesh
    from isvins_tpu.parallel.dd_solver import dd_pose_graph_solve

    K = 1024
    prob = pose_graph_problem(K=K, L=64)
    args32 = _as(prob, np.float32)
    dense32 = pose_graph_solve(args32)
    dense64 = pose_graph_solve(_as(prob, np.float64))
    (t, q, active, e_dt, e_dq, e_sqrt, e_valid, rp_q, rp_sqrt, rp_valid,
     loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid, fixed) = args32
    # the product route's argument layout (posegraph/optimize.py)
    e_i = jnp.minimum(jnp.arange(K, dtype=jnp.int32), K - 2)
    dd = dd_pose_graph_solve(
        make_mesh(n, axis="edges"), t, q, active, fixed, e_i, e_i + 1,
        e_dt, e_dq, e_sqrt, e_valid, jnp.arange(K, dtype=jnp.int32), rp_q,
        rp_sqrt, rp_valid, loop_i, loop_j, loop_dt, loop_dq, loop_w,
        loop_valid, iters=10, with_cov=True)
    dd = tuple(np.asarray(o, np.float64) for o in dd)
    dev = pose_graph_deviation(dd, dense32)
    # the two float32 solves factor the same system in different orders:
    # each may sit up to twice float32's own loss (dense float32 vs dense
    # float64 on one card, measured here) from the float64 solution, so
    # they may differ from each other by up to four times it
    f32_loss = pose_graph_deviation(dense32, dense64)
    tol = {k: 4 * f32_loss[k] for k in f32_loss}
    _check(all(dev[k] <= tol[k] for k in dev),
           f"{n}-card domain decomposition off the dense solve: {dev} > {tol}")
    return {"dev": _fmt(dev), "tol": _fmt(tol)}


def _steady_estimator(cfg, dims, seed):
    """An Estimator placed directly in steady state on a synthetic world."""
    from isvins_tpu.estimator.estimator import Estimator, MARGIN_OLD, NON_LINEAR
    from isvins_tpu.geom.hostmath import mat_to_quat_np
    from isvins_tpu.solver import PriorState
    from isvins_tpu.utils.synthetic import make_world, project

    world = make_world(n_frames=dims.B, n_landmarks=400, seed=seed)
    est = Estimator(cfg, dims, solve_async=True)
    est.Ps[:], est.Qs[:], est.Vs[:] = world.P, world.Q, world.V
    est.Headers[:] = world.frame_times
    est.imu_dt[1:], est.imu_acc[1:], est.imu_gyr[1:] = (
        world.imu_dts, world.imu_accs, world.imu_gyrs)
    est.imu_acc0[1:], est.imu_gyr0[1:] = world.imu_acc0, world.imu_gyr0
    est.imu_cnt[1:] = (world.imu_dts > 0).sum(axis=1)
    qic = mat_to_quat_np(np.array(cfg.ric))
    for k in range(dims.B):
        pts, _, vis = project(world, k, np.zeros(3), qic)
        est.f_manager.add_features(k, np.where(vis)[0], pts[vis])
    est.frame_count = dims.B - 1
    est.solver_flag = NON_LINEAR
    est.marginalization_flag = MARGIN_OLD
    est.priors = PriorState.empty(dims.Vo)
    return est


def phase_multi_sequence(n):
    from isvins_tpu.parallel import MultiSequenceSolver, make_mesh

    cfg, dims = euroc_system_config()
    seeds = [200 + s for s in range(n)]
    solo = []
    for s in seeds:
        e = _steady_estimator(cfg, dims, s)
        e.dispatch_odometry()
        e.collect_solve()
        e.collect_marg()
        solo.append(e.Ps.copy())
    ests = [_steady_estimator(cfg, dims, s) for s in seeds]
    for e in ests:
        e._defer_dispatch = True
        e.dispatch_odometry()
    _check(MultiSequenceSolver(make_mesh(n)).step(ests) == n, "not all sequences batched")
    worst = 0.0
    for e, want in zip(ests, solo):
        e.collect_marg()
        _check(len(e.pose_graph_packets) == 1, "marginalization did not run")
        worst = max(worst, float(np.max(np.abs(e.Ps - want))))
    _check(worst <= MULTI_SEQ_TOL_M, f"batched Ps off solo by {worst} m")
    return {"worst_P_dev_m": f"{worst:.3e}", "tol_m": MULTI_SEQ_TOL_M}


# -------------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the multi-device phases, on 4 GPUs")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    import isvins_tpu

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, not a GPU",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    n = 4 if args.multichip else 1
    if len(devs) < n:
        print(f"chip_smoke: needs {n} GPUs, found {len(devs)}", file=sys.stderr)
        return 2
    cache = isvins_tpu.enable_compile_cache()
    cpu = jax.devices("cpu")[0]
    card = card_name_and_power()
    _report("device", time.perf_counter() - t0, kind=f"'{devs[0].device_kind}'",
            count=len(devs), nvidia_smi=f"'{card}'", compile_cache=cache)

    if args.multichip:
        phases = [("sharded_solve", lambda: phase_sharded_solve(n)),
                  ("dd_pose_graph", lambda: phase_dd_pose_graph(n)),
                  ("multi_sequence", lambda: phase_multi_sequence(n))]
    else:
        phases = [("window_solve", lambda: phase_window_solve(cpu)),
                  ("pose_graph", lambda: phase_pose_graph(cpu)),
                  ("system", lambda: phase_system(card))]
    for name, run in phases:
        t = time.perf_counter()
        fields = run()
        _report(name, time.perf_counter() - t, **fields)

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
