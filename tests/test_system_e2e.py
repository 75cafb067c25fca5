"""Full pipeline from pixels: rendered synthetic sequence (images + IMU)
through System (tracker -> estimator -> pose graph) and ATE check — the
image-level analogue of the reference's run_euroc smoke test, with actual
accuracy assertions."""

import numpy as np
import jax.numpy as jnp
import pytest

import isvins_tpu  # noqa: F401
from isvins_tpu.config import (
    CameraConfig,
    NoiseConfig,
    PoseGraphConfig,
    TrackerConfig,
    WindowConfig,
    euroc_config,
)
from isvins_tpu.geom import mat_to_quat
from isvins_tpu.solver import WindowDims
from isvins_tpu.system import System
from isvins_tpu.utils.evaluation import ate_rmse
from isvins_tpu.utils.synthetic import RoomRenderer, make_world


@pytest.mark.slow
def test_system_pixels_to_trajectory():
    H, W = 240, 320
    f = 200.0
    cam = CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4,
                              lk_win=21, equalize=False, border=4),
        window=WindowConfig(vo_size=4, all_size=10, max_features=256,
                            max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5,
                          pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=False),
        tic=(0.0, 0.0, 0.0),
        ric=R_bc,
    )
    dims = WindowDims(B=10, Vo=4, F=256, N=2048)

    world = make_world(n_frames=40, frame_hz=10.0, imu_hz=200.0,
                       n_landmarks=900, seed=1)
    qic = np.asarray(mat_to_quat(jnp.asarray(np.array(R_bc))))
    renderer = RoomRenderer(world, cam, np.zeros(3), qic)

    sys_ = System(cfg, dims, enable_loop=False)
    for k in range(40):
        if k > 0:
            n = int(np.sum(world.imu_dts[k - 1] > 0))
            base_t = world.frame_times[k - 1]
            acc_t = base_t
            for s in range(n):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
        img, _, _ = renderer.render(k)
        sys_.pub_image(world.frame_times[k], img)

    traj = sys_.vio_trajectory
    assert len(traj) >= 15, f"only {len(traj)} poses estimated"
    t_est = np.array([t for (t, P, Q) in traj])
    p_est = np.array([P for (t, P, Q) in traj])
    # GT association by frame time
    rmse = ate_rmse(t_est, p_est, world.frame_times, world.P, align="sim3")
    assert rmse < 0.15, rmse  # perspective-correct renderer: tight bound


@pytest.mark.slow
def test_system_loop_closure_reduces_drift():
    """The full integrated loop: pixels -> tracker -> estimator ->
    marginalization packets -> keyframe DB -> BRIEF retrieval -> PnP loop
    verification -> pose-graph optimization -> drift correction. A noisy-IMU
    run around 1.3 laps of a room must fire at least one loop closure on the
    revisit and the optimized keyframe trajectory must beat raw VIO.
    (Image-level analogue of the reference's full pipeline,
    System.cpp + pose_graph_builder.cpp + pose_graph.cpp.)"""
    H, W = 240, 320
    f = 200.0
    cam = CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    R_bc = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4,
                              lk_win=21, equalize=False, border=4),
        window=WindowConfig(vo_size=4, all_size=10, max_features=256,
                            max_imu_per_frame=64),
        # injected IMU noise below is DISCRETE per-sample sigma; the solver's
        # acc_n/gyr_n are continuous densities (sigma_d * sqrt(dt)), so 0.05
        # at 200 Hz -> ~0.0035; 0.01 keeps a conservative 3x margin
        noise=NoiseConfig(acc_n=0.01, gyr_n=0.001, acc_w=1e-4, gyr_w=1e-5,
                          pixel_sqrt_info=f),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(skip_recent=25, min_loop_matches=15,
                                  keyframe_min_dist=0.3,
                                  max_keyframes=256, max_kp_per_kf=256),
        tic=(0.0, 0.0, 0.0),
        ric=R_bc,
    )
    dims = WindowDims(B=10, Vo=4, F=256, N=2048)

    n_frames = 130  # 1.24 laps at w=0.6, 10 Hz
    world = make_world(n_frames=n_frames, frame_hz=10.0, imu_hz=200.0,
                       n_landmarks=300, seed=4, traj_r=3.0, traj_w=0.6,
                       noise_acc=0.05, noise_gyr=0.005,
                       ba=(0.02, -0.015, 0.01), bg=(0.002, -0.003, 0.004))
    qic = np.asarray(mat_to_quat(jnp.asarray(np.array(R_bc))))
    renderer = RoomRenderer(world, cam, np.zeros(3), qic, seed=5)

    # production threading config: tracker dispatch pipelining + the
    # pose-graph worker thread (the latency bound below is only meaningful
    # with keyframe work off the frame path, as the reference runs it)
    sys_ = System(cfg, dims, enable_loop=True, pipeline=True, pg_thread=True)
    import time as _time

    frame_dts = []
    for k in range(n_frames):
        t0 = _time.perf_counter()
        if k > 0:
            n = int(np.sum(world.imu_dts[k - 1] > 0))
            acc_t = world.frame_times[k - 1]
            for s in range(n):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s], world.imu_gyrs[k - 1][s])
        img, _, _ = renderer.render(k)
        sys_.pub_image(world.frame_times[k], img)
        if sys_.estimator.solver_flag == 2:
            frame_dts.append(_time.perf_counter() - t0)

    assert len(sys_.vio_trajectory) >= 50
    db = sys_.pgbuilder.db
    assert db.n >= 20, f"only {db.n} keyframes"
    sys_.flush()
    assert sys_.pgbuilder.n_loops >= 1, "no loop closure fired on revisit"
    # the default config runs the loop optimization asynchronously (the
    # reference's decoupled optimizeCS thread): at least one solve must have
    # been dispatched and collected off the streaming path
    assert sys_.pgbuilder.n_async_collects >= 1
    assert sys_.pgbuilder._pending_opt is None

    # per-frame latency bound with loops enabled: in
    # steady state, after the one-off compile variants of the first steady
    # frames, no frame may stall on keyframe/retrieval/optimize work — the
    # worker threads own it. Relative bounds so the assertion holds on any
    # host; the absolute regression this guards against is the multi-second
    # synchronous optimize/compile stall of the pre-thread design.
    tail = np.array(frame_dts[len(frame_dts) // 2:])
    assert len(tail) >= 20
    med = float(np.median(tail))
    p90 = float(np.percentile(tail, 90))
    assert p90 <= 3.0 * med, (med, p90)
    assert float(tail.max()) <= 8.0 * med, (med, float(tail.max()))

    # optimized keyframe trajectory must beat raw VIO keyframe trajectory
    # QUANTITATIVELY: at least halve the keyframe ATE on
    # the revisit world and land under an absolute ceiling
    ts, t_opt, q_opt = sys_.pgbuilder.trajectory()
    t_vio = db.vio_t[: db.n]
    rmse_vio = ate_rmse(ts, t_vio, world.frame_times, world.P, align="se3")
    rmse_opt = ate_rmse(ts, t_opt, world.frame_times, world.P, align="se3")
    assert rmse_opt <= 0.5 * rmse_vio, (rmse_vio, rmse_opt)
    assert rmse_opt < 2.0, rmse_opt
