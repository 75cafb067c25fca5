"""Adversarial realism: photometric + dynamic nuisances —
motion blur, auto-exposure flicker, sensor-noise bursts, moving occluders —
that real EuRoC MH/V imagery has and the clean renderer lacked. The tracker's
flow-back gate + epipolar RANSAC (feature_tracker_simple.cpp:86-180
semantics) and the estimator's outlier culling must hold up: tracking keeps a
working feature set and the end-to-end trajectory stays bounded."""

import numpy as np
import jax.numpy as jnp
import pytest

import isvins_tpu  # noqa: F401
from isvins_tpu.config import (CameraConfig, NoiseConfig, PoseGraphConfig,
                               TrackerConfig, WindowConfig, euroc_config)
from isvins_tpu.frontend import FeatureTracker
from isvins_tpu.geom import mat_to_quat
from isvins_tpu.solver import WindowDims
from isvins_tpu.system import System
from isvins_tpu.utils.evaluation import ate_rmse
from isvins_tpu.utils.synthetic import RoomRenderer, make_world

R_BC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
NUISANCE = dict(motion_blur=0.012, exposure_flicker=0.15, noise_burst=6.0,
                n_occluders=3)


def _cam(W=320, H=240, f=200.0):
    return CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                        k1=0.0, k2=0.0, p1=0.0, p2=0.0)


def test_tracker_survives_nuisances():
    """Under blur + flicker + bursts + occluders the tracker must keep a
    working track set: enough aged (track_cnt >= 3) survivors for the
    estimator, with the RANSAC not collapsing the set."""
    cam = _cam()
    cfg_t = TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4,
                          lk_win=21, equalize=True, border=4)
    world = make_world(n_frames=14, frame_hz=10.0, imu_hz=200.0,
                       n_landmarks=10, seed=3)
    qic = np.asarray(mat_to_quat(jnp.asarray(np.array(R_BC))))
    renderer = RoomRenderer(world, cam, np.zeros(3), qic, **NUISANCE)
    tracker = FeatureTracker(cam, cfg_t)
    out = None
    for k in range(14):
        img, _, _ = renderer.render(k)
        out = tracker.read_image(img, world.frame_times[k])
    aged = int((out["track_cnt"] >= 3).sum())
    assert aged >= 25, f"only {aged} aged tracks survived the nuisances"
    # the exposure/noise effects must actually be active in the imagery
    img_a, _, _ = renderer.render(5)
    img_b, _, _ = renderer.render(6)
    assert not np.allclose(img_a.mean(), img_b.mean(), atol=0.2), \
        "exposure flicker had no effect"


@pytest.mark.slow
def test_system_nuisance_trajectory_bounded():
    """Full pipeline from nuisance pixels: the estimator must initialize and
    the ATE must stay within ~2x of the clean-sequence bound (0.15 m in
    test_system_pixels_to_trajectory) — the RANSAC + reprojection culling
    absorb the occluder tracks and photometric disturbances."""
    cam = _cam()
    cfg = euroc_config().replace(
        camera=cam,
        tracker=TrackerConfig(max_cnt=70, min_dist=16, freq=100, lk_levels=4,
                              lk_win=21, equalize=True, border=4),
        window=WindowConfig(vo_size=4, all_size=10, max_features=256,
                            max_imu_per_frame=64),
        noise=NoiseConfig(acc_n=0.05, gyr_n=0.005, acc_w=1e-4, gyr_w=1e-5,
                          pixel_sqrt_info=200.0),
        solver=euroc_config().solver.__class__(excitation_threshold=0.08),
        posegraph=PoseGraphConfig(enabled=False),
        tic=(0.0, 0.0, 0.0), ric=R_BC,
    )
    dims = WindowDims(B=10, Vo=4, F=256, N=2048)
    world = make_world(n_frames=40, frame_hz=10.0, imu_hz=200.0,
                       n_landmarks=10, seed=1)
    qic = np.asarray(mat_to_quat(jnp.asarray(np.array(R_BC))))
    renderer = RoomRenderer(world, cam, np.zeros(3), qic, **NUISANCE)

    sys_ = System(cfg, dims, enable_loop=False)
    for k in range(40):
        if k > 0:
            n = int(np.sum(world.imu_dts[k - 1] > 0))
            acc_t = world.frame_times[k - 1]
            for s in range(n):
                acc_t += world.imu_dts[k - 1][s]
                sys_.pub_imu(acc_t, world.imu_accs[k - 1][s],
                             world.imu_gyrs[k - 1][s])
        img, _, _ = renderer.render(k)
        sys_.pub_image(world.frame_times[k], img)
    sys_.flush()

    traj = sys_.vio_trajectory
    assert len(traj) >= 15, f"only {len(traj)} poses under nuisances"
    t_est = np.array([t for (t, P, Q) in traj])
    p_est = np.array([P for (t, P, Q) in traj])
    rmse = ate_rmse(t_est, p_est, world.frame_times, world.P, align="sim3")
    assert rmse < 0.30, f"nuisance ATE {rmse:.3f} m"
