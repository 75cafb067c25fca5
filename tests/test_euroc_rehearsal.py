"""EuRoC driver rehearsal: no real dataset can be mounted
in this environment, so a byte-format-identical `mav0/` tree (nanosecond
CSVs with real headers, PNG frames named by stamp, 17-column ground truth)
is generated from the synthetic world and `run_euroc.main` replays it
through the REAL path — EurocDataset + the native C csv parser + PNG decode
+ time-ordered streaming + System + TUM writers + ATE alignment — exactly
as a real sequence would run (/root/reference/test/run_euroc.cpp:26–88)."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import isvins_tpu  # noqa: F401
from isvins_tpu.config import (CameraConfig, NoiseConfig, PoseGraphConfig,
                               TrackerConfig, WindowConfig, euroc_config)
from isvins_tpu.geom import hostmath as hm
from isvins_tpu.solver import WindowDims
from isvins_tpu.utils.euroc_fixture import write_euroc_fixture
from isvins_tpu.utils.synthetic import RoomRenderer, make_world

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    H, W, f = 240, 320, 200.0
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
        posegraph=PoseGraphConfig(enabled=True, keyframe_min_dist=0.3,
                                  skip_recent=25, min_loop_matches=15,
                                  max_keyframes=64, max_kp_per_kf=128),
        tic=(0.0, 0.0, 0.0), ric=R_bc,
    )
    world = make_world(n_frames=36, frame_hz=10.0, imu_hz=200.0,
                       n_landmarks=400, seed=6)
    qic = hm.mat_to_quat_np(np.array(R_bc))
    renderer = RoomRenderer(world, cam, np.zeros(3), qic)
    frames = [renderer.render(k)[0] for k in range(36)]
    root = tmp_path_factory.mktemp("euroc_fix")
    mav0 = write_euroc_fixture(str(root), world, frames)
    return mav0, cfg, str(root)


def test_fixture_tree_is_euroc_format(fixture_tree):
    mav0, _, _ = fixture_tree
    imu_csv = os.path.join(mav0, "imu0", "data.csv")
    cam_csv = os.path.join(mav0, "cam0", "data.csv")
    with open(imu_csv) as f:
        head = f.readline()
        row = f.readline().split(",")
    assert head.startswith("#timestamp [ns],w_RS_S_x")
    assert len(row) == 7 and int(row[0]) > 10 ** 18  # epoch-scale ns stamps
    with open(cam_csv) as f:
        f.readline()
        ts, name = f.readline().strip().split(",")
    assert name == f"{ts}.png"
    assert os.path.exists(os.path.join(mav0, "cam0", "data", name))
    gt = os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")
    with open(gt) as f:
        f.readline()
        assert len(f.readline().split(",")) == 17


def test_loader_roundtrips_through_native_parser(fixture_tree):
    """The EurocDataset must reproduce the world's IMU stream exactly
    (ns -> s precision through the native strtod parser) and decode the
    PNGs to the rendered pixels."""
    from isvins_tpu.data import EurocDataset

    mav0, _, _ = fixture_tree
    ds = EurocDataset(mav0)
    assert len(ds.images) == 36
    assert len(ds.imu) > 600  # 3.5 s at 200 Hz
    # stream order: strictly nondecreasing time, images interleaved
    last = -np.inf
    kinds = set()
    for kind, m in ds.stream():
        assert m.t >= last - 1e-9
        last = m.t
        kinds.add(kind)
    assert kinds == {"imu", "image"}
    img = ds.images[0].load()
    assert img.shape == (240, 320) and img.dtype == np.float32
    assert ds.ground_truth is not None and len(ds.ground_truth["t"]) == 36


def test_run_euroc_end_to_end(fixture_tree, tmp_path):
    """Full driver replay through run_euroc.main: TUM outputs written, ATE
    computed against the fixture's ground truth and sane."""
    import run_euroc

    mav0, cfg, _ = fixture_tree
    out = str(tmp_path / "out")
    res = run_euroc.main([mav0, "--out-dir", out], cfg=cfg,
                         dims=WindowDims(B=10, Vo=4, F=256, N=2048))
    assert res["n_frames"] == 36
    assert res["n_vio_poses"] >= 15, res
    assert os.path.exists(res["pose_output"])
    assert os.path.exists(res["loop_pose_output"])
    # TUM format: "t x y z qx qy qz qw"
    with open(res["pose_output"]) as f:
        first = f.readline().split()
    assert len(first) == 8
    assert float(first[0]) > 10 ** 9  # epoch-scale seconds preserved
    assert res["ate_rmse"] is not None and res["ate_rmse"] < 0.5, res
