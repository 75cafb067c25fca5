"""Typed engine configuration.

One dataclass consumed by both the host pipeline and kernel shape selection
(static shapes matter for jit). Replaces the reference's OpenCV-YAML globals
(src/parameters.cpp:61–232) and compile-time constants
(include/parameters.h:13,35–40,82–87). Defaults mirror
config/euroc_config.yaml.

NB the reference's yaml keys `vo_size`/`vio_size` are parsed but never used —
the compile-time constants Vo_SIZE=8 / ALL_BUF_SIZE=18 win (SURVEY.md §2 row 3);
we default to the constants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics for the camodocal model family
    (thirdparty/camera_models: PinholeCamera, CataCamera/Mei,
    EquidistantCamera/Kannala-Brandt, ScaramuzzaCamera/OCAM), selected by
    `model`. Field reuse across models mirrors camodocal's parameter names:
    pinhole (fx,fy,cx,cy,k1,k2,p1,p2); mei adds xi and reads
    (gamma1,gamma2,u0,v0) from (fx,fy,cx,cy); equidistant reads (mu,mv,u0,v0)
    from (fx,fy,cx,cy) and its k2..k5 from `kb`; scaramuzza reads the image
    center from (cx,cy), the affine (C,D,E) from `ocam_cde`, and the forward/
    inverse polynomials from `ocam_poly`/`ocam_inv_poly` (fx then only feeds
    the tracker's normalized RANSAC threshold)."""

    width: int = 752
    height: int = 480
    fx: float = 461.6
    fy: float = 460.3
    cx: float = 363.0
    cy: float = 248.1
    k1: float = -2.917e-01
    k2: float = 8.228e-02
    p1: float = 5.333e-05
    p2: float = -1.578e-04
    model: str = "pinhole"  # pinhole | mei | equidistant | scaramuzza
    xi: float = 0.0  # Mei unified-model mirror parameter
    kb: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)  # KB k2..k5
    ocam_poly: Tuple[float, ...] = ()  # OCAM cam2world polynomial (a0..aN)
    ocam_inv_poly: Tuple[float, ...] = ()  # OCAM world2cam polynomial
    ocam_cde: Tuple[float, float, float] = (1.0, 0.0, 0.0)  # OCAM affine C,D,E

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )


@dataclass(frozen=True)
class TrackerConfig:
    """Frontend knobs (feature_tracker_simple.cpp)."""

    max_cnt: int = 150  # max features tracked per frame
    min_dist: int = 30  # min pixel distance between features (setMask)
    freq: int = 20  # publish frequency (Hz)
    f_threshold: float = 1.0  # RANSAC reprojection threshold (px)
    equalize: bool = True  # CLAHE on input
    lk_win: int = 21  # LK window size
    lk_levels: int = 3  # pyramid levels
    border: int = 1  # inBorder margin (border size BORDER_SIZE=1)
    flow_back: bool = True  # forward-backward LK consistency gate (VINS-Fusion FLOW_BACK)
    flow_back_thresh: float = 0.5  # round-trip pixel tolerance
    # epipolar RANSAC placement: None = fused into the device step on
    # accelerator backends (SVD-free eigh 8-point; zero host cost, rides the
    # existing dispatch), host CPU path otherwise. True/False forces.
    fused_ransac: bool | None = None


@dataclass(frozen=True)
class WindowConfig:
    """Static sliding-window shapes (parameters.h:35–40). These set jit shapes."""

    vo_size: int = 8  # Vo_SIZE: visual-only segment with relpose priors
    all_size: int = 18  # ALL_BUF_SIZE: total window frames
    max_features: int = 1000  # NUM_OF_F landmark capacity
    max_obs_per_frame: int = 160  # per-frame feature packet capacity (~MAX_CNT)
    max_imu_per_frame: int = 64  # IMU samples per frame segment capacity


@dataclass(frozen=True)
class NoiseConfig:
    """IMU noise densities + pixel info (euroc_config.yaml)."""

    acc_n: float = 0.22627
    gyr_n: float = 0.003988
    acc_w: float = 0.001
    gyr_w: float = 0.0001
    g_norm: float = 9.81007
    pixel_sqrt_info: float = 460.0  # ProjectionFactor::sqrt_info = this * I2 (estimator.cpp:35)


@dataclass(frozen=True)
class SolverConfig:
    """Window solver knobs (euroc_config.yaml:49–50, estimator.cpp:1119–1128)."""

    max_iterations: int = 10
    init_max_iterations: int = 30
    cauchy_loss: float = 1.0  # Cauchy robust-loss scale on projection factors
    lm_init_lambda: float = 1e-4
    min_parallax_px: float = 10.0  # keyframe_parallax (pixels); /focal for normalized
    init_depth: float = 5.0  # INIT_DEPTH fallback
    max_depth: float = 200.0  # far-point cap (ref resets >8 m to 5 m; see feature_manager.triangulate)
    alpha: float = 0.1  # eigenvalue cutoff for sparsified-factor recovery (ALPHA)
    bias_acc_threshold: float = 2.5  # failureDetection (estimator.cpp:604)
    bias_gyr_threshold: float = 1.0
    estimate_td: bool = False
    td: float = 0.0
    excitation_threshold: float = 0.25  # checkIMUExcitation (estimator.cpp:232)
    outlier_reproj_px: float = 3.0  # post-solve mean-reprojection culling gate
    # steady-state window-solve precision: float32 on the accelerator;
    # marginalization eigendecompositions and the init BA always stay
    # float64 regardless (mixed-precision split)
    solve_dtype: str = "float32"


@dataclass(frozen=True)
class PoseGraphConfig:
    """Loop closure / pose graph (pose_graph.cpp, keyframe.cpp)."""

    enabled: bool = True
    keyframe_min_dist: float = 0.1  # accumulate edges until this length (pose_graph_builder.cpp:158)
    skip_recent: int = 50  # don't match against the last N keyframes (pose_graph.cpp:153)
    top_k: int = 4  # query candidates
    retrieval_match_thresh: int = 40  # Hamming bits for retrieval match counting
    retrieval_abs_frac: float = 0.2  # min fraction of matched query descriptors
    bow_abs_score: float = 0.05  # min tf-idf L1 similarity (DBoW2 0.05 gate)
    hamming_thresh: int = 80  # descriptor match threshold (keyframe.cpp:92)
    min_loop_matches: int = 25  # MIN_LOOP_NUM
    pnp_inlier_thresh: float = 10.0 / 460.0  # normalized-plane RANSAC threshold
    max_yaw_deg: float = 30.0  # loop gate (keyframe.cpp:282)
    max_dist: float = 20.0
    optimize_poll_s: float = 2.0
    max_keyframes: int = 4096  # initial keyframe-db capacity (grows 2x on demand)
    brief_bits: int = 256
    max_kp_per_kf: int = 512  # window pts + detected pts capacity
    dist_min_poses: int = 512  # active segments >= this use the edge-sharded multi-device solve
    max_active_poses: int = 4096  # clamp of the optimized segment (logged, oldest poses frozen)
    # dispatch the loop optimization asynchronously and collect it at the
    # next keyframe (the reference's optimizeCS poll-thread semantics,
    # pose_graph.cpp:425): the VIO stream never blocks on the dense solve
    async_optimize: bool = True


@dataclass(frozen=True)
class EngineConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    posegraph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    # imu->camera extrinsics: R_ic (body<-cam), t_ic; euroc defaults
    ric: Tuple[Tuple[float, ...], ...] = (
        (0.0148655429818, -0.999880929698, 0.00414029679422),
        (0.999557249008, 0.0149672133247, 0.025715529948),
        (-0.0257744366974, 0.00375618835797, 0.999660727178),
    )
    tic: Tuple[float, ...] = (-0.0216401454975, -0.064676986768, 0.00981073058949)
    estimate_extrinsic: int = 0

    @property
    def gravity(self) -> np.ndarray:
        return np.array([0.0, 0.0, self.noise.g_norm])

    @property
    def ric_np(self) -> np.ndarray:
        return np.array(self.ric)

    @property
    def tic_np(self) -> np.ndarray:
        return np.array(self.tic)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def euroc_config() -> EngineConfig:
    return EngineConfig()
