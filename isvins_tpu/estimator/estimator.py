"""Sliding-window VIO estimator: host state machine driving jitted device
super-steps (replaces the reference's Estimator, src/estimator.cpp).

Architecture vs reference (SURVEY.md §7): the data-dependent control flow
(INITIAL vs NON_LINEAR, MARGIN_OLD vs MARGIN_NEW, failure reset) lives on the
host; everything numeric — preintegration, the window LM solve, the two-stage
marginalization — is batched, statically-shaped device code.

Deliberate improvements over the reference, kept because they only tighten
consistency (documented per-site):
- preintegrations are re-integrated at the current bias estimate each solve
  (the functional design makes repropagation free; the reference keeps stale
  linearization points + first-order bias correction),
- pseudo-measurement drags are exact and applied AFTER the yaw/position
  re-anchoring, so priors are always consistent with the stored states (the
  reference updates against pre-anchor parameter values; see
  estimator.cpp:1132–1144 vs :518–594 ordering),
- the velocity rows of the VB prior are rotated by the re-anchoring rotation
  (the reference rotates the gyro-bias rows — VB.tail<3> at :549 — which is a
  slip; bias is body-frame).
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import EngineConfig
from ..factors import ImuNoise, integrate_segment
from ..factors.priors import (
    relpose_update,
    rollpitch_update,
    se3_prior_update,
)
from ..geom import (
    mat_to_quat,
    mat_to_ypr,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    ypr_to_mat,
)
from ..initial.ex_rotation import ExtrinsicRotationCalibrator
from ..solver import (
    ImuFactors,
    PriorState,
    ProjFactors,
    RollPitchFactors,
    WindowDims,
    WindowState,
    solve_window,
)
from .feature_manager import FeatureManager
from .marginalization import (
    PoseGraphPacket,
    init_sparsify,
    marg_backward,
    marg_forward,
)
from ..utils.packing import PackedFn
from ..utils import perf
from ..utils.devices import host_cpu

_log = logging.getLogger(__name__)

# The marginalization stages compile to single CPU-backend programs: they are
# tiny dense f64 algebra (<= 60x60 eigh), jitted so that each runs as one
# program instead of an eager op-by-op dispatch storm, with numpy inputs
# under the CPU device context (utils/devices.host_cpu).
_init_sparsify_j = jax.jit(init_sparsify, static_argnames=("Vo",))
_marg_forward_j = jax.jit(marg_forward)
_marg_backward_j = jax.jit(marg_backward, static_argnames=("Vo",))


def _to_np(tree):
    """Pull a pytree to host numpy (one blocking transfer per leaf; used only
    at CPU-backend boundaries where the 'transfer' is a local copy)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)

INITIAL = 0
NON_LINEAR = 2

MARGIN_OLD = 0
MARGIN_NEW = 1


@dataclass
class KeyframePoints:
    """Per-keyframe export to the pose graph builder (System.cpp:356–397):
    world points + their normalized observations in that keyframe."""

    ts: float
    points_w: np.ndarray  # (n,3)
    pts_norm: np.ndarray  # (n,2)
    ids: np.ndarray  # (n,)


class Estimator:
    def __init__(self, cfg: EngineConfig, dims: Optional[WindowDims] = None,
                 solve_async: bool = False):
        """solve_async=True pipelines the steady-state window solve across
        frames: process_image DISPATCHES the fused device solve and returns;
        the result is collected (and the state installed, priors dragged,
        marginalization submitted, window slid) by collect_solve() at the
        START of the next frame, before its IMU feed. Pipelining overlaps the
        device solve with the next frame's tracker/bookkeeping host work —
        the same overlap the reference gets from its frontend/backend thread
        pair (System.cpp:224); whether it pays on the H100 is unmeasured
        (ROADMAP Queue 3 debt 2). Outputs are value-identical to the
        synchronous mode, delivered one pub_image later (drain
        `ready_poses`)."""
        self.cfg = cfg
        self.solve_async = bool(solve_async)
        w = cfg.window
        self.dims = dims or WindowDims(
            B=w.all_size, Vo=w.vo_size, F=w.max_features, N=3072
        )
        B = self.dims.B
        C = w.max_imu_per_frame
        self.C = C

        self.noise = ImuNoise.from_config(cfg.noise)
        self.G = np.asarray(cfg.gravity)
        self.min_parallax = cfg.solver.min_parallax_px / cfg.noise.pixel_sqrt_info

        # online extrinsic calibration mode (estimator.cpp:139–153): 2 = run
        # the hand-eye calibrator until confident, then drop to 1 = refine the
        # extrinsic block in the window solver; 0 = fixed. The runtime mode
        # and the calibrated rotation persist across failure resets (the
        # reference stores the promotion in the RIC global, which
        # clearState/setParameter re-install).
        self.estimate_extrinsic = int(cfg.estimate_extrinsic)
        self._calib_ric: Optional[np.ndarray] = None
        self.ex_calibrator = (
            ExtrinsicRotationCalibrator(vo_size=self.dims.Vo)
            if self.estimate_extrinsic == 2
            else None
        )

        self.f_manager = FeatureManager(
            self.dims.F, B, self.dims.Vo, self.min_parallax,
            cfg.solver.init_depth, cfg.solver.max_depth,
        )
        self.clear_state()

        # packed steady-solve programs, keyed by (iters, ee, dtype)
        self._packed_solves = {}

        # async marginalization slot (fold the CPU-routed
        # f64 marg into an async slot like loop optimization). One job in
        # flight at a time; submitted at the end of a MARGIN_OLD frame from
        # a SNAPSHOT of everything it reads (the slide mutates the window
        # arrays in place right after), collected at the start of the next
        # solve — the two CPU eigendecomposition programs overlap the next
        # frame's tracker/bookkeeping host work (the jits release the GIL
        # while executing). The reference runs marginalization synchronously
        # inside its backend thread (estimator.cpp:1541-1562); our single
        # host thread buys the same overlap with this slot.
        self._marg_exec = None  # lazy ThreadPoolExecutor(1)
        self._marg_future = None
        self._marg_job_extra = None  # (KeyframePoints,) exported at submit

        # jitted helpers bound to static shapes
        self._integrate_all = jax.jit(
            jax.vmap(
                lambda d, a, g, a0, g0, ba, bg: integrate_segment(
                    d, a, g, a0, g0, ba, bg, self.noise
                )
            )
        )
        # single-segment twin for marg_backward's re-integration at the
        # post-solve bias (re-integrating all B-1 segments there doubled the
        # per-frame preintegration cost for one segment's worth of use)
        self._integrate_one = jax.jit(
            lambda d, a, g, a0, g0, ba, bg: integrate_segment(
                d, a, g, a0, g0, ba, bg, self.noise
            )
        )

    # ------------------------------------------------------------------ state
    def clear_state(self):
        B = self.dims.B
        C = self.C
        # drop any in-flight marginalization: it was computed from the state
        # being discarded (the worker finishes on its snapshots; harmless)
        if getattr(self, "_marg_future", None) is not None:
            self._marg_future.cancel()
            self._marg_future = None
            self._marg_job_extra = None
        # drop any in-flight async solve the same way (its device value is
        # simply never pulled)
        self._solve_pending = None
        self.ready_poses: List[tuple] = []
        self.Ps = np.zeros((B, 3))
        self.Qs = np.tile(np.array([1.0, 0, 0, 0]), (B, 1))
        self.Vs = np.zeros((B, 3))
        self.Bas = np.zeros((B, 3))
        self.Bgs = np.zeros((B, 3))
        self.Headers = np.zeros(B)
        self.tic = np.asarray(self.cfg.tic_np)
        ric = self._calib_ric if self._calib_ric is not None else self.cfg.ric_np
        from ..geom import hostmath as hm
        self.qic = hm.mat_to_quat_np(np.asarray(ric))

        self.imu_dt = np.zeros((B, C))
        self.imu_acc = np.zeros((B, C, 3))
        self.imu_gyr = np.zeros((B, C, 3))
        self.imu_acc0 = np.zeros((B, 3))
        self.imu_gyr0 = np.zeros((B, 3))
        self.imu_cnt = np.zeros(B, dtype=np.int32)
        # segment received more samples than capacity C (e.g. IMU kept
        # streaming across a >1 s camera gap): its preintegration would be
        # silently wrong, so the segment is excluded from the IMU factor
        self.imu_overflow = np.zeros(B, dtype=bool)

        self.frame_count = 0
        self.first_imu = True
        self.acc_0 = np.zeros(3)
        self.gyr_0 = np.zeros(3)
        self.solver_flag = INITIAL
        self.marginalization_flag = MARGIN_OLD
        self.initial_timestamp = -1e18
        self.priors: Optional[PriorState] = None
        self.failure_count = 0

        self.pose_graph_packets: List[PoseGraphPacket] = []
        self.keyframe_points: List[KeyframePoints] = []
        self.last_kld = {}
        self.f_manager = FeatureManager(
            self.dims.F, self.dims.B, self.dims.Vo, self.min_parallax,
            self.cfg.solver.init_depth, self.cfg.solver.max_depth,
        )

    # ------------------------------------------------------------------- IMU
    def process_imu(self, dt: float, acc: np.ndarray, gyr: np.ndarray):
        """Reference estimator.cpp:91–124: buffer the sample into the current
        frame segment and propagate the newest state as initial guess."""
        acc = np.asarray(acc)
        gyr = np.asarray(gyr)
        if self.first_imu:
            self.first_imu = False
            self.acc_0 = acc
            self.gyr_0 = gyr
            j = self.frame_count
            self.imu_acc0[j] = acc
            self.imu_gyr0[j] = gyr

        j = self.frame_count
        if j != 0:
            if self.imu_cnt[j] == 0:
                self.imu_acc0[j] = self.acc_0
                self.imu_gyr0[j] = self.gyr_0
            k = self.imu_cnt[j]
            if k < self.C:
                self.imu_dt[j, k] = dt
                self.imu_acc[j, k] = acc
                self.imu_gyr[j, k] = gyr
                self.imu_cnt[j] += 1
            else:
                if not self.imu_overflow[j]:
                    _log.warning(
                        "IMU segment %d overflowed capacity C=%d; the segment "
                        "is excluded from the IMU factor", j, self.C,
                    )
                self.imu_overflow[j] = True

            # midpoint propagation of the newest state (pure numpy: this
            # runs per IMU SAMPLE, where jnp quat ops would be 3 device
            # dispatches per sample; see geom/hostmath.py)
            from ..geom import hostmath as hm

            R = hm.quat_to_mat_np(self.Qs[j])
            un_acc_0 = R @ (self.acc_0 - self.Bas[j]) - self.G
            un_gyr = 0.5 * (self.gyr_0 + gyr) - self.Bgs[j]
            dq = np.concatenate([[1.0], un_gyr * dt * 0.5])
            q_new = hm.quat_normalize_np(hm.quat_mul_np(self.Qs[j], dq))
            self.Qs[j] = q_new
            R1 = hm.quat_to_mat_np(q_new)
            un_acc_1 = R1 @ (acc - self.Bas[j]) - self.G
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            self.Ps[j] += dt * self.Vs[j] + 0.5 * dt * dt * un_acc
            self.Vs[j] += dt * un_acc
        self.acc_0 = acc
        self.gyr_0 = gyr

    def _segment_delta_q(self, j: int) -> np.ndarray:
        """Gyro-only midpoint preintegrated rotation of frame segment j at the
        current bias estimate (pre_integrations[frame_count]->delta_q). Pure
        numpy: the segment is ≤ C samples and this runs on the host path."""
        q = np.array([1.0, 0.0, 0.0, 0.0])
        n = int(self.imu_cnt[j])
        g_prev = self.imu_gyr0[j]
        bg = self.Bgs[j]
        for k in range(n):
            dt = self.imu_dt[j, k]
            g = self.imu_gyr[j, k]
            phi = (0.5 * (g_prev + g) - bg) * dt
            dq = np.concatenate([[1.0], 0.5 * phi])
            w0, x0, y0, z0 = q
            w1, x1, y1, z1 = dq
            q = np.array([
                w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
                w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
                w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
            ])
            q /= np.linalg.norm(q)
            g_prev = g
        return q

    # ------------------------------------------------------------------ image
    def process_image(self, feat_ids, pts, t: float, vels=None) -> dict:
        """One frame step (reference estimator.cpp:126–211). Returns a dict of
        diagnostics."""
        keyframe = self.f_manager.add_features(self.frame_count, feat_ids, pts, vels)
        self.marginalization_flag = MARGIN_OLD if keyframe else MARGIN_NEW
        self.Headers[self.frame_count] = t
        info = {"keyframe": keyframe, "solved": False}

        # online extrinsic rotation calibration (estimator.cpp:139–153): feed
        # consecutive-frame correspondences + the gyro-preintegrated rotation
        # to the hand-eye calibrator; on confidence, install ric and drop to
        # refinement mode (the solver's extrinsic block takes over).
        if self.estimate_extrinsic == 2 and self.frame_count != 0:
            ci, cj = self.f_manager.get_corresponding(
                self.frame_count - 1, self.frame_count
            )
            if len(ci) >= 9:
                dq = self._segment_delta_q(self.frame_count)
                ric = self.ex_calibrator.push(ci[:, :2], cj[:, :2], dq)
                if ric is not None:
                    self._calib_ric = ric
                    from ..geom import hostmath as hm
                    self.qic = hm.mat_to_quat_np(np.asarray(ric))
                    self.estimate_extrinsic = 1
                    info["extrinsic_calibrated"] = True

        B = self.dims.B
        if self.solver_flag == INITIAL:
            if self.frame_count == B - 1:
                # init only once the extrinsic is at least coarsely known and
                # with a 0.1 s retry throttle (estimator.cpp:160–165)
                ok = False
                if self.estimate_extrinsic != 2 and (t - self.initial_timestamp) > 0.1:
                    # SfM + alignment are f64 host-support work -> CPU backend
                    with host_cpu():
                        ok = self.initial_structure()
                    self.initial_timestamp = t
                info["init"] = ok
                if ok:
                    self.solver_flag = NON_LINEAR
                    self._init_converged = True
                    self.solve_odometry(first=True)
                    if not self._init_converged:
                        # alignment never converged: the init-window scale is
                        # untrustworthy — restart accumulation rather than
                        # freeze a wrong-scale prior (see solve_odometry)
                        info["init"] = False
                        self.clear_state()
                        return info
                    self.slide_window()
                    self.f_manager.remove_failures()
                    info["solved"] = True
                    j = self.dims.B - 1
                    self.ready_poses.append(
                        (float(self.Headers[j]), self.Ps[j].copy(),
                         self.Qs[j].copy())
                    )
                else:
                    self.slide_window()
            else:
                self.frame_count += 1
        elif self.solve_async:
            # cross-frame solve pipeline: dispatch now, install at the next
            # frame's collect_solve() (before its IMU feed)
            self.dispatch_odometry()
            info["solved"] = True
        else:
            self.solve_odometry()
            if self.failure_detection():
                info["failure"] = True
                self.clear_state()
                return info
            self.slide_window()
            self.f_manager.remove_failures()
            info["solved"] = True
            j = self.dims.B - 1
            self.ready_poses.append(
                (float(self.Headers[j]), self.Ps[j].copy(), self.Qs[j].copy())
            )
        return info

    # ----------------------------------------------------------- initialization
    def initial_structure(self) -> bool:
        """Visual-inertial initialization. Implemented in initialization.py
        (SfM + gyro bias + linear alignment); overridable for tests."""
        from .initialization import initial_structure

        return initial_structure(self)

    def set_ground_truth_init(self, P, Q, V, Ba=None, Bg=None):
        """Test/bench hook: bypass SfM initialization with known states."""
        B = self.dims.B
        self.Ps[:] = P[:B]
        self.Qs[:] = Q[:B]
        self.Vs[:] = V[:B]
        if Ba is not None:
            self.Bas[:] = Ba
        if Bg is not None:
            self.Bgs[:] = Bg

    # ------------------------------------------------------------------ solve
    def _window_state(self, dtype=None) -> WindowState:
        """Window state as a HOST (numpy) pytree. `dtype` selects the solve
        precision: the steady-state product path casts to float32 (the
        mixed-precision split promised in __init__.py), while marginalization (eigendecompositions) and the init
        BA call with dtype=None and stay float64. Numpy leaves cross the
        device boundary only inside the jitted calls that consume them."""
        cast = (lambda a: np.asarray(a)) if dtype is None else (
            lambda a: np.asarray(a, dtype=np.dtype(dtype))
        )
        return WindowState(
            P=cast(self.Ps),
            Q=cast(self.Qs),
            V=cast(self.Vs),
            Ba=cast(self.Bas),
            Bg=cast(self.Bgs),
            tic=cast(self.tic),
            qic=cast(self.qic),
            dep=cast(self.f_manager.depth_vector()),
        )

    def _imu_factors(self) -> ImuFactors:
        """Integrate every frame segment at the current bias estimates.
        f64 preintegration runs on the CPU backend (see utils/devices.host_cpu); the
        steady-state solve casts the result to f32 on the accelerator."""
        B = self.dims.B
        with host_cpu():
            pre = _to_np(self._integrate_all(
                self.imu_dt[1:], self.imu_acc[1:], self.imu_gyr[1:],
                self.imu_acc0[1:], self.imu_gyr0[1:],
                self.Bas[:-1], self.Bgs[:-1],
            ))
            valid = (
                (self.imu_cnt[1:] > 0)
                & (pre.sum_dt < 10.0)
                & ~self.imu_overflow[1:]
            )
            return _to_np(ImuFactors.create(pre=pre, valid=valid))

    def _solve_once(self, priors: PriorState, iters: int, dtype=None):
        """One triangulate + window solve + gauge re-anchor pass. Returns the
        projection-factor dict (reused by marginalization). `dtype` casts the
        whole solve (state, factors, priors); host state stays float64. f64
        solves (init BA) run on the CPU backend (host_cpu); the f32
        steady-state solve runs on the accelerator."""
        if dtype is None:
            with host_cpu(), perf.phase("est.triangulate"):
                self.f_manager.triangulate(self.Ps, self.Qs, self.tic, self.qic)
        # else: the packed steady program seeds depths on-device
        solve_ctx = host_cpu() if dtype is None else contextlib.nullcontext()
        with solve_ctx:
            return self._solve_once_inner(priors, iters, dtype)

    def _solve_once_inner(self, priors: PriorState, iters: int, dtype):
        state = self._window_state()
        if dtype is None:
            with perf.phase("est.imu_factors"):
                imu_f = self._imu_factors()
        else:
            # steady-state path: ship the RAW IMU segment buffers and
            # preintegrate ON-DEVICE inside the fused f32 solve program (at
            # the in-state bias, i.e. the same linearization point the host
            # path uses). The host f64 preintegration cost ~8 ms/frame of
            # CPU scan time in the measured frame budget; folded into the
            # packed program it is a sub-ms vmapped scan on the accelerator
            # and rides the existing single dispatch. The f64 path (init BA,
            # marginalization) keeps the host preintegration.
            imu_f = self._raw_imu_factors()
        with perf.phase("est.build_proj"):
            pf = self.f_manager.build_proj_factors(
                self.dims.N, marg_old=(self.marginalization_flag == MARGIN_OLD)
            )
        proj = ProjFactors(
            idx_i=np.asarray(pf["idx_i"], np.int32),
            idx_j=np.asarray(pf["idx_j"], np.int32),
            fidx=np.asarray(pf["fidx"], np.int32),
            pts_i=np.asarray(pf["pts_i"]),
            pts_j=np.asarray(pf["pts_j"]),
            valid=np.asarray(pf["valid"]),
        )
        G = np.asarray(self.G)
        psi = np.asarray(self.cfg.noise.pixel_sqrt_info)

        old_P = self.Ps.copy()
        old_Q = self.Qs.copy()

        if dtype is not None:
            # steady-state product path: ONE packed accelerator call (single
            # upload buffer, one dispatch, one pull) with the f32 cast
            # applied during packing; depth seeding + preintegration run
            # inside the program (one transfer each way per frame)
            args = (state, imu_f, self._tri_inputs(), proj, priors, G, psi)
            pfn = self._get_packed_solve(iters, dtype, args)
            with perf.phase("est.solve_device"):
                new_state, cost = pfn(*args)
        else:
            with host_cpu():
                new_state, cost = _to_np(solve_window(
                    state, imu_f, proj, priors, G, psi, self.dims,
                    iters=iters,
                    estimate_extrinsic=bool(self.estimate_extrinsic),
                ))

        # double2vector: yaw/position gauge re-anchoring (:518–594)
        new_state = self._reanchor(new_state, old_P[0], old_Q[0])

        self.Ps = np.array(new_state.P, dtype=np.float64)
        self.Qs = np.array(new_state.Q, dtype=np.float64)
        self.Vs = np.array(new_state.V, dtype=np.float64)
        self.Bas = np.array(new_state.Ba, dtype=np.float64)
        self.Bgs = np.array(new_state.Bg, dtype=np.float64)
        if self.estimate_extrinsic:
            self.tic = np.array(new_state.tic, dtype=np.float64)
            self.qic = np.array(new_state.qic, dtype=np.float64)
        self.f_manager.set_depths(np.asarray(new_state.dep, dtype=np.float64))
        self.last_cost = float(cost)
        return pf

    def _get_packed_solve(self, iters: int, dtype, args):
        """Get-or-build the packed steady-solve program for (iters,
        extrinsic-mode, dtype) — raw IMU buffers preintegrate on-device at
        the in-state bias (see _solve_once_inner)."""
        key = (iters, bool(self.estimate_extrinsic), np.dtype(dtype).name)
        pfn = self._packed_solves.get(key)
        if pfn is None:
            noise = ImuNoise(*(float(x) for x in self.noise))
            max_depth = float(self.cfg.solver.max_depth)

            def _device_triangulate(st, obs, has_obs, start):
                """Masked multi-view DLT seeding ON-DEVICE (the f64 host
                twin, feature_manager._triangulate_batch, cost ~6-12 ms of
                frame-path CPU; the SVD nullspace becomes an eigh of the
                4x4 Gram — f32-safe, batched, and rides the existing
                dispatch). Returns (F,) metric depths (garbage where the
                track has <2 observations — the caller masks)."""
                from ..geom import quat_to_mat

                R = quat_to_mat(st.Q)
                Ric = quat_to_mat(st.qic)
                t_cam = st.P + jnp.einsum("bij,j->bi", R, st.tic)
                R_cam = jnp.einsum("bij,jk->bik", R, Ric)

                def one(o, m, s):
                    t0 = t_cam[s]
                    R0 = R_cam[s]
                    t_rel = jnp.einsum("ji,bi->bj", R0, t_cam - t0)
                    R_rel = jnp.einsum("ji,bik->bjk", R0, R_cam)
                    Pl = jnp.swapaxes(R_rel, -1, -2)
                    Pt = -jnp.einsum("bij,bj->bi", Pl, t_rel)
                    Pm = jnp.concatenate([Pl, Pt[..., None]], axis=-1)
                    # unobserved rows are zero-padded; sanitize before the
                    # normalize (0/0 NaN would poison through the mask)
                    o = jnp.where(
                        m[:, None], o, jnp.array([0.0, 0.0, 1.0], o.dtype))
                    f = o / jnp.linalg.norm(o, axis=-1, keepdims=True)
                    row0 = f[:, 0:1] * Pm[:, 2, :] - f[:, 2:3] * Pm[:, 0, :]
                    row1 = f[:, 1:2] * Pm[:, 2, :] - f[:, 2:3] * Pm[:, 1, :]
                    w = m.astype(o.dtype)[:, None]
                    A = jnp.concatenate([row0 * w, row1 * w], axis=0)
                    G = A.T @ A
                    _, V = jnp.linalg.eigh(G)
                    v = V[:, 0]
                    return v[2] / jnp.where(jnp.abs(v[3]) > 1e-12, v[3], 1e-12)

                return jax.vmap(one)(obs, has_obs, start)

            def _steady_solve(st, im_raw, tri, pr, pri, g, ps):
                obs, has_obs, start, need = tri
                d = _device_triangulate(st, obs, has_obs, start)
                ok = jnp.isfinite(d) & (d > 0.1)
                inv = 1.0 / jnp.clip(d, 0.1, max_depth)
                st = st._replace(dep=jnp.where(need & ok, inv, st.dep))
                dts, accs, gyrs, a0, g0, valid = im_raw
                pre = jax.vmap(
                    lambda dd, a, gy, aa, gg, ba, bg: integrate_segment(
                        dd, a, gy, aa, gg, ba, bg, noise
                    )
                )(dts, accs, gyrs, a0, g0, st.Ba[:-1], st.Bg[:-1])
                im = ImuFactors.create(pre=pre, valid=valid)
                return solve_window(
                    st, im, pr, pri, g, ps, self.dims, iters=iters,
                    estimate_extrinsic=bool(self.estimate_extrinsic),
                )

            pfn = PackedFn(_steady_solve, args, float_dtype=dtype,
                           single_buffer=True)
            self._packed_solves[key] = pfn
        return pfn

    def _tri_inputs(self):
        """Device-triangulation side inputs: per-track observations + the
        rows needing a fresh depth seed (good, untriangulated, not
        outlier-flagged — the host triangulate's own need mask)."""
        fm = self.f_manager
        need = fm.good_mask() & (fm.depth <= 0) & ~fm.outlier
        return (fm.obs, fm.has_obs, fm.start.astype(np.int32), need)

    def _raw_imu_factors(self):
        """Raw per-segment IMU buffers + host validity for the on-device
        preintegration path."""
        sum_dt = self.imu_dt[1:].sum(axis=1)
        return (
            self.imu_dt[1:], self.imu_acc[1:], self.imu_gyr[1:],
            self.imu_acc0[1:], self.imu_gyr0[1:],
            ((self.imu_cnt[1:] > 0) & (sum_dt < 10.0)
             & ~self.imu_overflow[1:]),
        )

    # ---------------------------------------------- cross-frame solve pipeline
    def dispatch_odometry(self):
        """Async steady-state odometry (solve_async mode): triangulate +
        build factors + DISPATCH the fused device solve without blocking.
        collect_solve() installs the result before the next frame's IMU
        feed."""
        assert self._solve_pending is None, "collect_solve() first"
        G = np.asarray(self.G)
        psi = np.asarray(self.cfg.noise.pixel_sqrt_info)
        assert self.cfg.solver.solve_dtype == "float32", (
            "solve_async requires the packed f32 steady path")
        # depth seeding happens on-device inside the packed program
        with perf.phase("est.build_proj"):
            pf = self.f_manager.build_proj_factors(
                self.dims.N, marg_old=(self.marginalization_flag == MARGIN_OLD)
            )
        proj = ProjFactors(
            idx_i=np.asarray(pf["idx_i"], np.int32),
            idx_j=np.asarray(pf["idx_j"], np.int32),
            fidx=np.asarray(pf["fidx"], np.int32),
            pts_i=np.asarray(pf["pts_i"]),
            pts_j=np.asarray(pf["pts_j"]),
            valid=np.asarray(pf["valid"]),
        )
        # the previous frame's marg must land before its priors are packed
        self.collect_marg()
        old = (self.Ps.copy(), self.Qs.copy(), self.Vs.copy(),
               self.Bas.copy(), self.Bgs.copy())
        args = (self._window_state(), self._raw_imu_factors(),
                self._tri_inputs(), proj, self.priors, G, psi)
        pfn = self._get_packed_solve(
            self.cfg.solver.max_iterations, jnp.float32, args)
        if getattr(self, "_defer_dispatch", False):
            # multi-sequence coordination (parallel/multi_seq.py): leave the
            # prepared args for the coordinator's ONE sharded batched solve
            handle = None
        else:
            with perf.phase("est.solve_dispatch"):
                handle = pfn.dispatch(*args)
        self._solve_pending = {
            "handle": handle, "args": args, "pfn": pfn,
            "old": old, "pf": pf, "G": G, "psi": psi,
            "marg_flag": self.marginalization_flag,
        }

    def collect_solve(self):
        """Install a pending async solve: reanchor, state install, outlier
        cull, prior drag, async marg submit, failure check, window slide.
        No-op when nothing is pending."""
        if self._solve_pending is None:
            return
        p, self._solve_pending = self._solve_pending, None
        if p["handle"] is None:
            # deferred dispatch that no coordinator picked up: run it now
            p["handle"] = p["pfn"].dispatch(*p["args"])
        with perf.phase("est.solve_collect"):
            new_state, cost = p["handle"].collect()
        old_P, old_Q, old_V, old_Ba, old_Bg = p["old"]
        new_state = self._reanchor(new_state, old_P[0], old_Q[0])
        self.Ps = np.array(new_state.P, dtype=np.float64)
        self.Qs = np.array(new_state.Q, dtype=np.float64)
        self.Vs = np.array(new_state.V, dtype=np.float64)
        self.Bas = np.array(new_state.Ba, dtype=np.float64)
        self.Bgs = np.array(new_state.Bg, dtype=np.float64)
        if self.estimate_extrinsic:
            self.tic = np.array(new_state.tic, dtype=np.float64)
            self.qic = np.array(new_state.qic, dtype=np.float64)
        self.f_manager.set_depths(np.asarray(new_state.dep, dtype=np.float64))
        self.last_cost = float(cost)
        with perf.phase("est.mark_outliers"):
            self.f_manager.mark_outliers(
                self.Ps, self.Qs, self.tic, self.qic,
                focal=float(self.cfg.camera.fx),
                thresh_px=self.cfg.solver.outlier_reproj_px,
            )
        with perf.phase("est.drag_priors"):
            self._drag_priors(old_P, old_Q, old_V, old_Ba, old_Bg)
        self.marginalization_flag = p["marg_flag"]
        if p["marg_flag"] == MARGIN_OLD:
            with perf.phase("est.marginalize"):
                self._marginalize(p["pf"], p["G"], p["psi"], asynchronous=True)
        if self.failure_detection():
            self.clear_state()
            return
        self.slide_window()
        self.f_manager.remove_failures()
        j = self.dims.B - 1
        self.ready_poses.append(
            (float(self.Headers[j]), self.Ps[j].copy(), self.Qs[j].copy())
        )

    def _init_scale_scan(self, iters: int = 8):
        """Parallel-hypothesis global-scale search (init only).

        The closed-form visual-inertial alignment is an errors-in-variables
        regression: the SfM translations multiply the scale unknown, so
        1%-level structured SfM translation error attenuates the solved scale
        toward zero (measured on the loop-closure e2e world: true relative
        scale 0.75, alignment returned 0.093; 1% synthetic T noise alone
        collapses it to 0.003). LM cannot recover afterwards: the wrong-scale
        window is a LOCAL minimum separated from the true basin by a
        scale/accel-bias ridge (cost 486 vs 61 on that window, 50 LM
        iterations stay at 486).

        Instead of trusting the diluted regression, scan the scale direction
        explicitly: the projection cost is invariant to scaling (P about P0,
        V, depths), so the window cost along the scale axis is pure IMU
        information. vmap solve_window over log-spaced scale candidates (one
        batched device program), adopt the deepest basin. The curve's
        contrast doubles as an OBSERVABILITY gate: a flat curve means the
        window cannot identify scale and initialization must be refused
        (reference analogue: checkIMUExcitation, estimator.cpp:213–238, which
        gates on raw accelerometer variance rather than the actual
        identifiability of the solve).

        Returns (best_scale, costs, scales)."""
        with host_cpu():
            return self._init_scale_scan_inner(iters)

    def _init_scale_scan_inner(self, iters: int):
        self.f_manager.triangulate(self.Ps, self.Qs, self.tic, self.qic)
        state = self._window_state()
        imu_f = self._imu_factors()
        pf = self.f_manager.build_proj_factors(self.dims.N, marg_old=False)
        proj = ProjFactors(
            idx_i=jnp.asarray(pf["idx_i"]),
            idx_j=jnp.asarray(pf["idx_j"]),
            fidx=jnp.asarray(pf["fidx"]),
            pts_i=jnp.asarray(pf["pts_i"]),
            pts_j=jnp.asarray(pf["pts_j"]),
            valid=jnp.asarray(pf["valid"]),
        )
        G = jnp.asarray(self.G)
        psi = jnp.asarray(self.cfg.noise.pixel_sqrt_info)
        priors = PriorState.empty(self.dims.Vo)
        scales = np.array([0.25, 0.4, 0.6, 0.8, 1.0, 1.3, 1.8, 2.6, 4.0])

        def one(s):
            st = state._replace(
                P=(state.P - state.P[0]) * s + state.P[0],
                V=state.V * s,
                dep=state.dep / s,
            )
            return solve_window(st, imu_f, proj, priors, G, psi, self.dims,
                                iters=iters)

        sts, costs = jax.vmap(one)(jnp.asarray(scales))
        costs = np.asarray(costs)
        best = int(np.nanargmin(costs))
        best_state = jax.tree_util.tree_map(lambda a: a[best], sts)
        best_state = self._reanchor(best_state, self.Ps[0], self.Qs[0])
        self.Ps = np.array(best_state.P, dtype=np.float64)
        self.Qs = np.array(best_state.Q, dtype=np.float64)
        self.Vs = np.array(best_state.V, dtype=np.float64)
        self.Bas = np.array(best_state.Ba, dtype=np.float64)
        self.Bgs = np.array(best_state.Bg, dtype=np.float64)
        self.f_manager.set_depths(np.asarray(best_state.dep, dtype=np.float64))
        return float(scales[best]), costs, scales

    def solve_odometry(self, first: bool = False):
        """triangulate + solve + prior drag + marg (solveOdometry /
        backendOptimization, estimator.cpp:461–472, 1541–1562). On the first
        call after initialization this runs BOTH passes, like the reference's
        back-to-back ifs in backendOptimization: full-window BA +
        init_sparsify, then the normal prior-constrained solve + marg."""
        # install the previous frame's async marg result (and its deferred
        # prior slide) before anything reads self.priors
        self.collect_marg()
        G = np.asarray(self.G)
        psi = np.asarray(self.cfg.noise.pixel_sqrt_info)

        if first:
            # initFactorGraph (:667–1001): full BA without priors, then
            # recover the initial sparse prior set at the solved state.
            # The BA alternates with the closed-form scale/gravity/velocity
            # re-alignment (vi_init.realign_window): LM alone converges the
            # stiff global scale/gravity directions only logarithmically, and
            # any residual attitude error at sparsification time is frozen
            # into the rollpitch/VB priors (a 4 deg error leaks ~0.7 m/s^2 of
            # gravity into the dynamics and diverges the whole run).
            # Alternate to CONVERGENCE (realign reports "converged"), not a
            # fixed 2 rounds: on weakly-excited windows the SfM-seeded scale
            # can start 8x off and each round only contracts it, so 2 rounds
            # left a 3x scale error that poisoned the init priors and the
            # whole run (loop-closure e2e world). If the alternation never
            # converges, the caller must reject the init and retry later —
            # signaled via self._init_converged.
            from .vi_init import realign_window, refine_gyro_bias

            self._solve_once(
                PriorState.empty(self.dims.Vo), self.cfg.solver.init_max_iterations
            )
            status = {}
            for _ in range(6):
                # gyro-bias re-estimation rides the alternation: the one-shot
                # SfM-rotation estimate drifts with window length (see
                # refine_gyro_bias) and the bias direction is too stiff for
                # the BA to recover alone
                dbg_norm = refine_gyro_bias(self)
                moved = realign_window(self, status)
                if not moved and dbg_norm < 2e-3:
                    break
                self._solve_once(
                    PriorState.empty(self.dims.Vo),
                    self.cfg.solver.init_max_iterations,
                )
            # parallel-hypothesis scale search + observability gate (the
            # alignment above is an attenuated errors-in-variables regression
            # and can leave an arbitrarily wrong global scale; see
            # _init_scale_scan)
            s_best, costs, scales = self._init_scale_scan()
            if s_best in (scales[0], scales[-1]):
                # basin at the scan edge: true scale may lie outside the
                # candidate range — re-scan centered on the adopted state
                s2, costs, scales = self._init_scale_scan()
                s_best *= s2
            finite = np.isfinite(costs)
            if not finite.any():
                self._init_converged = False
            else:
                c_best = float(np.nanmin(costs))
                c_max = float(np.nanmax(costs[finite]))
                # flatness gate: if no scale in a 16x range changes the cost
                # by >=30%, the window cannot identify scale at all — refuse
                # to initialize rather than freeze an arbitrary one into the
                # priors (reference analogue: checkIMUExcitation)
                self._init_converged = c_max > 1.3 * max(c_best, 1e-9)
            _log.info(
                "init scale scan: best s=%.2f costs=%s converged=%s",
                s_best, np.array2string(costs, precision=1), self._init_converged,
            )
            if not self._init_converged:
                _log.warning(
                    "init scale unobservable (scan costs %s); rejecting "
                    "initialization", np.array2string(costs, precision=1),
                )
                return
            # polish at the adopted scale
            self._solve_once(
                PriorState.empty(self.dims.Vo), self.cfg.solver.init_max_iterations
            )
            pre_vo = jax.tree_util.tree_map(
                lambda a: a[: self.dims.Vo - 1], self._imu_factors().pre
            )
            with host_cpu():
                self.priors, kld = _to_np(_init_sparsify_j(
                    self._window_state(), pre_vo, G, Vo=self.dims.Vo,
                    alpha=self.cfg.solver.alpha,
                ))
            self.last_kld["init"] = float(kld)

        old_P = self.Ps.copy()
        old_Q = self.Qs.copy()
        old_V = self.Vs.copy()
        old_Ba = self.Bas.copy()
        old_Bg = self.Bgs.copy()

        # steady-state solve precision (mixed-precision split): f32 on the
        # accelerator; init BA above and marginalization below are f64
        sdt = (
            jnp.float32 if self.cfg.solver.solve_dtype == "float32" else None
        )
        pf = self._solve_once(self.priors, self.cfg.solver.max_iterations, dtype=sdt)

        # post-solve reprojection outlier culling (flagged rows are erased by
        # remove_failures after the slide; see FeatureManager.mark_outliers)
        with perf.phase("est.mark_outliers"):
            self.f_manager.mark_outliers(
                self.Ps, self.Qs, self.tic, self.qic,
                focal=float(self.cfg.camera.fx),
                thresh_px=self.cfg.solver.outlier_reproj_px,
            )

        # exact pseudo-measurement drag old -> final states (:1132–1144)
        with perf.phase("est.drag_priors"):
            self._drag_priors(old_P, old_Q, old_V, old_Ba, old_Bg)
        if self.marginalization_flag == MARGIN_OLD:
            with perf.phase("est.marginalize"):
                # async in steady state (collected at the next solve); the
                # first post-init marg stays inline — its outputs seed the
                # prior set the very next statement group uses
                self._marginalize(pf, G, psi, asynchronous=not first)

    def _reanchor(self, st: WindowState, P0_old, Q0_old) -> WindowState:
        """Rotate/translate the solution so frame-0 yaw and position match
        their pre-solve values (double2vector, estimator.cpp:518–560).
        Host numpy (geom/hostmath): runs once per solve on (B,·) arrays."""
        from ..geom import hostmath as hm

        Q_np = np.asarray(st.Q)
        P_np = np.asarray(st.P)
        V_np = np.asarray(st.V)
        ypr_old = hm.mat_to_ypr_np(hm.quat_to_mat_np(np.asarray(Q0_old)))
        ypr_new = hm.mat_to_ypr_np(hm.quat_to_mat_np(Q_np[0]))
        y_diff = ypr_old[0] - ypr_new[0]
        if abs(abs(ypr_old[1]) - 90) < 1.0 or abs(abs(ypr_new[1]) - 90) < 1.0:
            # euler singularity: full rotation difference (:538–547)
            rot = hm.quat_to_mat_np(np.asarray(Q0_old)) @ hm.quat_to_mat_np(Q_np[0]).T
        else:
            rot = hm.ypr_to_mat_np([y_diff, 0.0, 0.0])
        rq = hm.mat_to_quat_np(rot)
        P = (P_np - P_np[0]) @ rot.T + np.asarray(P0_old)
        Q = np.stack([hm.quat_normalize_np(hm.quat_mul_np(rq, Q_np[k]))
                      for k in range(Q_np.shape[0])])
        V = V_np @ rot.T
        return st._replace(P=P, Q=Q, V=V)

    def _drag_priors(self, old_P, old_Q, old_V, old_Ba, old_Bg):
        """Exact drags of all pseudo-measurements to the new states. Host
        numpy (factors.priors *_np twins): ~10 per-frame device dispatches
        otherwise (geom/hostmath rationale)."""
        from ..factors.priors import (
            relpose_update_np,
            rollpitch_update_np,
            se3_prior_update_np,
        )

        pr = self.priors
        Vo = self.dims.Vo
        nP, nQ = self.Ps, self.Qs

        se3_t, se3_q = se3_prior_update_np(
            np.asarray(pr.se3_t), np.asarray(pr.se3_q),
            old_P[0], old_Q[0], nP[0], nQ[0],
        )

        # linear prior: exact drag = shift by the state delta (linear9_factor.h:60–68)
        k = Vo - 1
        vb_old_state = np.concatenate([old_V[k], old_Ba[k], old_Bg[k]])
        vb_new_state = np.concatenate([self.Vs[k], self.Bas[k], self.Bgs[k]])
        vb_new = np.asarray(pr.vb) + (vb_new_state - vb_old_state)

        p_rel_dt = np.asarray(pr.rel_dt)
        p_rel_dq = np.asarray(pr.rel_dq)
        rel_dt, rel_dq = [], []
        for kk in range(Vo):
            i = kk - 1 if kk >= 1 else 0
            dt_k, dq_k = relpose_update_np(
                p_rel_dt[kk], p_rel_dq[kk],
                old_P[i], old_Q[i], old_P[kk], old_Q[kk],
                nP[i], nQ[i], nP[kk], nQ[kk],
            )
            rel_dt.append(dt_k)
            rel_dq.append(dq_k)

        p_rp_q = np.asarray(pr.rp.q_meas)
        p_rp_idx = np.asarray(pr.rp.idx)
        rp_q = []
        for kk in range(p_rp_idx.shape[0]):
            idx = int(p_rp_idx[kk])
            rp_q.append(rollpitch_update_np(p_rp_q[kk], old_Q[idx], nQ[idx]))

        self.priors = pr._replace(
            se3_t=np.asarray(se3_t),
            se3_q=np.asarray(se3_q),
            vb=np.asarray(vb_new),
            rel_dt=np.stack(rel_dt),
            rel_dq=np.stack(rel_dq),
            rp=pr.rp._replace(q_meas=np.stack(rp_q)),
        )

    def _marginalize(self, pf: dict, G, psi, asynchronous: bool = False):
        """MargForward + MargBackward at the final state (:1554–1557). f64
        eigendecompositions -> CPU backend (host_cpu).

        asynchronous=True submits the two CPU programs to the marg worker
        from a SNAPSHOT (the in-place window slide right after would race
        the device upload otherwise); the result is collected — and the
        deferred prior slide applied — by collect_marg() at the start of the
        next solve, overlapping the marg compute with the next frame's
        tracker/bookkeeping host work."""
        snap = self._marg_snapshot(pf, G, psi)
        with perf.phase("est.export_kf_points"):
            kfp = self._export_keyframe_points()
        if not asynchronous:
            self._install_marg(self._marg_compute(*snap), kfp)
            return
        if self._marg_exec is None:
            from concurrent.futures import ThreadPoolExecutor

            self._marg_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="marg")
        assert self._marg_future is None, "one marg job in flight at a time"
        self._marg_job_extra = kfp
        self._marg_future = self._marg_exec.submit(self._marg_compute, *snap)

    def collect_marg(self):
        """Collect a pending async marginalization: install the packet /
        keyframe export / pending prior edges, then apply the deferred
        prior slide (the window arrays slid at the end of the submitting
        frame; the priors catch up here, before anything reads them)."""
        if self._marg_future is None:
            return
        with perf.phase("est.marg_collect"):
            out = self._marg_future.result()
        self._marg_future = None
        kfp, self._marg_job_extra = self._marg_job_extra, None
        self._install_marg(out, kfp)
        self._slide_priors()

    def _marg_snapshot(self, pf: dict, G, psi):
        """Copy everything the marg programs read (window state, priors,
        capped marg factor rows, segment-Vo IMU buffers)."""
        Vo = self.dims.Vo
        state = WindowState(
            P=self.Ps.copy(), Q=self.Qs.copy(), V=self.Vs.copy(),
            Ba=self.Bas.copy(), Bg=self.Bgs.copy(),
            tic=self.tic.copy(), qic=self.qic.copy(),
            dep=np.array(self.f_manager.depth_vector()),
        )
        pr = jax.tree_util.tree_map(lambda a: np.array(a), self.priors)
        L = 192
        mp_i = np.tile([[0, 0, 1.0]], (L, 1))
        mp_j = np.tile([[0, 0, 1.0]], (L, 1))
        mf = np.zeros(L, np.int32)
        mv = np.zeros(L, bool)
        n_all = len(pf["marg_fidx"])
        if n_all > L:
            # keep the top-L most informative factors: for inverse-depth
            # reprojection the position information scales with the observed
            # parallax between host and observing frame, so rank by
            # image-plane displacement (the reference marginalizes all
            # frame-0 factors; we cap the device shape but keep the factors
            # that carry the constraint mass, and say so). The retained
            # information is measured against the UNCAPPED set by
            # marg_cap_kld_bound (tests/test_marginalization.py).
            score = np.linalg.norm(
                np.asarray(pf["marg_pts_i"])[:, :2] - np.asarray(pf["marg_pts_j"])[:, :2],
                axis=1,
            )
            keep = np.argsort(-score)[:L]
            keep.sort()  # preserve original factor order
            _log.warning(
                "marg_forward factor cap: %d observations > L=%d; keeping the "
                "top-%d by parallax (min kept score %.4f)",
                n_all, L, L, float(score[keep].min()),
            )
        else:
            keep = np.arange(n_all)
        n = len(keep)
        mp_i[:n] = pf["marg_pts_i"][keep]
        mp_j[:n] = pf["marg_pts_j"][keep]
        mf[:n] = pf["marg_fidx"][keep]
        mv[:n] = True
        imu_seg = (
            self.imu_dt[Vo].copy(), self.imu_acc[Vo].copy(),
            self.imu_gyr[Vo].copy(), self.imu_acc0[Vo].copy(),
            self.imu_gyr0[Vo].copy(),
            self.Bas[Vo - 1].copy(), self.Bgs[Vo - 1].copy(),
        )
        return (state, pr, mp_i, mp_j, mf, mv, np.asarray(psi),
                float(self.Headers[0]), imu_seg, np.asarray(G))

    def _marg_compute(self, state, pr, mp_i, mp_j, mf, mv, psi, header0,
                      imu_seg, G):
        """Pure compute half (runs on the marg worker thread or inline):
        no estimator state is read or written."""
        Vo = self.dims.Vo
        with host_cpu():
            with perf.phase("est.marg_forward"):
                fwd = _to_np(_marg_forward_j(
                    state, pr, mp_i, mp_j, mf, mv,
                    psi, self.cfg.solver.alpha, header0,
                ))
            # re-integrate ONLY segment Vo (frames Vo-1 -> Vo) at the
            # post-solve bias (the reference's repropagate; estimator.cpp:1382)
            with perf.phase("est.marg_backward"):
                pre_ij = _to_np(self._integrate_one(*imu_seg))
                back = _to_np(_marg_backward_j(
                    state, pre_ij, pr, G, Vo=Vo,
                    alpha=self.cfg.solver.alpha,
                ))
        return fwd, back

    def _install_marg(self, out, kfp):
        (t1, q1, sq1, packet, kld_f), back = out
        (rel_dt, rel_dq, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt, kld_b) = back
        self.pose_graph_packets.append(packet)
        self.keyframe_points.append(kfp)
        self.last_kld["forward"] = float(kld_f)
        self.last_kld["backward"] = float(kld_b)
        self._pending_se3 = (t1, q1, sq1)
        self._pending_backward = (
            rel_dt, rel_dq, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt)

    def _export_keyframe_points(self) -> KeyframePoints:
        """Compute (do not append) the world points + their frame-0
        normalized projections for the pose graph keyframe
        (System.cpp:356–397). The reference exports only
        features *observed* at frame 0 (start_frame==0); we export EVERY
        solved landmark in the window projected into frame 0's camera — the
        keyframe image contains all visible landmarks whether or not the
        tracker held their track to frame 0, and loop verification (PnP on
        these 3D points) is starved without them (measured: observed-only
        export yields ~5 matchable points per keyframe on a 70-feature
        synthetic run vs min_loop_matches=15). Out-of-view projections are
        filtered here (z) and by the builder (image bounds)."""
        fm = self.f_manager
        good = fm.good_mask() & (fm.depth > 0)
        rows = np.where(good)[0]
        if len(rows) == 0:
            return KeyframePoints(
                self.Headers[0], np.zeros((0, 3)), np.zeros((0, 2)), np.zeros(0)
            )
        from ..geom import hostmath as hm

        hosts = fm.start[rows]
        pts_i = fm.obs[rows, hosts]  # (n,3) normalized bearing in host cam
        depths = fm.depth[rows]
        R = np.stack([hm.quat_to_mat_np(self.Qs[k]) for k in range(self.dims.B)])
        Ric = hm.quat_to_mat_np(self.qic)
        # world points from host-frame inverse depth (vectorized)
        pc = pts_i * depths[:, None]
        pb = pc @ Ric.T + self.tic
        pw = np.einsum("nij,nj->ni", R[hosts], pb) + self.Ps[hosts]
        # project into frame-0 camera
        Rc0 = R[0] @ Ric
        Pc0 = self.Ps[0] + R[0] @ self.tic
        p0 = (pw - Pc0) @ Rc0
        vis = p0[:, 2] > 0.1
        norm0 = p0[vis, :2] / p0[vis, 2:3]
        return KeyframePoints(
            self.Headers[0], pw[vis], norm0, fm.ids[rows[vis]].copy()
        )

    # ------------------------------------------------------------- failure
    def failure_detection(self) -> bool:
        """estimator.cpp:596–665 (only the bias-norm checks are live)."""
        B1 = self.dims.B - 1
        if np.linalg.norm(self.Bas[B1]) > self.cfg.solver.bias_acc_threshold:
            self.failure_count += 1
            return True
        if np.linalg.norm(self.Bgs[B1]) > self.cfg.solver.bias_gyr_threshold:
            self.failure_count += 1
            return True
        return False

    # -------------------------------------------------------------- sliding
    def slide_window(self):
        B = self.dims.B
        Vo = self.dims.Vo
        from ..geom import hostmath as hm

        if self.marginalization_flag == MARGIN_OLD:
            back_R0 = hm.quat_to_mat_np(self.Qs[0])
            back_P0 = self.Ps[0].copy()
            if self.frame_count == B - 1:
                # shift all arrays down (:1575–1603)
                for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.Headers):
                    arr[:-1] = arr[1:]
                for arr in (
                    self.imu_dt, self.imu_acc, self.imu_gyr,
                    self.imu_acc0, self.imu_gyr0, self.imu_cnt,
                    self.imu_overflow,
                ):
                    arr[:-1] = arr[1:]
                self.imu_cnt[B - 1] = 0
                self.imu_dt[B - 1] = 0
                self.imu_overflow[B - 1] = False
                self.imu_acc0[B - 1] = self.acc_0
                self.imu_gyr0[B - 1] = self.gyr_0

                if self.solver_flag == NON_LINEAR and self.priors is not None:
                    if self._marg_future is None:
                        self._slide_priors()
                    # else: marg is in flight — collect_marg() applies the
                    # prior slide when it lands (before the next solve)

                # feature bookkeeping (:1707–1724)
                Ric = hm.quat_to_mat_np(self.qic)
                R0 = back_R0 @ Ric
                P0 = back_P0 + back_R0 @ self.tic
                new_R0 = hm.quat_to_mat_np(self.Qs[0])
                R1 = new_R0 @ Ric
                P1 = self.Ps[0] + new_R0 @ self.tic
                if self.solver_flag == NON_LINEAR:
                    self.f_manager.remove_back_shift_depth(R0, P0, R1, P1)
                else:
                    self.f_manager.remove_back()
        else:
            if self.frame_count == B - 1:
                # merge newest segment's IMU into the previous one (:1664–1697)
                j = self.frame_count
                n_prev = self.imu_cnt[j - 1]
                n_new = self.imu_cnt[j]
                room = self.C - n_prev
                take = min(n_new, room)
                self.imu_dt[j - 1, n_prev : n_prev + take] = self.imu_dt[j, :take]
                self.imu_acc[j - 1, n_prev : n_prev + take] = self.imu_acc[j, :take]
                self.imu_gyr[j - 1, n_prev : n_prev + take] = self.imu_gyr[j, :take]
                self.imu_cnt[j - 1] += take
                if take < n_new or self.imu_overflow[j]:
                    if not self.imu_overflow[j - 1]:
                        _log.warning(
                            "IMU merge overflow at segment %d; the merged "
                            "segment is excluded from the IMU factor", j - 1,
                        )
                    self.imu_overflow[j - 1] = True

                for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.Headers):
                    arr[j - 1] = arr[j]
                self.imu_cnt[j] = 0
                self.imu_dt[j] = 0
                self.imu_overflow[j] = False
                self.imu_acc0[j] = self.acc_0
                self.imu_gyr0[j] = self.gyr_0
                self.f_manager.remove_front(self.frame_count)

    def _slide_priors(self):
        """Install pending marginalization outputs + shift edge indices
        (slideWindow, estimator.cpp:1605–1638)."""
        pr = self.priors
        Vo = self.dims.Vo

        # relpose edges: drop (0,1); shift k -> k-1; new backward edge at Vo-1
        rel_dt = np.asarray(pr.rel_dt).copy()
        rel_dq = np.asarray(pr.rel_dq).copy()
        rel_sqrt = np.asarray(pr.rel_sqrt).copy()
        rel_valid = np.asarray(pr.rel_valid).copy()
        rel_dt[1 : Vo - 1] = rel_dt[2:Vo]
        rel_dq[1 : Vo - 1] = rel_dq[2:Vo]
        rel_sqrt[1 : Vo - 1] = rel_sqrt[2:Vo]
        rel_valid[1 : Vo - 1] = rel_valid[2:Vo]

        b_dt, b_dq, b_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt = self._pending_backward
        rel_dt[Vo - 1] = np.asarray(b_dt)
        rel_dq[Vo - 1] = np.asarray(b_dq)
        rel_sqrt[Vo - 1] = np.asarray(b_sqrt)
        rel_valid[Vo - 1] = True

        # rollpitch: append the backward edge (attached to old frame Vo-1),
        # then shift all indices down and drop index < 0
        rp_qs = list(np.asarray(pr.rp.q_meas))
        rp_sqs = list(np.asarray(pr.rp.sqrt_info))
        rp_idx = list(np.asarray(pr.rp.idx))
        rp_val = list(np.asarray(pr.rp.valid))
        # overwrite an invalid slot (capacity Vo is enough: indices 0..Vo-1)
        slot = rp_val.index(False) if False in rp_val else int(np.argmin(rp_idx))
        rp_qs[slot] = np.asarray(rp_q)
        rp_sqs[slot] = np.asarray(rp_sqrt)
        rp_idx[slot] = Vo - 1
        rp_val[slot] = True
        new_idx = np.asarray(rp_idx) - 1
        new_val = np.asarray(rp_val) & (new_idx >= 0)

        t1, q1, sq1 = self._pending_se3

        self.priors = PriorState(
            se3_t=np.asarray(t1),
            se3_q=np.asarray(q1),
            se3_sqrt=np.asarray(sq1),
            se3_valid=np.asarray(True),
            vb=np.asarray(vb_m),
            vb_sqrt=np.asarray(vb_sqrt),
            vb_valid=np.asarray(True),
            rel_dt=rel_dt,
            rel_dq=rel_dq,
            rel_sqrt=rel_sqrt,
            rel_valid=rel_valid,
            rp=RollPitchFactors(
                q_meas=np.asarray(rp_qs),
                sqrt_info=np.asarray(rp_sqs),
                idx=new_idx.astype(np.int32),
                valid=new_val,
            ),
        )

    # ------------------------------------------------------------- outputs
    def latest_pose(self):
        j = self.dims.B - 1
        return self.Headers[j], self.Ps[j].copy(), self.Qs[j].copy()


def _small_quat(phi):
    """First-order quaternion [1, phi/2] (Utility::deltaQ)."""
    return jnp.concatenate([jnp.ones(1), jnp.asarray(phi) * 0.5])
