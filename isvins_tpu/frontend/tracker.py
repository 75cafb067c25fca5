"""Feature tracker orchestration (replaces FeatureTracker,
src/feature_tracker/feature_tracker_simple.cpp).

Per frame (readImage, :81–151): CLAHE -> pyramidal LK from the previous frame
-> border/err rejection -> epipolar RANSAC outlier rejection on the
normalized plane (rejectWithF, :153–180; the reference's virtual-pinhole
pixel threshold F_THRESHOLD/460 becomes a normalized-plane threshold) ->
min-distance dedup preferring the longest-lived tracks (setMask, :37–69) ->
Shi-Tomasi + NMS refill to max_cnt (:140) -> undistortion + normalized-plane
velocities (:197–244) -> monotonic id assignment (:182–188).

Host object holds fixed-capacity SoA state; ALL per-frame device work is ONE
fused float32 jit (`_step`): CLAHE + LK forward + LK back + border gate +
undistortion of both tracked points and detection candidates + Shi-Tomasi +
NMS. Static shapes throughout (capacity M + masks) — the accelerator compiles
exactly two programs (first frame / steady frame) for the whole run, where a
varying row count would recompile the undistortion and RANSAC every frame.
Pixel geometry needs nowhere near f64, so the device step is f32.

The host epipolar RANSAC (8-point + SVD) stays in f64 on the host CPU
backend: it is tiny (128 hypotheses x M<=150 points)."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .camera import make_camera
from .image_ops import clahe, min_dist_mask, nms_topk, shi_tomasi_response
from .lk import pyramidal_lk
from ..initial.five_point import _ransac_core, epipolar_inliers
from ..utils.devices import host_cpu


class FeatureTracker:
    def __init__(self, cam_cfg, tracker_cfg):
        self.cam = make_camera(cam_cfg)
        # f32 twin for the fused per-frame device step (see module
        # docstring); numpy leaves, embedded at trace time
        self.cam32 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), self.cam
        )
        self.cfg = tracker_cfg
        self.W = cam_cfg.width
        self.H = cam_cfg.height
        M = tracker_cfg.max_cnt
        self.M = M

        self.pts = np.zeros((M, 2))
        self.ids = np.full(M, -1, dtype=np.int64)
        self.track_cnt = np.zeros(M, dtype=np.int32)
        self.valid = np.zeros(M, dtype=bool)
        self.prev_un = np.zeros((M, 3))
        self.prev_img = None  # device array, CLAHE'd f32, output of _step
        self.prev_time = None
        self.next_id = 0
        self._ransac_seed = 0
        self._pending = None

        # epipolar RANSAC placement (TrackerConfig.fused_ransac): fused into
        # the device step on accelerators (the SVD-free eigh variant rides
        # the existing fused dispatch), host f64 on the CPU backend. Which
        # pays on the H100 is unmeasured (ROADMAP Queue 3 debt 4).
        self.fused_ransac = (
            tracker_cfg.fused_ransac
            if tracker_cfg.fused_ransac is not None
            else jax.default_backend() not in ("cpu",)
        )
        self._n_ransac_hyp = 128

        self._step = jax.jit(self._step_impl, static_argnames=("first",))

    def reset(self):
        """Drop all LK state after a stream discontinuity (System.cpp:72–79:
        'image discontinue! reset the feature tracker!'). Track ids keep
        counting up so the estimator never sees a stale id reused."""
        self.pts[:] = 0.0
        self.ids[:] = -1
        self.track_cnt[:] = 0
        self.valid[:] = False
        self.prev_un[:] = 0.0
        self.prev_img = None
        self.prev_time = None
        self._pending = None

    # ------------------------------------------------------------ fused step
    def _step_impl(self, prev_img, img, pts, valid, prev_un2, age_ok,
                   samples, first: bool):
        """The whole per-frame device pipeline as one program. Returns
        (imgf, packed (M,11) f32); fixed capacity M. `img` may arrive uint8
        (native camera dtype; 4x less upload bandwidth) — converted here.
        prev_un2 (M,2) / age_ok (M,) / samples (S,8) feed the fused epipolar
        RANSAC (ignored when fused_ransac is off or on the first frame)."""
        img = img.astype(jnp.float32)
        imgf = clahe(img) if self.cfg.equalize else img

        if first:
            pts1 = pts
            ok = jnp.zeros_like(valid)
        else:
            pts1, okl, _ = pyramidal_lk(
                prev_img, imgf, pts, valid,
                levels=self.cfg.lk_levels, half=self.cfg.lk_win // 2,
            )
            b = float(self.cfg.border)
            inb = (
                (pts1[:, 0] >= b) & (pts1[:, 0] < self.W - b)
                & (pts1[:, 1] >= b) & (pts1[:, 1] < self.H - b)
            )
            ok = okl & valid & inb
            if self.cfg.flow_back:
                # forward-backward consistency (VINS-Fusion FLOW_BACK; the
                # fork lacks it): occlusion-boundary corners and slowly
                # drifting tracks fail the round trip long before they fail
                # the epipolar test — measured on the synthetic room, the
                # worst-decile track error vs its own first observation grows
                # to ~8 px within 10 frames without this gate.
                # Single-level with the original position as the initial
                # guess (cv::OPTFLOW_USE_INITIAL_FLOW): the pyramid's job is
                # large motion, and here the motion is already known — a
                # correct track refines in place, a wrong one wanders off.
                pts0b, okb, _ = pyramidal_lk(
                    imgf, prev_img, pts1, ok,
                    levels=1, half=self.cfg.lk_win // 2, iters=8, guess0=pts,
                )
                rt = jnp.linalg.norm(pts0b - pts, axis=1)
                ok = ok & okb & (rt < self.cfg.flow_back_thresh)

        un1 = self.cam32.lift_projective(pts1)

        if (not first) and self.fused_ransac:
            # fused epipolar rejection (rejectWithF semantics): candidate
            # rows sampled on the host PRE-LK (a superset; hypotheses that
            # drew an LK casualty produce huge residuals and lose the
            # argmax). Degeneracy guard as in the host path: a winner that
            # explains < half the candidates (near-planar view) is ignored.
            m = ok & age_ok
            thresh = float(self.cfg.f_threshold) / float(self.cam.focal)
            inl, n_inl = epipolar_inliers(
                prev_un2.astype(jnp.float32), un1[:, :2], m, samples,
                thresh * thresh,
            )
            n_m = jnp.sum(m)
            trust = (n_m >= 15) & (n_inl >= 0.5 * n_m)
            ok = jnp.where(trust, ok & (inl | ~m), ok)

        # detection candidates for the refill. The forbid mask uses the
        # post-LK (pre-RANSAC, pre-dedup) point set — a superset of the
        # points that survive the host-side culls, so candidates are always
        # min_dist-separated from every surviving track (merely conservative
        # near tracks killed this frame).
        resp = shi_tomasi_response(imgf)
        forbid = min_dist_mask(self.H, self.W, pts1, ok, self.cfg.min_dist)
        cand, cand_vals, cand_ok = nms_topk(
            resp, self.M, self.cfg.min_dist, border=self.cfg.border + 2,
            forbid_mask=forbid,
        )
        un_cand = self.cam32.lift_projective(cand)
        # pack outputs: ship ONE float payload per frame (one device->host
        # transfer; bool lanes ride as 0/1 floats). All camera models return lift_projective with z=1, so
        # only the xy of the normalized coords travel.
        return imgf, jnp.concatenate(
            [pts1, un1[:, :2], cand, cand_vals[:, None], un_cand[:, :2],
             ok[:, None].astype(jnp.float32), cand_ok[:, None].astype(jnp.float32)],
            axis=1,
        )  # (M, 11)

    # ------------------------------------------------------------- pipeline
    def dispatch(self, img: np.ndarray, t: float):
        """Enqueue the fused device step for this frame WITHOUT blocking and
        return a pending token for `collect`. This is the frontend half of
        the System's dispatch-level pipeline (the reference's tracker thread,
        System.cpp:54): the device computes this frame's tracking while the
        host runs the previous frame's estimator update, hiding the full
        device round trip. Exactly one dispatch may be pending at a time (the
        next dispatch needs the host track state that collect installs).

        The image is shipped in its native dtype (uint8 stays uint8 — 4x
        fewer bytes than f32) and converted on device."""
        assert self._pending is None, "collect() the previous frame first"
        img = np.ascontiguousarray(img)
        if img.dtype == np.float64:
            # never ship f64 pixels: pixel math gains nothing from it, and
            # one input dtype keeps the step at one compiled program
            img = img.astype(np.float32)
        imgj = jnp.asarray(img)
        first = self.prev_img is None
        prev = imgj.astype(jnp.float32) if first else self.prev_img
        # fused-RANSAC side inputs (host-sampled hypothesis rows from the
        # PRE-LK track set; see _step_impl)
        S = self._n_ransac_hyp
        samples = np.zeros((S, 8), np.int32)
        age_ok = np.zeros(self.M, bool)
        if self.fused_ransac and not first:
            rows = np.where(self.valid & (self.track_cnt >= 1))[0]
            if len(rows) >= 15:
                rng = np.random.default_rng(self._ransac_seed)
                self._ransac_seed += 1
                samples = np.stack(
                    [rng.choice(rows, size=8, replace=False)
                     for _ in range(S)]
                ).astype(np.int32)
                age_ok[rows] = True
        imgf, packed = self._step(
            prev, imgj, jnp.asarray(self.pts, jnp.float32),
            jnp.asarray(self.valid),
            jnp.asarray(self.prev_un[:, :2], jnp.float32),
            jnp.asarray(age_ok), jnp.asarray(samples), first=first,
        )
        self.prev_img = imgf  # lazy device value; ready by next dispatch
        # start the device->host copy NOW (it enqueues behind the step's
        # compute): by the time collect() runs, the result is already on the
        # host
        if hasattr(packed, "copy_to_host_async"):
            packed.copy_to_host_async()
        self._pending = {"t": t, "first": first, "packed": packed}
        return self._pending

    def collect(self, pending=None):
        """Block on the pending fused step and run the host-side half:
        epipolar RANSAC, min-dist dedup, refill bookkeeping, velocities.
        Returns the feature packet dict (same contract as read_image)."""
        pending = pending or self._pending
        assert pending is not None and pending is self._pending
        self._pending = None
        t = pending["t"]
        first = pending["first"]
        # ONE bulk device->host transfer
        packed_f = np.array(pending["packed"], dtype=np.float64)
        pts1 = packed_f[:, 0:2]
        un1 = np.concatenate([packed_f[:, 2:4], np.ones((self.M, 1))], axis=1)
        cand = packed_f[:, 4:6]
        cand_vals = packed_f[:, 6]
        un_cand = np.concatenate([packed_f[:, 7:9], np.ones((self.M, 1))], axis=1)
        ok = packed_f[:, 9] > 0.5
        cand_ok = packed_f[:, 10] > 0.5

        if not first:
            self.pts = pts1.copy()
            self.valid = ok
            self.track_cnt = np.where(ok, self.track_cnt + 1, 0)
            if not self.fused_ransac:
                # epipolar outlier rejection (rejectWithF); CPU backend,
                # static M (the fused path already applied it on device)
                self._reject_with_f(un1)

        # min-distance dedup, longest tracks win (setMask)
        self._dedup_min_dist()

        # refill with new detections
        un = un1.astype(np.float64)
        n_cur = int(self.valid.sum())
        if n_cur < self.M:
            rows, sel = self._refill(cand, cand_vals, cand_ok, self.M - n_cur)
            un[rows] = un_cand[sel]

        # velocities on the normalized plane
        vel = np.zeros((self.M, 2))
        if self.prev_time is not None:
            dt = max(t - self.prev_time, 1e-6)
            had_prev = self.valid & (self.track_cnt > 1)
            vel[had_prev] = (un[had_prev, :2] - self.prev_un[had_prev, :2]) / dt
        self.prev_un = un.copy()
        self.prev_time = t

        sel = self.valid
        return {
            "ids": self.ids[sel].copy(),
            "pts_norm": un[sel].copy(),
            "pts_px": self.pts[sel].copy(),
            "vel": vel[sel].copy(),
            "track_cnt": self.track_cnt[sel].copy(),
        }

    def read_image(self, img: np.ndarray, t: float):
        """img: (H,W) uint8/float. Synchronous dispatch+collect (the
        non-pipelined path; tests and simple drivers)."""
        self.dispatch(img, t)
        return self.collect()

    # -------------------------------------------------------------- helpers
    def _reject_with_f(self, un_cur: np.ndarray):
        mask = self.valid & (self.track_cnt > 1)
        rows = np.where(mask)[0]
        if len(rows) < 15:
            return
        # pixel threshold -> normalized-plane units via the actual focal
        # (the reference's /460 virtual focal assumed the EuRoC camera)
        thresh = self.cfg.f_threshold / float(self.cam.focal)
        # fresh sample pattern each frame: a fixed seed correlates the
        # rejection across frames (same-sample failure modes recur)
        rng = np.random.default_rng(self._ransac_seed)
        self._ransac_seed += 1
        samples = np.stack(
            [rng.choice(rows, size=8, replace=False) for _ in range(128)]
        )
        # full-capacity arrays + mask: static shape = one CPU compile ever
        with host_cpu():
            _, _, inl, n_inl, _ = _ransac_core(
                jnp.asarray(self.prev_un[:, :2]), jnp.asarray(un_cur[:, :2]),
                jnp.asarray(mask), jnp.asarray(samples), thresh * thresh,
            )
        inl = np.asarray(inl)
        # degeneracy guard: a (near-)planar view makes the 8-point problem
        # rank-deficient and the "best" model arbitrary — if the winner
        # explains less than half the candidates, do not trust its verdict
        # (cv::findFundamentalMat in the reference degrades the same way;
        # keeping the tracks is strictly safer than a coin-flip cull)
        if int(n_inl) < 0.5 * len(rows):
            return
        self.valid[mask & ~inl] = False

    def _dedup_min_dist(self):
        """Greedy min-dist keep, longest track first (setMask). Vectorized:
        one pairwise distance matrix, then an O(n) suppression sweep."""
        rows = np.where(self.valid)[0]
        if len(rows) == 0:
            return
        order = rows[np.argsort(-self.track_cnt[rows])]
        P = self.pts[order]
        d2 = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
        r2 = self.cfg.min_dist**2
        n = len(order)
        keep = np.ones(n, bool)
        idx = np.arange(n)
        for i in range(n):
            if keep[i]:
                keep[(d2[i] < r2) & (idx > i)] = False
        self.valid[order[~keep]] = False

    def _refill(self, cand, vals, ok, n_new: int):
        """Assign detection candidates (from the fused step) to free slots.
        Returns (rows, sel) — the slot indices filled and the candidate
        indices used — so the caller can fetch their undistorted coords."""
        # GFTT-style quality floor relative to the strongest response
        # (feature_tracker_simple.cpp:140 uses cv::goodFeaturesToTrack with
        # qualityLevel 0.01); weak texture tracks drift and churn
        ok = np.asarray(ok) & (vals > 0.01 * max(float(vals[0]), 1e-9))
        free = np.where(~self.valid)[0]
        take = min(n_new, int(ok.sum()), len(free))
        sel = np.where(ok)[0][:take]
        rows = free[:take]
        self.pts[rows] = cand[sel]
        self.ids[rows] = np.arange(self.next_id, self.next_id + take)
        self.next_id += take
        self.track_cnt[rows] = 1
        self.valid[rows] = True
        return rows, sel
