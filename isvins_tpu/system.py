"""System orchestrator: the single-process host pipeline that replaces the
reference's 7-thread queue topology (src/System.cpp; SURVEY.md §1).

Dataflow (synchronous, deterministic — the thread/queue concurrency of the
reference becomes a host driver streaming into jitted device super-steps):

  pub_imu  ──► imu queue ─┐
  pub_image ─► frequency control ─► FeatureTracker ─► feature queue
                                    │ (image ring buffer for keyframes)
  _process: align IMU ≤ t_img + td (mid-frame interpolation) ─► Estimator
            │ MARGIN_OLD → PoseGraphPacket + keyframe points + image
            └─► PoseGraphBuilder (loop closure, drift)

Outputs: VIO trajectory (pose_output.txt semantics, System.cpp:409–410) and
the optimized keyframe trajectory (loop_pose_output.txt).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from .config import EngineConfig
from .estimator.estimator import Estimator, MARGIN_OLD, NON_LINEAR
from .frontend import FeatureTracker, make_camera
from .posegraph import PoseGraphBuilder
from .solver import WindowDims
from .utils import perf


class System:
    def __init__(self, cfg: EngineConfig, dims: Optional[WindowDims] = None,
                 enable_loop: bool = True, pipeline: bool = False,
                 pg_thread: bool = False, solve_async: bool = False,
                 pg_kf_on_cpu: Optional[bool] = None):
        """pipeline=True enables dispatch-level pipelining: pub_image
        dispatches the tracker's fused device step asynchronously and runs
        the PREVIOUS frame's estimator update while it computes, hiding the
        tracker's device round trip (the reference overlaps the same two
        stages with its tracker/backend threads, System.cpp:224). Outputs are
        identical to the synchronous mode — packets are processed in the same
        order with the same values, one pub_image later; call flush() at end
        of stream.

        pg_thread=True runs the ENTIRE pose-graph builder (keyframe BRIEF,
        retrieval, PnP loop verification, optimization dispatch) on a worker
        thread consuming a packet queue — the reference's decoupled
        pose-graph thread (pose_graph_builder.cpp's process() thread +
        pose_graph.cpp:425 optimizeCS poll thread). The builder is a pure
        consumer of the VIO stream (drift is applied to its own keyframe db,
        never fed back into the estimator), so the frame path sheds all
        keyframe-time device work and compile stalls; packets are processed
        in order, outputs are identical modulo WHEN drift updates land
        (eventually-consistent, same as the reference's poll thread)."""
        self.cfg = cfg
        self.pipeline = pipeline
        self._pending_pub = None  # (t, pub_this) of the in-flight tracker frame
        self.tracker = FeatureTracker(cfg.camera, cfg.tracker)
        self.estimator = Estimator(cfg, dims, solve_async=solve_async)
        if pg_kf_on_cpu is None:
            # default: the worker's keyframe program leaves the accelerator
            # only at SMALL resolutions — there the CPU program is a few ms
            # and stays out of the frame path's device queue; at full
            # resolution the CPU Shi-Tomasi/BRIEF would starve the host
            # instead. Unmeasured on the H100 (ROADMAP Queue 3 debt 2).
            pg_kf_on_cpu = pg_thread and (cfg.camera.width * cfg.camera.height
                                          <= 400 * 300)
        self.pgbuilder = (
            PoseGraphBuilder(cfg, camera=make_camera(cfg.camera),
                             kf_step_on_cpu=pg_kf_on_cpu)
            if (enable_loop and cfg.posegraph.enabled)
            else None
        )
        self._pg_queue: Optional[queue.Queue] = None
        self._pg_worker_thread: Optional[threading.Thread] = None
        self._pg_exc: Optional[BaseException] = None
        if self.pgbuilder is not None and pg_thread:
            # bounded queue: backpressure if the worker ever falls behind the
            # keyframe rate (the reference's buf_mutex'd keyframe queue is
            # unbounded; bounding keeps worst-case memory and staleness small)
            self._pg_queue = queue.Queue(maxsize=64)
            self._pg_worker_thread = threading.Thread(
                target=self._pg_worker, daemon=True, name="posegraph")
            self._pg_worker_thread.start()
            # compile the worker's programs while the stream ramps (ordered
            # ahead of any keyframe; a cold compile landing mid-stream was
            # the 2-4.8 s frame-time spike at the first loop closure)
            self._pg_queue.put(("prewarm",))

        self.imu_buf: deque = deque()
        self.feature_buf: deque = deque()
        self.image_ring: deque = deque(maxlen=256)  # (t, uint8 image)

        self.first_image_time = None
        self.last_image_time = None
        self.pub_count = 0
        self.init_feature = True  # skip the first packet (no velocities yet)
        self.current_time = -1.0

        self.vio_trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._pg_cursor = 0

    # ------------------------------------------------------------------- inputs
    def pub_imu(self, t: float, acc, gyr):
        self.imu_buf.append((t, np.asarray(acc), np.asarray(gyr)))
        self._process()

    def pub_image(self, t: float, img: np.ndarray):
        """Frequency control + tracking (System.cpp:54–142)."""
        if self.first_image_time is None:
            self.first_image_time = t
            self.last_image_time = t
        # stream discontinuity (System.cpp:72–79): reset the LK tracker so a
        # stale previous frame never seeds optical flow across the gap, and
        # start a new pose-graph sequence (pose_graph_builder.cpp GrabImg →
        # new_sequence); inter-sequence loop closure stitches them later
        if t - self.last_image_time > 1.0 or t < self.last_image_time:
            # finish any in-flight frame from before the gap, then process
            # what it produced (semantics: the discontinuity resets state
            # AFTER the last pre-gap frame is fully consumed)
            self._collect_pending()
            self._process()
            self.first_image_time = t
            self.pub_count = 0
            self.init_feature = True
            self.tracker.reset()
            self.feature_buf.clear()
            if self.pgbuilder is not None:
                if self._pg_queue is not None:
                    # ordered with the packets already queued: the worker
                    # owns all builder state, so the sequence break rides
                    # the same queue instead of racing a mid-push builder
                    self._pg_queue.put(("new_seq",))
                else:
                    self.pgbuilder.new_sequence()
        self.last_image_time = t

        # frequency control (System.cpp:82–95)
        freq = self.cfg.tracker.freq
        pub_this = False
        if freq <= 0 or round(self.pub_count / max(t - self.first_image_time, 1e-9)) <= freq:
            pub_this = True
            if abs(self.pub_count / max(t - self.first_image_time, 1e-9) - freq) < 0.01 * freq:
                self.first_image_time = t
                self.pub_count = 0

        if pub_this:
            self.pub_count += 1
        self.image_ring.append((t, np.asarray(img, dtype=np.uint8)))
        if self.pipeline:
            # 1) finish the previous frame's tracking (its device step has
            #    long since completed), queueing its feature packet;
            # 2) dispatch THIS frame's tracker step (non-blocking);
            # 3) run the estimator on the queued packet while it computes.
            self._collect_pending(dispatch_next=(t, pub_this, img))
            self._process()
        else:
            out = self.tracker.read_image(img, t)
            self._queue_packet(t, pub_this, out)
            self._process()

    def _collect_pending(self, dispatch_next=None):
        """Collect the in-flight tracker frame (if any) into the feature
        queue, then optionally dispatch the next frame."""
        if self._pending_pub is not None:
            t0, pub0 = self._pending_pub
            self._pending_pub = None
            with perf.phase("trk.collect"):
                out = self.tracker.collect()
            self._queue_packet(t0, pub0, out)
        if dispatch_next is not None:
            t, pub_this, img = dispatch_next
            with perf.phase("trk.dispatch"):
                self.tracker.dispatch(img, t)
            self._pending_pub = (t, pub_this)

    def _queue_packet(self, t: float, pub_this: bool, out: dict):
        if not pub_this:
            return
        if self.init_feature:
            # first packet has no velocities; the reference skips it
            self.init_feature = False
            return
        sel = out["track_cnt"] > 1
        if sel.sum() == 0:
            return
        self.feature_buf.append(
            {
                "t": t,
                "ids": out["ids"][sel],
                "pts": out["pts_norm"][sel],
                "vel": out["vel"][sel],
            }
        )

    def flush(self):
        """End-of-stream: finish the in-flight tracker frame, drain the
        queues, and collect any in-flight pose-graph optimization (pipeline
        mode's analogue of joining the reference's threads)."""
        self._collect_pending()
        self._process()
        # the last frame's solve and/or marginalization may still be in
        # their async slots: collect both so the trajectory is complete and
        # the final pose-graph packet reaches the builder
        self.estimator.collect_solve()
        self.estimator.collect_marg()
        self._drain_outputs()
        self._pg_join()
        if self.pgbuilder is not None:
            self.pgbuilder.flush_optimize()

    # ----------------------------------------------------- pose-graph thread
    def _pg_worker(self):
        """Worker loop: consume (push/new_seq) commands in order. Any
        exception is parked and re-raised on the main thread at the next
        join — the VIO stream itself never depends on the pose graph."""
        while True:
            item = self._pg_queue.get()
            try:
                if item is None:
                    return
                if self._pg_exc is None:
                    if item[0] == "new_seq":
                        self.pgbuilder.new_sequence()
                    elif item[0] == "prewarm":
                        self.pgbuilder.prewarm()
                    else:
                        _, pkt, kfp, img = item
                        self.pgbuilder.push(pkt, kfp, image=img)
            except BaseException as e:  # noqa: BLE001 - parked for the main thread
                self._pg_exc = e
            finally:
                self._pg_queue.task_done()

    def wait_pg_ready(self):
        """Block until the pose-graph worker has drained its queue — in
        particular the startup prewarm compiles. Call before a timed or
        rate-critical stream so cold-cache compiles never race it."""
        self._pg_join()

    def _pg_join(self):
        """Drain the pose-graph queue (no-op without pg_thread). All output
        accessors call this so reads always see a fully-consumed stream."""
        if self._pg_queue is not None:
            self._pg_queue.join()
            if self._pg_exc is not None:
                exc, self._pg_exc = self._pg_exc, None
                raise RuntimeError("pose-graph worker failed") from exc

    # -------------------------------------------------------------- processing
    def _measurements_ready(self) -> bool:
        if not self.feature_buf or not self.imu_buf:
            return False
        td = self.cfg.solver.td
        return self.imu_buf[-1][0] > self.feature_buf[0]["t"] + td

    def _process(self):
        """getMeasurements + ProcessBackEnd (System.cpp:160–202, 224–415)."""
        while self._measurements_ready():
            feat = self.feature_buf.popleft()
            t_img = feat["t"] + self.cfg.solver.td
            est = self.estimator

            # install the previous frame's pipelined solve BEFORE the IMU
            # feed: process_imu propagates the newest state as the incoming
            # frame's initial guess, and the slide must have freed the
            # newest IMU segment slot (solve_async mode; no-op otherwise)
            est.collect_solve()
            self._drain_outputs()

            # feed IMU up to t_img with boundary interpolation (:279–296)
            if self.current_time < 0:
                self.current_time = t_img
            with perf.phase("sys.imu_feed"):
                self._feed_imu(t_img)

            with perf.phase("est.process_image"):
                info = est.process_image(
                    feat["ids"], feat["pts"], feat["t"], vels=feat["vel"])
            self._drain_outputs()

    def _drain_outputs(self):
        """Move finished poses from the estimator to the trajectory and feed
        the pose graph (covers both the synchronous and pipelined solve
        paths — poses appear in ready_poses when their state is installed)."""
        est = self.estimator
        if est.ready_poses:
            self.vio_trajectory.extend(est.ready_poses)
            est.ready_poses.clear()
        if est.solver_flag == NON_LINEAR:
            with perf.phase("sys.feed_pose_graph"):
                self._feed_pose_graph()

    def _feed_imu(self, t_img: float):
        est = self.estimator
        while self.imu_buf and self.imu_buf[0][0] < t_img:
            t, acc, gyr = self.imu_buf.popleft()
            dt = t - self.current_time
            if dt > 0:
                est.process_imu(dt, acc, gyr)
            self.current_time = t
            self._last_imu = (acc, gyr)
        if self.imu_buf:
            t2, acc2, gyr2 = self.imu_buf[0]
            dt1 = t_img - self.current_time
            dt2 = t2 - t_img
            if dt1 > 0 and dt2 >= 0 and hasattr(self, "_last_imu"):
                w1 = dt2 / max(dt1 + dt2, 1e-9)
                w2 = dt1 / max(dt1 + dt2, 1e-9)
                acc1, gyr1 = self._last_imu
                acc_i = w1 * acc1 + w2 * acc2
                gyr_i = w1 * gyr1 + w2 * gyr2
                est.process_imu(dt1, acc_i, gyr_i)
                self.current_time = t_img

    def _feed_pose_graph(self):
        if self.pgbuilder is None:
            return
        est = self.estimator
        while self._pg_cursor < len(est.pose_graph_packets):
            pkt = est.pose_graph_packets[self._pg_cursor]
            kfp = (
                est.keyframe_points[self._pg_cursor]
                if self._pg_cursor < len(est.keyframe_points)
                else None
            )
            img = self._lookup_image(float(pkt.ts))
            if self._pg_queue is not None:
                self._pg_queue.put(("push", pkt, kfp, img))
            else:
                self.pgbuilder.push(pkt, kfp, image=img)
            self._pg_cursor += 1

    def _lookup_image(self, t: float):
        """Nearest ring image by timestamp (bisect on the time-ordered ring
        instead of a linear scan — the ring holds 256 frames and this runs
        per keyframe)."""
        if not self.image_ring:
            return None
        import bisect

        ts = [ti for (ti, _) in self.image_ring]
        i = bisect.bisect_left(ts, t)
        cands = [j for j in (i - 1, i) if 0 <= j < len(ts)]
        j = min(cands, key=lambda k: abs(ts[k] - t))
        if abs(ts[j] - t) < 0.05:
            return self.image_ring[j][1].astype(np.float32)
        return None

    # ---------------------------------------------------------------- outputs
    def vio_tum(self) -> str:
        """TUM format: t x y z qx qy qz qw (System.cpp:409–410)."""
        lines = []
        for (t, P, Q) in self.vio_trajectory:
            lines.append(
                f"{t:.9f} {P[0]} {P[1]} {P[2]} {Q[1]} {Q[2]} {Q[3]} {Q[0]}"
            )
        return "\n".join(lines)

    def loop_tum(self) -> str:
        if self.pgbuilder is None:
            return ""
        self._pg_join()
        ts, t_opt, q_opt = self.pgbuilder.trajectory()
        lines = []
        for i in range(len(ts)):
            P, Q = t_opt[i], q_opt[i]
            lines.append(
                f"{ts[i]:.9f} {P[0]} {P[1]} {P[2]} {Q[1]} {Q[2]} {Q[3]} {Q[0]}"
            )
        return "\n".join(lines)

    def covariance_tum(self) -> str:
        """Per-keyframe 6x6 covariance dump (the reference's live Pangolin
        ellipses, pose_graph_builder.cpp:272–301, as a text artifact)."""
        if self.pgbuilder is None:
            return ""
        self._pg_join()
        from .utils.visualization import covariance_tum

        ts, t_opt, cov = self.pgbuilder.covariances()
        return covariance_tum(ts, t_opt, cov)
