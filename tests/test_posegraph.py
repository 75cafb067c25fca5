"""Pose graph + loop closure: descriptor matching kernels, dense graph
optimization with covariance, and the full builder loop-closure pipeline on a
rendered synthetic revisit."""

import numpy as np
import jax.numpy as jnp

import isvins_tpu  # noqa: F401
from isvins_tpu.config import euroc_config, PoseGraphConfig
from isvins_tpu.posegraph import (
    KeyframeDB,
    brief_descriptors,
    hamming_matrix,
    make_brief_pattern,
    match_descriptors,
    optimize_pose_graph,
)
from isvins_tpu.geom import (
    mat_to_quat,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    so3_exp_quat,
)

from test_frontend import _texture


def test_brief_matching():
    pattern = jnp.asarray(make_brief_pattern())
    img = jnp.asarray(_texture(160, 200, 4), jnp.float32)
    rng = np.random.default_rng(0)
    pts = rng.uniform([30, 30], [170, 130], size=(40, 2))
    d1 = brief_descriptors(img, jnp.asarray(pts), jnp.ones(40, bool), pattern)
    # identical points -> distance 0 and correct identity assignment
    best, dist = match_descriptors(d1, jnp.ones(40, bool), d1, jnp.ones(40, bool))
    assert np.array_equal(np.asarray(best), np.arange(40))
    np.testing.assert_array_equal(np.asarray(dist), 0)
    # small sub-pixel shift -> small distances
    d2 = brief_descriptors(img, jnp.asarray(pts + 0.4), jnp.ones(40, bool), pattern)
    _, dist2 = match_descriptors(d2, jnp.ones(40, bool), d1, jnp.ones(40, bool))
    assert np.median(np.asarray(dist2)) < 40
    # unrelated points -> large distances
    H = hamming_matrix(d1, d1)
    off = np.asarray(H)[~np.eye(40, dtype=bool)]
    assert np.median(off) > 80


def _circle_kfs(n, radius=5.0):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t = np.stack([radius * np.cos(th), radius * np.sin(th), np.zeros(n)], axis=1)
    q = np.stack(
        [np.cos((th + np.pi / 2) / 2), 0 * th, 0 * th, np.sin((th + np.pi / 2) / 2)],
        axis=1,
    )
    return t, q


def test_pose_graph_optimize_closes_loop():
    """Chain with simulated drift + one strong loop edge: optimization must
    pull the trajectory back toward ground truth and produce covariances."""
    n = 40
    t_gt, q_gt = _circle_kfs(n)
    db = KeyframeDB(64, 8, 8)

    # vio poses: GT + accumulated yaw drift
    drift_rate = 0.004
    t_vio = t_gt.copy()
    q_vio = q_gt.copy()
    for k in range(n):
        dyaw = drift_rate * k
        Rz = np.array(
            [[np.cos(dyaw), -np.sin(dyaw), 0], [np.sin(dyaw), np.cos(dyaw), 0], [0, 0, 1]]
        )
        t_vio[k] = Rz @ t_gt[k] + np.array([0.002, 0.001, 0.0]) * k
        q_vio[k] = np.asarray(
            quat_normalize(
                quat_mul(
                    jnp.asarray(mat_to_quat(jnp.asarray(Rz))), jnp.asarray(q_gt[k])
                )
            )
        )

    for k in range(n):
        db.add(ts=float(k), vio_t=t_vio[k], vio_q=q_vio[k], opt_t=t_vio[k], opt_q=q_vio[k])
    # sequential edges from GT relative poses (drift lives in the state, the
    # edges are "measurements" — the classic pose-graph setting)
    for k in range(n - 1):
        qi = jnp.asarray(q_gt[k])
        dt = np.asarray(quat_rotate(quat_conj(qi), jnp.asarray(t_gt[k + 1] - t_gt[k])))
        dq = np.asarray(quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_gt[k + 1]))))
        db.edge_dt[k] = dt
        db.edge_dq[k] = dq
        db.edge_sqrt[k] = np.eye(6) * 30.0
        db.edge_valid[k] = True
    # loop edge: last kf sees kf 0 with the GT relative pose
    k = n - 1
    qi = jnp.asarray(q_gt[0])
    rel_t = np.asarray(quat_rotate(quat_conj(qi), jnp.asarray(t_gt[k] - t_gt[0])))
    rel_q = np.asarray(quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_gt[k]))))
    db.loop_idx[k] = 0
    db.loop_dt[k] = rel_t
    db.loop_dq[k] = rel_q
    db.loop_weight[k] = 500.0

    err_before = np.linalg.norm(t_vio - t_gt, axis=1).max()
    r_d, t_d, cost = optimize_pose_graph(db, 0, n - 1, iters=10)
    # the first pose is gauge-fixed to its vio value which equals GT at k=0
    err_after = np.linalg.norm(db.opt_t[:n] - t_gt, axis=1).max()
    assert err_after < 0.25 * err_before, (err_before, err_after)
    # covariance: PSD, grows along the chain away from the fixed pose
    w0 = np.linalg.eigvalsh(db.cov[1])
    assert w0.min() > -1e-9
    assert np.trace(db.cov[n // 2]) > np.trace(db.cov[1])
    # drift maps vio to optimized frame
    mapped = r_d @ t_vio[n - 1] + t_d
    np.testing.assert_allclose(mapped, db.opt_t[n - 1], atol=1e-8)


def test_covariance_grows_then_shrinks_with_loop():
    """The surfaced per-keyframe covariance (utils/visualization dump) must
    behave like an uncertainty: grow with distance from the gauge pose along
    an open chain, and SHRINK at the far end once a loop closure ties it back
    to the gauge (the property the reference's live ellipse rendering
    visualizes, pose_graph_builder.cpp:272–301)."""
    from isvins_tpu.utils.visualization import covariance_tum

    n = 30
    t_gt, q_gt = _circle_kfs(n)

    def build_db(with_loop):
        db = KeyframeDB(32, 8, 8)
        for k in range(n):
            db.add(ts=float(k), vio_t=t_gt[k], vio_q=q_gt[k],
                   opt_t=t_gt[k], opt_q=q_gt[k])
        for k in range(n - 1):
            qi = jnp.asarray(q_gt[k])
            dt = np.asarray(quat_rotate(quat_conj(qi), jnp.asarray(t_gt[k + 1] - t_gt[k])))
            dq = np.asarray(quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_gt[k + 1]))))
            db.edge_dt[k] = dt
            db.edge_dq[k] = dq
            db.edge_sqrt[k] = np.eye(6) * 30.0
            db.edge_valid[k] = True
        if with_loop:
            k = n - 1
            qi = jnp.asarray(q_gt[0])
            db.loop_idx[k] = 0
            db.loop_dt[k] = np.asarray(
                quat_rotate(quat_conj(qi), jnp.asarray(t_gt[k] - t_gt[0])))
            db.loop_dq[k] = np.asarray(
                quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_gt[k]))))
            db.loop_weight[k] = 900.0
        optimize_pose_graph(db, 0, n - 1, iters=10)
        return db

    db_open = build_db(with_loop=False)
    tr_open = [np.trace(db_open.cov[k]) for k in range(n)]
    # monotone-ish growth away from the gauge on the open chain
    assert tr_open[n // 2] > tr_open[2] > 0
    assert tr_open[n - 1] > tr_open[n // 2]

    db_loop = build_db(with_loop=True)
    # the loop ties the far end to the gauge: uncertainty at the end drops
    assert np.trace(db_loop.cov[n - 1]) < 0.5 * tr_open[n - 1], (
        np.trace(db_loop.cov[n - 1]), tr_open[n - 1])

    # the text dump surfaces exactly these blocks
    ts = db_loop.ts[:n]
    dump = covariance_tum(ts, db_loop.opt_t[:n], db_loop.cov[:n])
    first = dump.splitlines()[0].split()
    assert len(first) == 4 + 36


def test_builder_sequential_edges_consistent():
    """Structural regression for the edge off-by-one: on an L-shaped path
    (where consecutive relative transforms DIFFER, unlike a circle), every
    installed sequential edge must map keyframe j exactly onto keyframe j+1
    after the retro-update (pose_graph_builder.cpp:192–204)."""
    from isvins_tpu.estimator.marginalization import PoseGraphPacket
    from isvins_tpu.posegraph import PoseGraphBuilder
    from isvins_tpu.geom import quat_to_mat

    cfg = euroc_config().replace(
        posegraph=PoseGraphConfig(enabled=False, max_keyframes=64)
    )
    builder = PoseGraphBuilder(cfg)

    # straight run along +x, 90-deg turn, straight run along +y; per-frame
    # yaw increments only inside the corner -> relative transforms vary
    n = 30
    t_w = np.zeros((n, 3))
    q_w = np.tile([1.0, 0, 0, 0], (n, 1))
    yaw = 0.0
    pos = np.zeros(3)
    for k in range(1, n):
        if 12 <= k < 18:
            yaw += np.pi / 2 / 6
        step = np.array([np.cos(yaw), np.sin(yaw), 0.0]) * (0.04 + 0.003 * k)
        pos = pos + step
        t_w[k] = pos
        q_w[k] = [np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)]

    for k in range(n - 1):
        qi = jnp.asarray(q_w[k])
        dt = np.asarray(quat_rotate(quat_conj(qi), jnp.asarray(t_w[k + 1] - t_w[k])))
        dq = np.asarray(quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_w[k + 1]))))
        pkt = PoseGraphPacket(
            rel_dt=jnp.asarray(dt), rel_dq=jnp.asarray(dq),
            cov_rel=jnp.eye(6) * 1e-4,
            has_rollpitch=jnp.asarray(False), rp_q=jnp.asarray([1.0, 0, 0, 0]),
            cov_abs=jnp.eye(2),
            anchor_t=jnp.asarray(t_w[k]), anchor_q=jnp.asarray(q_w[k]),
            ts=jnp.asarray(float(k)), distance=jnp.asarray(float(np.linalg.norm(dt))),
        )
        builder.push(pkt, None, image=None)

    db = builder.db
    assert db.n >= 4
    for j in range(db.n - 1):
        assert db.edge_valid[j]
        Rj = np.asarray(quat_to_mat(jnp.asarray(db.vio_q[j])))
        pred = db.vio_t[j] + Rj @ db.edge_dt[j]
        np.testing.assert_allclose(pred, db.vio_t[j + 1], atol=1e-9)
        q_pred = np.asarray(
            quat_normalize(quat_mul(jnp.asarray(db.vio_q[j]), jnp.asarray(db.edge_dq[j])))
        )
        dq_err = np.abs(np.dot(q_pred, db.vio_q[j + 1]))
        assert dq_err > 1 - 1e-9
    # the newest keyframe's own edge exists (chain toward the next keyframe)
    assert db.edge_valid[db.n - 1]


def test_builder_two_sequence_stitching():
    """Stream discontinuity semantics (pose_graph_builder.cpp:3–19,
    pose_graph.cpp:84–105): sequence 1 tours the full circle; after
    new_sequence(), sequence 2 restarts in its OWN vio frame (yaw+translation
    offset from the world) and revisits the start region. The first
    inter-sequence loop must compute (w_r_vio, w_t_vio) and stitch sequence 2
    onto sequence 1's world, leaving sequence 1 untouched."""
    from isvins_tpu.estimator.marginalization import PoseGraphPacket
    from isvins_tpu.estimator.estimator import KeyframePoints
    from isvins_tpu.posegraph import PoseGraphBuilder
    from isvins_tpu.geom import quat_to_mat

    cfg = euroc_config().replace(
        posegraph=PoseGraphConfig(
            skip_recent=8, min_loop_matches=12, max_keyframes=64, max_kp_per_kf=256,
        ),
        tic=(0.0, 0.0, 0.0),
        ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    )
    H, W = 240, 320
    f = 200.0
    from isvins_tpu.config import CameraConfig
    from isvins_tpu.frontend import PinholeRadtan

    cam = PinholeRadtan.from_config(
        CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    )

    rng = np.random.default_rng(2)
    M = 500
    th = rng.uniform(0, 2 * np.pi, M)
    rad = rng.uniform(7.0, 12.0, M)
    z = rng.uniform(-2.0, 2.5, M)
    landmarks = np.stack([rad * np.cos(th), rad * np.sin(th), z], axis=1)
    R_bc = np.asarray(cfg.ric_np)
    base = _texture(H, W, 11) * 0.06
    from scipy.ndimage import gaussian_filter
    stamps = []
    for m in range(M):
        s_rng = np.random.default_rng(1000 + m)
        s = gaussian_filter(s_rng.uniform(0, 1, size=(25, 25)), 0.8)
        stamps.append((s - s.mean()) * 300.0)

    def render_and_points(t_b, q_b, ts, T_world_from_vio=None):
        """Render from the GT (world) pose; export keyframe points in the
        sequence's own vio frame via p_vio = R_off @ p_w + t_off."""
        Rb = np.asarray(quat_to_mat(jnp.asarray(q_b)))
        Rc = Rb @ R_bc
        pc = (Rc.T @ (landmarks - t_b).T).T
        vis = pc[:, 2] > 1.0
        uv = pc[:, :2] / pc[:, 2:3]
        px = uv * f + np.array([W / 2, H / 2])
        inb = vis & (px[:, 0] > 14) & (px[:, 0] < W - 14) & (px[:, 1] > 14) & (px[:, 1] < H - 14)
        img = base.copy()
        for m in np.where(inb)[0]:
            cx, cy = int(round(px[m, 0])), int(round(px[m, 1]))
            img[cy - 12 : cy + 13, cx - 12 : cx + 13] += stamps[m]
        img = np.clip(img + 120.0, 0, 255)
        rows = np.where(inb)[0][:200]
        pts_w = landmarks[rows]
        if T_world_from_vio is not None:
            R_off, t_off = T_world_from_vio
            pts_w = (R_off.T @ (pts_w - t_off).T).T
        return img, KeyframePoints(ts=ts, points_w=pts_w, pts_norm=uv[rows], ids=rows)

    def push_leg(builder, t_vio, q_vio, ts0, offset=None):
        for k in range(len(t_vio) - 1):
            qi = jnp.asarray(q_vio[k])
            dt = np.asarray(quat_rotate(quat_conj(qi), jnp.asarray(t_vio[k + 1] - t_vio[k])))
            dq = np.asarray(quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_vio[k + 1]))))
            pkt = PoseGraphPacket(
                rel_dt=jnp.asarray(dt), rel_dq=jnp.asarray(dq),
                cov_rel=jnp.eye(6) * 1e-4,
                has_rollpitch=jnp.asarray(False), rp_q=jnp.asarray([1.0, 0, 0, 0]),
                cov_abs=jnp.eye(2),
                anchor_t=jnp.asarray(t_vio[k]), anchor_q=jnp.asarray(q_vio[k]),
                ts=jnp.asarray(ts0 + float(k)),
                distance=jnp.asarray(float(np.linalg.norm(dt))),
            )
            if offset is None:
                t_w, q_w = t_vio[k], q_vio[k]
            else:  # world pose = offset applied to the vio pose
                R_off, t_off = offset
                t_w = R_off @ t_vio[k] + t_off
                q_w = np.asarray(quat_normalize(quat_mul(
                    jnp.asarray(mat_to_quat(jnp.asarray(R_off))), jnp.asarray(q_vio[k]))))
            img, kfp = render_and_points(t_w, q_w, ts0 + float(k), T_world_from_vio=offset)
            builder.push(pkt, kfp, image=img)

    builder = PoseGraphBuilder(cfg, camera=cam)

    # sequence 1: drift-free full circle in the world frame
    n1 = 21
    ang1 = np.linspace(0, 2 * np.pi, n1)
    t1 = np.stack([5 * np.cos(ang1), 5 * np.sin(ang1), 0 * ang1], axis=1)
    q1 = np.stack([np.cos(ang1 / 2), 0 * ang1, 0 * ang1, np.sin(ang1 / 2)], axis=1)
    push_leg(builder, t1, q1, ts0=0.0)
    n_seq1 = builder.db.n
    assert n_seq1 >= n1 - 2
    seq1_vio_t = builder.db.vio_t[:n_seq1].copy()

    # stream gap -> new sequence, restarting in its own vio frame: the world
    # pose of sequence 2 is T_off ∘ vio pose
    builder.new_sequence()
    psi = 0.35
    R_off = np.array([[np.cos(psi), -np.sin(psi), 0],
                      [np.sin(psi), np.cos(psi), 0], [0, 0, 1]])
    t_off = np.array([1.4, -0.9, 0.3])

    n2 = 8
    ang2 = np.linspace(0.05 * np.pi, 0.55 * np.pi, n2)
    t2_w = np.stack([5 * np.cos(ang2), 5 * np.sin(ang2), 0 * ang2], axis=1)
    q2_w = np.stack([np.cos(ang2 / 2), 0 * ang2, 0 * ang2, np.sin(ang2 / 2)], axis=1)
    # vio frame of sequence 2: T_vio = T_off^{-1} ∘ T_world
    t2_v = (R_off.T @ (t2_w - t_off).T).T
    q_off_inv = jnp.asarray(mat_to_quat(jnp.asarray(R_off.T)))
    q2_v = np.stack([
        np.asarray(quat_normalize(quat_mul(q_off_inv, jnp.asarray(q)))) for q in q2_w
    ])
    push_leg(builder, t2_v, q2_v, ts0=100.0, offset=(R_off, t_off))

    db = builder.db
    assert builder.sequence == 2
    assert int(db.seq[n_seq1]) == 2 and int(db.seq[0]) == 1
    assert builder.n_loops >= 1, "no inter-sequence loop detected"
    assert builder.n_sequence_aligns == 1
    assert builder.sequence_loop[2] is True
    # sequence 1 vio poses untouched by the alignment
    np.testing.assert_allclose(db.vio_t[:n_seq1], seq1_vio_t, atol=1e-12)
    # sequence 2 vio poses stitched onto the world (drift-free -> near GT)
    n_total = db.n
    err = np.linalg.norm(db.vio_t[n_seq1:n_total] - t2_w[: n_total - n_seq1], axis=1)
    assert err.max() < 0.3, err


def test_builder_loop_closure_pipeline():
    """Rendered revisit: keyframes around a circle; the final keyframes
    revisit the start. The builder must detect the loop, verify it with PnP,
    and reduce trajectory error via optimization."""
    from isvins_tpu.estimator.marginalization import PoseGraphPacket
    from isvins_tpu.estimator.estimator import KeyframePoints
    from isvins_tpu.posegraph import PoseGraphBuilder

    cfg = euroc_config().replace(
        posegraph=PoseGraphConfig(
            skip_recent=8, min_loop_matches=12, max_keyframes=64, max_kp_per_kf=256,
        ),
        tic=(0.0, 0.0, 0.0),
        ric=((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    )
    H, W = 240, 320
    f = 200.0
    from isvins_tpu.config import CameraConfig
    from isvins_tpu.frontend import PinholeRadtan

    cam = PinholeRadtan.from_config(
        CameraConfig(width=W, height=H, fx=f, fy=f, cx=W / 2, cy=H / 2,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    )

    # world: landmarks on a ring; poses around a circle, revisiting the start
    rng = np.random.default_rng(2)
    M = 500
    th = rng.uniform(0, 2 * np.pi, M)
    rad = rng.uniform(7.0, 12.0, M)
    z = rng.uniform(-2.0, 2.5, M)
    landmarks = np.stack([rad * np.cos(th), rad * np.sin(th), z], axis=1)

    n_kf = 26
    ang = np.linspace(0, 2 * np.pi * 1.15, n_kf)  # > full circle: revisit
    t_gt = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0 * ang], axis=1)
    q_gt = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], axis=1)

    R_bc = np.asarray(cfg.ric_np)
    base = _texture(H, W, 11) * 0.06

    def body_cam(k):
        from isvins_tpu.geom import quat_to_mat
        Rb = np.asarray(quat_to_mat(jnp.asarray(q_gt[k])))
        Rc = Rb @ R_bc
        tc = t_gt[k]
        return Rc, tc

    # distinctive per-landmark appearance: a seeded random 13x13 stamp per
    # landmark (Gaussian blobs are isotropic and defeat any binary descriptor)
    from scipy.ndimage import gaussian_filter
    stamps = []
    for m in range(M):
        s_rng = np.random.default_rng(1000 + m)
        s = gaussian_filter(s_rng.uniform(0, 1, size=(25, 25)), 0.8)
        s = (s - s.mean()) * 300.0  # zero-mean so stamps blend additively
        stamps.append(s)

    def render_and_points(k):
        Rc, tc = body_cam(k)
        pc = (Rc.T @ (landmarks - tc).T).T
        vis = pc[:, 2] > 1.0
        uv = pc[:, :2] / pc[:, 2:3]
        px = uv * f + np.array([W / 2, H / 2])
        inb = vis & (px[:, 0] > 14) & (px[:, 0] < W - 14) & (px[:, 1] > 14) & (px[:, 1] < H - 14)
        img = base.copy()
        for m in np.where(inb)[0]:
            cx, cy = int(round(px[m, 0])), int(round(px[m, 1]))
            img[cy - 12 : cy + 13, cx - 12 : cx + 13] += stamps[m]
        img = np.clip(img + 120.0, 0, 255)
        rows = np.where(inb)[0][:200]
        kfp = KeyframePoints(
            ts=float(k), points_w=landmarks[rows], pts_norm=uv[rows], ids=rows
        )
        return img, kfp

    # drifted vio stream: small yaw+translation drift per keyframe
    builder = PoseGraphBuilder(cfg, camera=cam)
    t_vio = np.zeros_like(t_gt)
    q_vio = np.zeros_like(q_gt)
    drift_yaw = 0.003
    for k in range(n_kf):
        dy = drift_yaw * k
        Rz = np.array([[np.cos(dy), -np.sin(dy), 0], [np.sin(dy), np.cos(dy), 0], [0, 0, 1]])
        t_vio[k] = Rz @ t_gt[k] + np.array([0.004, -0.002, 0]) * k
        q_vio[k] = np.asarray(
            quat_normalize(quat_mul(jnp.asarray(mat_to_quat(jnp.asarray(Rz))), jnp.asarray(q_gt[k])))
        )

    for k in range(n_kf - 1):
        img, kfp = render_and_points(k)
        # packet semantics match MargForward: the edge spans k -> k+1 and the
        # anchor is the marginalized frame k (estimator.cpp:1276–1278)
        qi = jnp.asarray(q_vio[k])
        dt = np.asarray(quat_rotate(quat_conj(qi), jnp.asarray(t_vio[k + 1] - t_vio[k])))
        dq = np.asarray(quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_vio[k + 1]))))
        pkt = PoseGraphPacket(
            rel_dt=jnp.asarray(dt), rel_dq=jnp.asarray(dq),
            cov_rel=jnp.eye(6) * 1e-4,
            has_rollpitch=jnp.asarray(False), rp_q=jnp.asarray([1.0, 0, 0, 0]),
            cov_abs=jnp.eye(2),
            anchor_t=jnp.asarray(t_vio[k]), anchor_q=jnp.asarray(q_vio[k]),
            ts=jnp.asarray(float(k)), distance=jnp.asarray(float(np.linalg.norm(dt))),
        )
        # note: world points exported in the *vio* frame (drifted), as the
        # estimator would
        from isvins_tpu.geom import quat_to_mat
        Rz_k = np.asarray(quat_to_mat(jnp.asarray(q_vio[k]))) @ np.asarray(
            quat_to_mat(jnp.asarray(q_gt[k]))
        ).T
        pts_w_vio = (Rz_k @ (kfp.points_w - t_gt[k]).T).T + t_vio[k]
        kfp = KeyframePoints(ts=kfp.ts, points_w=pts_w_vio, pts_norm=kfp.pts_norm, ids=kfp.ids)
        builder.push(pkt, kfp, image=img)

    assert builder.db.n >= n_kf - 2
    assert builder.n_loops >= 1, "no loop detected on revisit"
    # optimized trajectory should beat the raw vio drift
    ts, t_opt, q_opt = builder.trajectory()
    err_vio = np.linalg.norm(t_vio[: len(t_opt)] - t_gt[: len(t_opt)], axis=1)[-3:].mean()
    err_opt = np.linalg.norm(t_opt - t_gt[: len(t_opt)], axis=1)[-3:].mean()
    assert err_opt < 0.7 * err_vio, (err_vio, err_opt)


def test_async_optimize_dispatch_and_finalize():
    """async_dispatch=True returns a PendingOptimize whose finalize applies
    the identical result as the synchronous call (the reference's decoupled
    optimizeCS thread semantics, pose_graph.cpp:425)."""
    from isvins_tpu.posegraph.optimize import PendingOptimize

    n = 40
    t_gt, q_gt = _circle_kfs(n)

    def build_db():
        db = KeyframeDB(64, 8, 8)
        drift_rate = 0.004
        for k in range(n):
            dyaw = drift_rate * k
            Rz = np.array([[np.cos(dyaw), -np.sin(dyaw), 0],
                           [np.sin(dyaw), np.cos(dyaw), 0], [0, 0, 1]])
            t_v = Rz @ t_gt[k] + np.array([0.002, 0.001, 0.0]) * k
            q_v = np.asarray(quat_normalize(quat_mul(
                jnp.asarray(mat_to_quat(jnp.asarray(Rz))), jnp.asarray(q_gt[k]))))
            db.add(ts=float(k), vio_t=t_v, vio_q=q_v, opt_t=t_v, opt_q=q_v)
        for k in range(n - 1):
            qi = jnp.asarray(q_gt[k])
            db.edge_dt[k] = np.asarray(
                quat_rotate(quat_conj(qi), jnp.asarray(t_gt[k + 1] - t_gt[k])))
            db.edge_dq[k] = np.asarray(
                quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_gt[k + 1]))))
            db.edge_sqrt[k] = np.eye(6) * 30.0
            db.edge_valid[k] = True
        k = n - 1
        qi = jnp.asarray(q_gt[0])
        db.loop_idx[k] = 0
        db.loop_dt[k] = np.asarray(
            quat_rotate(quat_conj(qi), jnp.asarray(t_gt[k] - t_gt[0])))
        db.loop_dq[k] = np.asarray(
            quat_normalize(quat_mul(quat_conj(qi), jnp.asarray(q_gt[k]))))
        db.loop_weight[k] = 500.0
        return db

    db_sync = build_db()
    r_s, t_s, c_s = optimize_pose_graph(db_sync, 0, n - 1, iters=10)

    db_async = build_db()
    pend = optimize_pose_graph(db_async, 0, n - 1, iters=10,
                               async_dispatch=True)
    assert isinstance(pend, PendingOptimize)
    # db writes must not have landed yet (opt poses still the vio seed)
    np.testing.assert_allclose(db_async.opt_t[:n], db_async.vio_t[:n])
    r_a, t_a, c_a = pend.finalize()
    np.testing.assert_allclose(db_async.opt_t[:n], db_sync.opt_t[:n], atol=1e-12)
    np.testing.assert_allclose(db_async.cov[:n], db_sync.cov[:n], atol=1e-12)
    np.testing.assert_allclose(r_a, r_s, atol=1e-12)
    np.testing.assert_allclose(t_a, t_s, atol=1e-12)
    np.testing.assert_allclose(c_a, c_s, rtol=1e-12)
    np.testing.assert_allclose(db_async.edge_dt[: n - 1],
                               db_sync.edge_dt[: n - 1], atol=1e-12)


def test_retrieval_scores_match_xor_popcount(rng):
    """The retrieval pre-filter's batched Hamming scoring equals a plain
    numpy XOR-popcount count of sub-threshold matches per keyframe."""
    from isvins_tpu.posegraph.keyframe_db import _retrieval_scores

    R, K, thresh = 16, 12, 100
    qd = rng.integers(0, 2**32, size=(R, 8), dtype=np.uint32)
    dbd = rng.integers(0, 2**32, size=(K, R, 8), dtype=np.uint32)
    dbd[3] = qd  # exact duplicate keyframe
    flip = np.uint32(1) << rng.integers(0, 32, size=(R // 2, 8)).astype(np.uint32)
    dbd[5, : R // 2] = qd[: R // 2] ^ flip  # half the descriptors, 8 bits off
    qv = np.ones(R, bool)
    qv[-2:] = False
    dbv = np.ones((K, R), bool)
    dbv[7] = False

    bits = np.unpackbits((qd[:, None, None, :] ^ dbd[None]).view(np.uint8), axis=-1)
    dist = bits.reshape(R, K, R, -1).sum(-1)  # (query, kf, db row)
    dist = np.where(dbv[None], dist, 512)
    want = ((dist.min(-1) < thresh) & qv[:, None]).sum(0) / qv.sum()

    got = np.asarray(_retrieval_scores(jnp.asarray(qd), jnp.asarray(qv),
                                       jnp.asarray(dbd), jnp.asarray(dbv), thresh))
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert got[3] == 1.0 and got[7] == 0.0 and 0.4 < got[5] < 0.7
