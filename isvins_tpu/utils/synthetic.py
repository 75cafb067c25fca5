"""Synthetic visual-inertial world generator (numpy, host-side).

Provides ground-truth trajectories with analytically consistent IMU
measurements and landmark observations — the test bed for the window solver,
marginalization, initialization, and the full estimator (SURVEY.md §4:
"solver tests on synthetic BA problems with known optima").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp


# Batched numpy quaternion helpers (wxyz, leading batch dims): the world
# generator runs per-IMU-sample on the host; eager jnp here would be one
# device round trip per sample (~1500 of them for a 40-frame world).
def _q_mul(q, p):
    w0, x0, y0, z0 = np.moveaxis(np.asarray(q), -1, 0)
    w1, x1, y1, z1 = np.moveaxis(np.asarray(p), -1, 0)
    return np.stack([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ], axis=-1)


def _q_conj(q):
    return np.asarray(q) * np.array([1.0, -1.0, -1.0, -1.0])


def _q_to_mat(q):
    w, x, y, z = np.moveaxis(np.asarray(q), -1, 0)
    row = lambda a, b, c: np.stack([a, b, c], axis=-1)
    return np.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], axis=-2)


def _q_rotate(q, v):
    return np.einsum("...ij,...j->...i", _q_to_mat(q), np.asarray(v))


@dataclass
class SynthWorld:
    frame_times: np.ndarray  # (B,)
    P: np.ndarray  # (B,3) GT positions (body/IMU in world)
    Q: np.ndarray  # (B,4) GT quaternions wxyz
    V: np.ndarray  # (B,3)
    landmarks: np.ndarray  # (M,3)
    # per-frame-segment IMU buffers, zero-padded to capacity
    imu_dts: np.ndarray  # (B-1, C)
    imu_accs: np.ndarray  # (B-1, C, 3)
    imu_gyrs: np.ndarray  # (B-1, C, 3)
    imu_acc0: np.ndarray  # (B-1, 3) sample at segment start
    imu_gyr0: np.ndarray  # (B-1, 3)
    gravity: np.ndarray  # (3,)
    ba: np.ndarray  # (3,) true accel bias
    bg: np.ndarray  # (3,)


def _traj(t, r=5.0, w=0.4, h=0.6, w2=0.9):
    """Circle with vertical oscillation."""
    p = np.stack([r * np.cos(w * t), r * np.sin(w * t), h * np.sin(w2 * t)], axis=-1)
    return p


def _traj_quat(t, w=0.4, wobble=(0.12, 0.1)):
    """Body x points radially outward (at the landmark ring); small pitch/roll
    wobble for IMU excitation. Larger `wobble` amplitudes give the 3-axis
    rotational excitation hand-eye extrinsic calibration needs."""
    yaw = w * t
    pitch = wobble[0] * np.sin(0.7 * t)
    roll = wobble[1] * np.cos(1.1 * t)
    # R = Rz(yaw) Ry(pitch) Rx(roll)
    qz = np.stack([np.cos(yaw / 2), 0 * t, 0 * t, np.sin(yaw / 2)], axis=-1)
    qy = np.stack([np.cos(pitch / 2), 0 * t, np.sin(pitch / 2), 0 * t], axis=-1)
    qx = np.stack([np.cos(roll / 2), np.sin(roll / 2), 0 * t, 0 * t], axis=-1)
    return _q_mul(qz, _q_mul(qy, qx))


def make_world(
    n_frames: int = 18,
    frame_hz: float = 10.0,
    imu_hz: float = 200.0,
    imu_capacity: int = 64,
    n_landmarks: int = 300,
    g_norm: float = 9.81007,
    ba=(0.0, 0.0, 0.0),
    bg=(0.0, 0.0, 0.0),
    noise_acc: float = 0.0,
    noise_gyr: float = 0.0,
    t0: float = 0.0,
    seed: int = 0,
    traj_r: float = 5.0,
    traj_w: float = 0.4,
    wobble=(0.12, 0.1),
    lm_rad=(6.5, 12.0),
    lm_z=(-2.0, 3.0),
) -> SynthWorld:
    rng = np.random.default_rng(seed)
    G = np.array([0.0, 0.0, g_norm])
    fdt = 1.0 / frame_hz
    idt = 1.0 / imu_hz
    frame_times = t0 + np.arange(n_frames) * fdt
    eps = 1e-6

    def pos(t):
        return _traj(np.atleast_1d(t), r=traj_r, w=traj_w)

    def quat(t):
        return _traj_quat(np.atleast_1d(t), w=traj_w, wobble=wobble)

    def vel(t):
        return (pos(t + eps) - pos(t - eps)) / (2 * eps)

    def acc_w(t):
        return (pos(t + eps) - 2 * pos(t) + pos(t - eps)) / (eps * eps)

    def omega_body(t):
        q0 = quat(t - eps)
        q1 = quat(t + eps)
        dq = _q_mul(_q_conj(q0), q1)
        # log(dq)/2eps
        v = dq[..., 1:]
        w = np.clip(dq[..., :1], -1, 1)
        ang = 2 * np.arctan2(np.linalg.norm(v, axis=-1, keepdims=True), w)
        axis = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        return axis * ang / (2 * eps)

    P = pos(frame_times)
    Q = quat(frame_times)
    V = vel(frame_times)

    ba = np.asarray(ba)
    bg = np.asarray(bg)

    C = imu_capacity
    B = n_frames
    imu_dts = np.zeros((B - 1, C))
    imu_accs = np.zeros((B - 1, C, 3))
    imu_gyrs = np.zeros((B - 1, C, 3))
    imu_acc0 = np.zeros((B - 1, 3))
    imu_gyr0 = np.zeros((B - 1, 3))

    def imu_at(t):
        R = _q_to_mat(quat(t))[0]
        a = R.T @ (acc_w(t)[0] + G) + ba + rng.normal(size=3) * noise_acc
        g = omega_body(t)[0] + bg + rng.normal(size=3) * noise_gyr
        return a, g

    for k in range(B - 1):
        ts = np.arange(frame_times[k], frame_times[k + 1] + idt * 0.5, idt)
        ts[-1] = frame_times[k + 1]
        a0, g0 = imu_at(ts[0])
        imu_acc0[k] = a0
        imu_gyr0[k] = g0
        n = len(ts) - 1
        assert n <= C
        for i in range(n):
            imu_dts[k, i] = ts[i + 1] - ts[i]
            a, g = imu_at(ts[i + 1])
            imu_accs[k, i] = a
            imu_gyrs[k, i] = g

    # landmarks: ring around the trajectory at varied radius/height
    th = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(lm_rad[0], lm_rad[1], n_landmarks)
    z = rng.uniform(lm_z[0], lm_z[1], n_landmarks)
    landmarks = np.stack([rad * np.cos(th), rad * np.sin(th), z], axis=-1)

    return SynthWorld(
        frame_times=frame_times, P=P, Q=Q, V=V, landmarks=landmarks,
        imu_dts=imu_dts, imu_accs=imu_accs, imu_gyrs=imu_gyrs,
        imu_acc0=imu_acc0, imu_gyr0=imu_gyr0, gravity=G, ba=ba, bg=bg,
    )


class StampRenderer:
    """Renders frames of a SynthWorld as images: each landmark gets a
    distinctive seeded random stamp (so binary descriptors can identify it),
    over a faint static background texture. Used by the full-pipeline tests
    and image benches."""

    def __init__(self, world: SynthWorld, cam_cfg, tic, qic, stamp: int = 25,
                 seed: int = 99):
        self.world = world
        self.cam = cam_cfg
        self.tic = np.asarray(tic)
        self.qic = np.asarray(qic)
        self.K = np.array(
            [[cam_cfg.fx, 0, cam_cfg.cx], [0, cam_cfg.fy, cam_cfg.cy], [0, 0, 1]]
        )
        H, W = cam_cfg.height, cam_cfg.width
        # flat background: a static image-space texture would violate the
        # epipolar geometry the tracker's RANSAC enforces (it does not move
        # with the camera); per-frame sensor noise is added in render()
        self.base = np.full((H, W), 100.0)
        self.noise_sigma = 1.5
        from scipy.ndimage import gaussian_filter

        self.half = stamp // 2
        self.stamps = []
        for m in range(len(world.landmarks)):
            s_rng = np.random.default_rng(7000 + m)
            # multi-scale structure: LK's convergence basin equals the feature
            # correlation length, so the stamp needs content at blob scale
            # (sigma ~ stamp/3, survives two pyramid levels), mid scale, and
            # fine detail (for BRIEF identity)
            yy, xx = np.mgrid[0:stamp, 0:stamp].astype(np.float64)
            c = (stamp - 1) / 2.0
            blob = np.exp(-((xx - c) ** 2 + (yy - c) ** 2) / (2 * (stamp / 3.5) ** 2))
            mid = gaussian_filter(s_rng.uniform(0, 1, size=(stamp, stamp)), 3.0)
            fine = gaussian_filter(s_rng.uniform(0, 1, size=(stamp, stamp)), 0.8)
            s = (
                6.0 * s_rng.choice([-1.0, 1.0]) * blob
                + 3.0 * (mid - mid.mean())
                + 1.0 * (fine - fine.mean())
            )
            self.stamps.append(s / np.abs(s).max() * 120.0)

    def render(self, frame: int):
        H, W = self.cam.height, self.cam.width
        pts, depth, vis = project(self.world, frame, self.tic, self.qic)
        px = (self.K @ pts.T).T[:, :2]
        h = self.half + 2
        inb = (
            vis
            & (px[:, 0] > h)
            & (px[:, 0] < W - h)
            & (px[:, 1] > h)
            & (px[:, 1] < H - h)
        )
        img = self.base.copy()
        rng = np.random.default_rng(123456 + frame)
        img += rng.normal(scale=self.noise_sigma, size=img.shape)
        hh = self.half
        for m in np.where(inb)[0]:
            cx, cy = int(round(px[m, 0])), int(round(px[m, 1]))
            img[cy - hh : cy + hh + 1, cx - hh : cx + hh + 1] += self.stamps[m]
        return np.clip(img, 0, 255), px, inb


class PatchRenderer:
    """Perspective-correct renderer: each landmark is a textured planar patch
    in 3D, rendered by inverse homography warping, composited far-to-near
    (painter's algorithm), over a direction-sampled background at infinity.

    Unlike StampRenderer (flat stamps pasted at integer pixel positions, ~1 px
    tracking bias), every image gradient here moves exactly with the camera:
    patch appearance is the true perspective projection of a world plane and
    the background has zero parallax, so LK tracking and BRIEF matching see
    the geometry the estimator assumes. Same render() API as StampRenderer."""

    def __init__(self, world: SynthWorld, cam_cfg, tic, qic, seed: int = 99,
                 px_half: float = 13.0, noise_sigma: float = 1.5,
                 tex_res: int = 56):
        self.world = world
        self.cam = cam_cfg
        self.tic = np.asarray(tic)
        self.qic = np.asarray(qic)
        self.K = np.array(
            [[cam_cfg.fx, 0, cam_cfg.cx], [0, cam_cfg.fy, cam_cfg.cy], [0, 0, 1]]
        )
        self.Kinv = np.linalg.inv(self.K)
        self.noise_sigma = noise_sigma
        self.tex_res = tex_res
        from scipy.ndimage import gaussian_filter

        lms = world.landmarks
        M = len(lms)
        rng = np.random.default_rng(seed)

        # plane frames: normal points from the landmark toward the world
        # origin (the trajectory circles the origin, so patches face the
        # camera), with a small random tilt
        n = -lms / np.linalg.norm(lms, axis=1, keepdims=True)
        n = n + rng.normal(scale=0.12, size=(M, 3))
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        up = np.tile(np.array([0.0, 0.0, 1.0]), (M, 1))
        u = np.cross(up, n)
        u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-9)
        v = np.cross(n, u)
        self.normal, self.u, self.v = n, u, v

        # physical half-size: projects to ~px_half pixels at each landmark's
        # typical viewing distance from the trajectory ring
        ring_r = np.linalg.norm(world.P[:, :2], axis=1).mean()
        d_typ = np.maximum(np.linalg.norm(lms[:, :2], axis=1) - ring_r, 0.8)
        self.half_m = px_half * d_typ / cam_cfg.fx

        # textures: multi-scale (blob for the LK pyramid's coarse levels,
        # mid structure, fine detail for BRIEF identity), zero at the rim
        # via a cosine window so the composite edge is smooth
        T = tex_res
        yy, xx = np.mgrid[0:T, 0:T].astype(np.float64)
        c = (T - 1) / 2.0
        r_n = np.sqrt((xx - c) ** 2 + (yy - c) ** 2) / c
        window = 0.5 * (1 + np.cos(np.pi * np.clip(r_n, 0, 1)))
        self.textures = np.zeros((M, T, T))
        self.alphas = np.zeros((M, T, T))
        for m in range(M):
            s_rng = np.random.default_rng(7000 + m)
            blob = np.exp(-((xx - c) ** 2 + (yy - c) ** 2) / (2 * (T / 3.5) ** 2))
            mid = gaussian_filter(s_rng.uniform(0, 1, size=(T, T)), T / 9.0)
            fine = gaussian_filter(s_rng.uniform(0, 1, size=(T, T)), 2.0)
            s = (
                6.0 * s_rng.choice([-1.0, 1.0]) * blob
                + 4.0 * (mid - mid.mean())
                + 1.2 * (fine - fine.mean())
            )
            self.textures[m] = s / np.abs(s).max() * 120.0 * window
            self.alphas[m] = window

        # background-at-infinity: smooth random function of view direction
        bg_rng = np.random.default_rng(seed + 1)
        self._bg_freq = bg_rng.normal(scale=2.0, size=(12, 3))
        self._bg_phase = bg_rng.uniform(0, 2 * np.pi, 12)
        self._bg_amp = bg_rng.uniform(0.5, 1.0, 12) * (4.0 / 12)

    def _background(self, R_wc):
        """Sample the infinite-distance background along each pixel ray."""
        H, W = self.cam.height, self.cam.width
        xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        rays = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ self.Kinv.T
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        d_w = rays @ R_wc.T  # (H,W,3) world directions
        val = np.full((H, W), 100.0)
        for f, ph, a in zip(self._bg_freq, self._bg_phase, self._bg_amp):
            val += a * np.sin(d_w @ f + ph)
        return val

    def render(self, frame: int):
        """Returns (img (H,W) float, px (M,2) GT pixel centers, inb (M,))."""
        H, W = self.cam.height, self.cam.width
        world = self.world
        Pb, Qb = world.P[frame], world.Q[frame]
        R_wb = _q_to_mat(Qb)
        R_bc = _q_to_mat(self.qic)
        R_wc = R_wb @ R_bc                       # cam -> world
        C_w = Pb + R_wb @ self.tic               # camera center in world
        R_cw = R_wc.T
        t_cw = -R_cw @ C_w

        lms = world.landmarks
        p_c = (R_cw @ lms.T).T + t_cw
        depth = p_c[:, 2]
        vis = depth > 0.5
        d_safe = np.where(np.abs(depth) > 1e-6, depth, 1.0)
        uv = p_c[:, :2] / d_safe[:, None]
        px = uv @ self.K[:2, :2].T + self.K[:2, 2]
        vis &= (np.abs(uv[:, 0]) < 0.9) & (np.abs(uv[:, 1]) < 0.65)
        # only front-facing patches render coherent texture
        view = lms - C_w
        cosang = -np.einsum("md,md->m", view, self.normal) / np.maximum(
            np.linalg.norm(view, axis=1), 1e-9
        )
        vis &= cosang > 0.25

        img = self._background(R_wc)
        rng = np.random.default_rng(123456 + frame)
        T = self.tex_res

        order = np.argsort(-depth[np.where(vis)[0]])
        vis_rows = np.where(vis)[0][order]  # far to near
        inb = np.zeros(len(lms), bool)
        for m in vis_rows:
            s = self.half_m[m]
            # homography patch(a,b,1) -> image, columns [R u, R v, R X + t]
            Hm = self.K @ np.column_stack(
                [R_cw @ self.u[m] * s, R_cw @ self.v[m] * s,
                 R_cw @ lms[m] + t_cw]
            )
            # bbox from the projected patch corners
            corners = np.array(
                [[-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1]], float
            ) @ Hm.T
            if np.any(corners[:, 2] < 0.1):
                continue
            cpx = corners[:, :2] / corners[:, 2:3]
            x0 = max(int(np.floor(cpx[:, 0].min())), 0)
            x1 = min(int(np.ceil(cpx[:, 0].max())) + 1, W)
            y0 = max(int(np.floor(cpx[:, 1].min())), 0)
            y1 = min(int(np.ceil(cpx[:, 1].max())) + 1, H)
            if x1 - x0 <= 1 or y1 - y0 <= 1 or (x1 - x0) * (y1 - y0) > 120 * 120:
                continue
            Hinv = np.linalg.inv(Hm)
            # 2x2 supersampling: anti-aliases the minified texture so patch
            # appearance is stable to sub-pixel camera motion
            sub_off = np.array([[-0.25, -0.25], [0.25, -0.25],
                                [-0.25, 0.25], [0.25, 0.25]])
            xs, ys = np.meshgrid(
                np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5
            )
            tex = self.textures[m]
            alp = self.alphas[m]
            tval = np.zeros_like(xs)
            aval = np.zeros_like(xs)
            any_inside = False
            for ox, oy in sub_off:
                q = np.stack(
                    [xs + ox, ys + oy, np.ones_like(xs)], axis=-1
                ) @ Hinv.T
                a = q[..., 0] / q[..., 2]
                b = q[..., 1] / q[..., 2]
                inside = (np.abs(a) < 1.0) & (np.abs(b) < 1.0) & (q[..., 2] > 0)
                any_inside |= bool(inside.any())
                fx = np.clip((a + 1) * 0.5 * (T - 1), 0, T - 1 - 1e-6)
                fy = np.clip((b + 1) * 0.5 * (T - 1), 0, T - 1 - 1e-6)
                ix = fx.astype(np.int64)
                iy = fy.astype(np.int64)
                wx = fx - ix
                wy = fy - iy

                def samp(arr):
                    return (
                        arr[iy, ix] * (1 - wx) * (1 - wy)
                        + arr[iy, ix + 1] * wx * (1 - wy)
                        + arr[iy + 1, ix] * (1 - wx) * wy
                        + arr[iy + 1, ix + 1] * wx * wy
                    )

                tval += samp(tex) * inside
                aval += samp(alp) * inside
            if not any_inside:
                continue
            tval *= 0.25
            aval *= 0.25
            sub = img[y0:y1, x0:x1]
            img[y0:y1, x0:x1] = sub * (1 - aval) + (100.0 + tval) * aval
            inb[m] = True

        img += rng.normal(scale=self.noise_sigma, size=img.shape)
        h = 8
        inb &= (px[:, 0] > h) & (px[:, 0] < W - h) & (px[:, 1] > h) & (px[:, 1] < H - h)
        return np.clip(img, 0, 255), px, inb


class RoomRenderer:
    """Polygonal textured-room renderer: the camera moves inside a convex
    N-gon 'room' of large richly-textured wall planes (machine-hall-like
    imagery). Every pixel ray hits exactly one wall — no occlusion
    boundaries, no untextured background, perspective-exact appearance —
    so LK tracks at the sub-0.1 px level the estimator's noise model
    assumes, and every Shi-Tomasi refill lands on real trackable texture.

    render(frame) returns (img, px, inb) with px/inb the GT projections of
    world.landmarks for API compatibility with StampRenderer/PatchRenderer
    (the landmarks themselves are not drawn)."""

    def __init__(self, world: SynthWorld, cam_cfg, tic, qic, seed: int = 99,
                 n_walls: int = 28, wall_radius: float = 9.0,
                 wall_z: float = 5.0, tex_res: int = 288,
                 noise_sigma: float = 1.5, radius_jitter: float = 1.0,
                 camera_model=None,
                 motion_blur: float = 0.0,
                 exposure_flicker: float = 0.0,
                 noise_burst: float = 0.0,
                 n_occluders: int = 0):
        """Adversarial nuisance knobs (all default off — the
        photometric/dynamic effects real EuRoC MH/V sequences have and the
        LK+RANSAC+loop-verification stack exists to survive):

        - motion_blur: exposure time in seconds; the frame is smeared along
          the global image-space flow implied by the camera's angular
          velocity (rotational blur dominates on EuRoC's fast yaw sweeps).
        - exposure_flicker: relative amplitude of a per-frame global gain
          oscillation + random component (auto-exposure hunting).
        - noise_burst: every ~25 frames, 3 consecutive frames get this many
          EXTRA sigmas of sensor noise (EuRoC's dark-corridor shot noise).
        - n_occluders: textured disc sprites orbiting INSIDE the room
          (always nearer than the walls), moving against the camera motion —
          features locked onto them violate the epipolar constraint and must
          be culled by the tracker's F-RANSAC
          (feature_tracker_simple.cpp:153-180 semantics)."""
        self.world = world
        self.cam = cam_cfg
        self.tic = np.asarray(tic)
        self.qic = np.asarray(qic)
        self.K = np.array(
            [[cam_cfg.fx, 0, cam_cfg.cx], [0, cam_cfg.fy, cam_cfg.cy], [0, 0, 1]]
        )
        self.Kinv = np.linalg.inv(self.K)
        # distortion-aware rendering: when a camera model (frontend.camera)
        # is given, pixel rays come from its lift_projective (radtan/fisheye
        # distortion included) instead of the plain pinhole K — the rendered
        # imagery then exercises the tracker's undistortion path exactly like
        # real 752x480 EuRoC frames
        self.camera_model = camera_model
        self._ray_cache = None
        self.noise_sigma = noise_sigma
        from scipy.ndimage import gaussian_filter

        # wall geometry: N-gon at wall_radius with per-wall radial jitter.
        # The jitter breaks scene planarity inside one FOV — a view
        # dominated by a single plane is the classic degenerate config for
        # 8-point essential estimation, and real rooms aren't that flat
        g_rng = np.random.default_rng(seed + 7)
        ang = (np.arange(n_walls) + 0.5) * 2 * np.pi / n_walls
        radii = wall_radius + g_rng.uniform(-radius_jitter, radius_jitter, n_walls)
        self.centers = np.stack(
            [radii * np.cos(ang), radii * np.sin(ang), np.zeros(n_walls)],
            axis=1,
        )
        self.normals = -np.stack(
            [np.cos(ang), np.sin(ang), np.zeros(n_walls)], axis=1
        )  # inward
        self.u_axes = np.stack(
            [-np.sin(ang), np.cos(ang), np.zeros(n_walls)], axis=1
        )
        self.v_axes = np.tile(np.array([0.0, 0.0, 1.0]), (n_walls, 1))
        # widths sized so jittered walls still close the room (overlap a bit;
        # nearer wall wins by the depth test, seams stay 3D-consistent)
        self.half_u = (wall_radius + radius_jitter) * np.tan(np.pi / n_walls) * 1.35
        self.half_v = wall_z

        self.motion_blur = float(motion_blur)
        self.exposure_flicker = float(exposure_flicker)
        self.noise_burst = float(noise_burst)
        self.n_occluders = int(n_occluders)
        if self.n_occluders:
            o_rng = np.random.default_rng(seed + 31)
            self._occ_r = o_rng.uniform(4.5, 6.5, self.n_occluders)
            self._occ_w = o_rng.uniform(-0.5, 0.5, self.n_occluders)
            self._occ_ph = o_rng.uniform(0, 2 * np.pi, self.n_occluders)
            self._occ_z = o_rng.uniform(-0.8, 0.8, self.n_occluders)
            self._occ_zw = o_rng.uniform(0.3, 0.9, self.n_occluders)
            self._occ_rad = o_rng.uniform(0.25, 0.5, self.n_occluders)  # meters
            # per-occluder texture (multi-scale so it is TRACKABLE — the
            # point is features that lock on and then move wrongly)
            from scipy.ndimage import gaussian_filter
            To = 48
            self._occ_tex = np.zeros((self.n_occluders, To, To))
            for m in range(self.n_occluders):
                t_rng = np.random.default_rng(seed * 77 + m)
                mid = gaussian_filter(t_rng.uniform(0, 1, (To, To)), 3.0)
                fine = gaussian_filter(t_rng.uniform(0, 1, (To, To)), 0.8)
                s = 2.5 * (mid - mid.mean()) + 1.0 * (fine - fine.mean())
                self._occ_tex[m] = 60.0 + s / np.abs(s).std() * 25.0

        # per-wall multi-scale textures (corner structure at every location)
        T = tex_res
        self.tex_res = T
        self.textures = np.zeros((n_walls, T, T))
        for m in range(n_walls):
            t_rng = np.random.default_rng(seed * 1000 + m)
            coarse = gaussian_filter(t_rng.uniform(0, 1, (T, T)), T / 16.0)
            mid = gaussian_filter(t_rng.uniform(0, 1, (T, T)), T / 48.0)
            fine = gaussian_filter(t_rng.uniform(0, 1, (T, T)), 1.5)
            s = (
                3.0 * (coarse - coarse.mean())
                + 2.0 * (mid - mid.mean())
                + 0.8 * (fine - fine.mean())
            )
            self.textures[m] = 110.0 + s / np.abs(s).std() * 22.0

    def render(self, frame: int):
        H, W = self.cam.height, self.cam.width
        world = self.world
        Pb, Qb = world.P[frame], world.Q[frame]
        R_wb = _q_to_mat(Qb)
        R_bc = _q_to_mat(self.qic)
        R_wc = R_wb @ R_bc
        C_w = Pb + R_wb @ self.tic

        if self.camera_model is not None:
            if self._ray_cache is None:
                xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
                px = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
                un = np.asarray(self.camera_model.lift_projective(jnp.asarray(px)))
                self._ray_cache = un.reshape(H, W, 3)
            rays = self._ray_cache
        else:
            xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
            rays = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ self.Kinv.T
        d_w = rays @ R_wc.T  # (H,W,3), not normalized (t is then metric-z
        # along the optical axis — irrelevant, we only need the hit point)

        img = np.zeros((H, W))
        best_t = np.full((H, W), np.inf)
        for m in range(len(self.centers)):
            n = self.normals[m]
            denom = d_w @ n
            num = (self.centers[m] - C_w) @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            hit = (denom < -1e-9) & (t > 1e-6) & (t < best_t)
            if not hit.any():
                continue
            p = C_w + t[..., None] * d_w  # (H,W,3) world hit points
            rel = p - self.centers[m]
            a = rel @ self.u_axes[m]
            b = rel @ self.v_axes[m]
            inside = hit & (np.abs(a) <= self.half_u) & (np.abs(b) <= self.half_v)
            if not inside.any():
                continue
            T = self.tex_res
            fx = np.clip((a / self.half_u + 1) * 0.5 * (T - 1), 0, T - 1 - 1e-6)
            fy = np.clip((b / self.half_v + 1) * 0.5 * (T - 1), 0, T - 1 - 1e-6)
            ix = fx.astype(np.int64)
            iy = fy.astype(np.int64)
            wx = fx - ix
            wy = fy - iy
            tex = self.textures[m]
            val = (
                tex[iy, ix] * (1 - wx) * (1 - wy)
                + tex[iy, ix + 1] * wx * (1 - wy)
                + tex[iy + 1, ix] * (1 - wx) * wy
                + tex[iy + 1, ix + 1] * wx * wy
            )
            img = np.where(inside, val, img)
            best_t = np.where(inside, t, best_t)

        rng = np.random.default_rng(123456 + frame)
        t_now = float(world.frame_times[frame])

        # moving occluders: textured disc sprites inside the room, composited
        # over the walls wherever they are nearer (they always are)
        if self.n_occluders:
            R_cw_full = R_wc.T
            for m in range(self.n_occluders):
                ang = self._occ_w[m] * t_now + self._occ_ph[m]
                c_w = np.array([
                    self._occ_r[m] * np.cos(ang),
                    self._occ_r[m] * np.sin(ang),
                    self._occ_z[m] + 0.5 * np.sin(self._occ_zw[m] * t_now),
                ])
                pc = R_cw_full @ (c_w - C_w)
                if pc[2] < 1.0:
                    continue
                uv = pc[:2] / pc[2]
                cx = self.K[0, 0] * uv[0] + self.K[0, 2]
                cy = self.K[1, 1] * uv[1] + self.K[1, 2]
                r_px = self.K[0, 0] * self._occ_rad[m] / pc[2]
                if r_px < 2:
                    continue
                x0 = max(int(cx - r_px), 0)
                x1 = min(int(cx + r_px) + 1, W)
                y0 = max(int(cy - r_px), 0)
                y1 = min(int(cy + r_px) + 1, H)
                if x1 <= x0 or y1 <= y0:
                    continue
                ys, xs_ = np.mgrid[y0:y1, x0:x1]
                rr = np.sqrt((xs_ - cx) ** 2 + (ys - cy) ** 2) / max(r_px, 1e-6)
                inside = rr < 1.0
                To = self._occ_tex.shape[1]
                tx = np.clip(((xs_ - cx) / r_px + 1) * 0.5 * (To - 1), 0, To - 1).astype(int)
                ty = np.clip(((ys - cy) / r_px + 1) * 0.5 * (To - 1), 0, To - 1).astype(int)
                patch = self._occ_tex[m][ty, tx]
                sub = img[y0:y1, x0:x1]
                img[y0:y1, x0:x1] = np.where(inside, patch, sub)

        # rotational motion blur along the global flow of the camera's
        # angular velocity over the exposure time
        if self.motion_blur > 0 and 0 < frame < len(world.frame_times) - 1:
            dt = world.frame_times[frame + 1] - world.frame_times[frame - 1]
            dq = _q_mul(_q_conj(world.Q[frame - 1]), world.Q[frame + 1])
            v = dq[1:]
            wn = np.clip(dq[0], -1, 1)
            angv = 2 * np.arctan2(np.linalg.norm(v), wn)
            axis = v / max(np.linalg.norm(v), 1e-12)
            w_body = axis * angv / max(dt, 1e-9)
            w_cam = R_bc.T @ w_body
            flow = self.K[0, 0] * np.array([-w_cam[1], w_cam[0]]) * self.motion_blur
            if np.linalg.norm(flow) > 0.5:
                from scipy.ndimage import shift as _nd_shift
                acc = np.zeros_like(img)
                taps = 5
                for s in np.linspace(-0.5, 0.5, taps):
                    acc += _nd_shift(img, (s * flow[1], s * flow[0]),
                                     order=1, mode="nearest")
                img = acc / taps

        # auto-exposure hunting: per-frame global gain + offset
        if self.exposure_flicker > 0:
            g = 1.0 + self.exposure_flicker * (
                0.7 * np.sin(2.0 * np.pi * 1.3 * t_now)
                + 0.3 * rng.normal())
            img = img * g + 20.0 * self.exposure_flicker * rng.normal()

        sigma = self.noise_sigma
        if self.noise_burst > 0 and (frame % 25) < 3:
            sigma = sigma + self.noise_burst
        img = img + rng.normal(scale=sigma, size=img.shape)

        pts, depth, vis = project(world, frame, self.tic, self.qic)
        if self.camera_model is not None:
            px = np.asarray(self.camera_model.space_to_plane(jnp.asarray(pts)))
        else:
            px = (self.K @ pts.T).T[:, :2]
        h = 8
        inb = (
            vis
            & (px[:, 0] > h) & (px[:, 0] < W - h)
            & (px[:, 1] > h) & (px[:, 1] < H - h)
        )
        return np.clip(img, 0, 255), px, inb


def project(world: SynthWorld, frame: int, tic, qic, px_noise: float = 0.0, rng=None):
    """Project all landmarks into camera of `frame`. Returns (pts (M,3)
    normalized [x,y,1], depth (M,), visible (M,))."""
    p_w = world.landmarks
    Pb, Qb = world.P[frame], world.Q[frame]
    # world -> body -> camera
    p_b = _q_rotate(_q_conj(Qb), p_w - Pb)
    p_c = _q_rotate(_q_conj(np.asarray(qic)), p_b - np.asarray(tic))
    depth = p_c[:, 2]
    visible = depth > 0.3
    d_safe = np.where(np.abs(depth) > 1e-6, depth, 1.0)
    xy = p_c[:, :2] / d_safe[:, None]
    visible &= (np.abs(xy[:, 0]) < 0.81) & (np.abs(xy[:, 1]) < 0.54)  # ~EuRoC FOV
    if px_noise > 0 and rng is not None:
        xy = xy + rng.normal(size=xy.shape) * px_noise
    pts = np.concatenate([xy, np.ones((len(xy), 1))], axis=-1)
    return pts, depth, visible
