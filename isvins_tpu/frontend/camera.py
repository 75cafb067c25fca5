"""The camodocal camera-model family, batched over points.

Replaces thirdparty/camera_models (~5.2 kLoC C++): PinholeCamera (radtan),
CataCamera (Mei unified catadioptric), EquidistantCamera (Kannala-Brandt
fisheye) and ScaramuzzaCamera (OCAM polynomial omnidirectional), plus the
CameraFactory dispatch. Every model exposes the same two batched maps —
`space_to_plane` (3D camera-frame -> pixels) and `lift_projective`
(pixels -> normalized plane [x, y, 1]) — as pure jittable functions over
(..., 3)/(..., 2) arrays instead of camodocal's per-point virtual calls.

Per-point iterative inverses (the radtan/Mei recursive undistortion,
PinholeCamera.cc:459–484 / CataCamera.cc:596–612, and the Kannala-Brandt
theta polynomial root, EquidistantCamera.cc:700–770) become fixed-iteration
batched loops: fixed-point for the distortion inverses (matching camodocal's
recursive model) and Newton for the KB radius polynomial (camodocal builds a
companion-matrix eigendecomposition per point — a Newton iteration from
theta=r converges quadratically on the monotone branch every real lens lives
on, and is branchless/batchable).

NB all models return lift_projective normalized to z=1, matching how the
consumers use the camodocal ray (feature_tracker_simple.cpp divides the
lifted ray by z before use). Rays at or beyond 90 deg off-axis (z <= 0,
possible for fisheye/OCAM) are clamped to a tiny positive z.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PinholeRadtan(NamedTuple):
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray

    @staticmethod
    def from_config(cam) -> "PinholeRadtan":
        mk = lambda v: np.asarray(v, np.float64)  # host consts: embedded
        # at trace time by the jits that close over them
        return PinholeRadtan(
            mk(cam.fx), mk(cam.fy), mk(cam.cx), mk(cam.cy),
            mk(cam.k1), mk(cam.k2), mk(cam.p1), mk(cam.p2),
        )

    def distort(self, xy):
        """Apply radtan distortion on normalized coords. xy (...,2)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = self.k1 * r2 + self.k2 * r2 * r2
        dx = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return xy + jnp.stack([dx, dy], axis=-1)

    def space_to_plane(self, p3):
        """(...,3) camera-frame points -> (...,2) pixels (with distortion)."""
        z = jnp.where(jnp.abs(p3[..., 2]) > 1e-9, p3[..., 2], 1e-9)
        xy = p3[..., :2] / z[..., None]
        xyd = self.distort(xy)
        u = self.fx * xyd[..., 0] + self.cx
        v = self.fy * xyd[..., 1] + self.cy
        return jnp.stack([u, v], axis=-1)

    def lift_projective(self, uv, iters: int = 25):
        """(...,2) pixels -> (...,3) normalized bearings [x, y, 1]
        (camodocal liftProjective with the iterative distortion inverse)."""
        xd = (uv[..., 0] - self.cx) / self.fx
        yd = (uv[..., 1] - self.cy) / self.fy
        pd = jnp.stack([xd, yd], axis=-1)

        def body(_, p):
            d = self.distort(p) - p  # distortion offset at current estimate
            return pd - d

        p = jax.lax.fori_loop(0, iters, body, pd)
        return jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)

    @property
    def focal(self):
        return self.fx


def _z1(xy_or_ray):
    """Normalize a projective ray (...,3) to z=1 with a safe z clamp."""
    z = xy_or_ray[..., 2]
    z = jnp.where(z > 1e-6, z, 1e-6)
    return jnp.concatenate(
        [xy_or_ray[..., :2] / z[..., None], jnp.ones_like(z)[..., None]], axis=-1
    )


class MeiCamera(NamedTuple):
    """Unified catadioptric model (camodocal CataCamera, CataCamera.cc).

    Projection (spaceToPlane, :636–667): the point is projected onto the unit
    sphere, then onto the normalized plane through a center shifted by the
    mirror parameter xi, radtan-distorted, and scaled by (gamma1, gamma2).
    """

    xi: jnp.ndarray
    gamma1: jnp.ndarray
    gamma2: jnp.ndarray
    u0: jnp.ndarray
    v0: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray

    @staticmethod
    def from_config(cam) -> "MeiCamera":
        mk = lambda v: np.asarray(v, np.float64)  # host consts: embedded
        # at trace time by the jits that close over them
        return MeiCamera(
            mk(cam.xi), mk(cam.fx), mk(cam.fy), mk(cam.cx), mk(cam.cy),
            mk(cam.k1), mk(cam.k2), mk(cam.p1), mk(cam.p2),
        )

    def distort(self, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = self.k1 * r2 + self.k2 * r2 * r2
        dx = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return xy + jnp.stack([dx, dy], axis=-1)

    def space_to_plane(self, p3):
        norm = jnp.linalg.norm(p3, axis=-1)
        z = p3[..., 2] + self.xi * norm
        z = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
        xy = p3[..., :2] / z[..., None]
        xyd = self.distort(xy)
        u = self.gamma1 * xyd[..., 0] + self.u0
        v = self.gamma2 * xyd[..., 1] + self.v0
        return jnp.stack([u, v], axis=-1)

    def lift_projective(self, uv, iters: int = 8):
        """CataCamera::liftProjective (:556–627): recursive distortion
        inverse, then the closed-form unified-model ray, renormalized to
        z=1 (see module docstring)."""
        xd = (uv[..., 0] - self.u0) / self.gamma1
        yd = (uv[..., 1] - self.v0) / self.gamma2
        pd = jnp.stack([xd, yd], axis=-1)

        def body(_, p):
            return pd - (self.distort(p) - p)

        p = jax.lax.fori_loop(0, iters, body, pd)
        rho2 = p[..., 0] ** 2 + p[..., 1] ** 2
        # z on the unit sphere re-projected through the xi-shifted center
        # (:617–626); the xi==1 special case is this formula's limit
        z = 1.0 - self.xi * (rho2 + 1.0) / (
            self.xi + jnp.sqrt(1.0 + (1.0 - self.xi**2) * rho2)
        )
        ray = jnp.concatenate([p, z[..., None]], axis=-1)
        return _z1(ray)

    @property
    def focal(self):
        # near-axis virtual pinhole focal of the unified model:
        # du/dx|0 = gamma1 / (1 + xi)
        return self.gamma1 / (1.0 + self.xi)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt fisheye (camodocal EquidistantCamera.cc).

    r(theta) = theta + k2 th^3 + k3 th^5 + k4 th^7 + k5 th^9 (:139–151);
    projection maps (theta, phi) to r(theta) * (cos phi, sin phi) scaled by
    (mu, mv) (:451–462). The lift inverts r(theta) by Newton instead of the
    reference's per-point companion-matrix roots (backprojectSymmetric,
    :700–770).
    """

    mu: jnp.ndarray
    mv: jnp.ndarray
    u0: jnp.ndarray
    v0: jnp.ndarray
    k2: jnp.ndarray
    k3: jnp.ndarray
    k4: jnp.ndarray
    k5: jnp.ndarray

    @staticmethod
    def from_config(cam) -> "EquidistantCamera":
        mk = lambda v: np.asarray(v, np.float64)  # host consts: embedded
        # at trace time by the jits that close over them
        k2, k3, k4, k5 = cam.kb
        return EquidistantCamera(
            mk(cam.fx), mk(cam.fy), mk(cam.cx), mk(cam.cy),
            mk(k2), mk(k3), mk(k4), mk(k5),
        )

    def _r(self, th):
        th2 = th * th
        return th * (1.0 + th2 * (self.k2 + th2 * (self.k3 + th2 * (self.k4 + th2 * self.k5))))

    def _dr(self, th):
        th2 = th * th
        return 1.0 + th2 * (3.0 * self.k2 + th2 * (5.0 * self.k3 + th2 * (7.0 * self.k4 + th2 * 9.0 * self.k5)))

    def space_to_plane(self, p3):
        norm = jnp.linalg.norm(p3, axis=-1)
        norm = jnp.where(norm > 1e-12, norm, 1e-12)
        theta = jnp.arccos(jnp.clip(p3[..., 2] / norm, -1.0, 1.0))
        rxy = jnp.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
        rxy = jnp.where(rxy > 1e-12, rxy, 1e-12)
        r = self._r(theta)
        u = self.mu * r * p3[..., 0] / rxy + self.u0
        v = self.mv * r * p3[..., 1] / rxy + self.v0
        return jnp.stack([u, v], axis=-1)

    def lift_projective(self, uv, iters: int = 10):
        mx = (uv[..., 0] - self.u0) / self.mu
        my = (uv[..., 1] - self.v0) / self.mv
        r = jnp.sqrt(mx * mx + my * my)

        def body(_, th):
            step = (self._r(th) - r) / self._dr(th)
            return jnp.clip(th - step, 0.0, jnp.pi)

        theta = jax.lax.fori_loop(0, iters, body, r)
        rs = jnp.where(r > 1e-12, r, 1e-12)
        s = jnp.sin(theta)
        ray = jnp.stack(
            [s * mx / rs, s * my / rs, jnp.cos(theta)], axis=-1
        )
        return _z1(ray)

    @property
    def focal(self):
        return self.mu


class OcamCamera(NamedTuple):
    """Scaramuzza OCAM polynomial omnidirectional model (camodocal
    ScaramuzzaCamera.cc / OCAMCamera).

    cam2world polynomial `poly` lifts image radius -> -z (liftProjective,
    :599–622); world2cam polynomial `inv_poly` maps incidence angle
    theta=atan2(-z, rho) -> image radius (spaceToPlane, :632–653); the 2x2
    affine [C D; E 1] + center models sensor skew. Polynomials are stored
    zero-padded to fixed length so one jitted program serves every calib.
    """

    poly: jnp.ndarray  # (P,) cam2world, a0..a(P-1)
    inv_poly: jnp.ndarray  # (Q,) world2cam
    C: jnp.ndarray
    D: jnp.ndarray
    E: jnp.ndarray
    center_x: jnp.ndarray
    center_y: jnp.ndarray
    focal_hint: jnp.ndarray  # virtual-pinhole focal for normalized gates

    @staticmethod
    def from_config(cam) -> "OcamCamera":
        mk = lambda v: np.asarray(v, np.float64)  # host consts: embedded
        # at trace time by the jits that close over them
        return OcamCamera(
            mk(list(cam.ocam_poly)), mk(list(cam.ocam_inv_poly)),
            mk(cam.ocam_cde[0]), mk(cam.ocam_cde[1]), mk(cam.ocam_cde[2]),
            mk(cam.cx), mk(cam.cy), mk(cam.fx),
        )

    @staticmethod
    def _polyval(coeffs, x):
        """sum_i coeffs[i] * x^i, Horner over the padded coefficient vector."""
        acc = jnp.zeros_like(x)
        for c in list(coeffs)[::-1]:
            acc = acc * x + c
        return acc

    def space_to_plane(self, p3):
        rho = jnp.sqrt(p3[..., 0] ** 2 + p3[..., 1] ** 2)
        theta = jnp.arctan2(-p3[..., 2], rho)
        r_img = self._polyval(self.inv_poly, theta)
        rs = jnp.where(rho > 1e-12, rho, 1e-12)
        xn = p3[..., 0] / rs * r_img
        yn = p3[..., 1] / rs * r_img
        u = xn * self.C + yn * self.D + self.center_x
        v = xn * self.E + yn + self.center_y
        return jnp.stack([u, v], axis=-1)

    def lift_projective(self, uv):
        xc = uv[..., 0] - self.center_x
        yc = uv[..., 1] - self.center_y
        inv_scale = 1.0 / (self.C - self.D * self.E)
        xa = inv_scale * (xc - self.D * yc)
        ya = inv_scale * (-self.E * xc + self.C * yc)
        phi = jnp.sqrt(xa * xa + ya * ya)
        z = -self._polyval(self.poly, phi)
        # the reference returns the un-deaffined (xc, yc) with -poly(phi)
        # (:621); we keep the affine-corrected sensor-plane coords, which is
        # the geometrically consistent pair for the same polynomial
        ray = jnp.stack([xa, ya, z], axis=-1)
        return _z1(ray)

    @property
    def focal(self):
        return self.focal_hint


def make_camera(cam_cfg):
    """camodocal::CameraFactory::generateCamera equivalent
    (CameraFactory.cc:64–137), dispatching on CameraConfig.model."""
    model = getattr(cam_cfg, "model", "pinhole")
    if model == "pinhole":
        return PinholeRadtan.from_config(cam_cfg)
    if model == "mei":
        return MeiCamera.from_config(cam_cfg)
    if model in ("equidistant", "kannala_brandt", "fisheye"):
        return EquidistantCamera.from_config(cam_cfg)
    if model in ("scaramuzza", "ocam"):
        if len(cam_cfg.ocam_poly) == 0 or len(cam_cfg.ocam_inv_poly) == 0:
            raise ValueError("scaramuzza model requires ocam_poly/ocam_inv_poly")
        return OcamCamera.from_config(cam_cfg)
    raise ValueError(f"unknown camera model: {model!r}")
