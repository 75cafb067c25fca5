"""Pyramidal Lucas-Kanade optical flow, batched over features.

Replaces cv::calcOpticalFlowPyrLK (21x21 window, 3 levels;
feature_tracker_simple.cpp:114).

Layout: per feature and iteration we take ONE vmapped `lax.dynamic_slice`
of a (P+3, P+3) integer-aligned window (XLA lowers the vmap to a block
gather of contiguous rows) and do the subpixel bilinear interpolation as
four shifted whole-patch multiplies (elementwise math), instead of
gathering 441 scattered pixels per feature per iteration through
`img[y, x]` advanced indexing. Images are edge-padded once per level so
border features degrade gracefully instead of sliding the window.

The iterative update runs in a `lax.fori_loop` — one jit per
(n_levels, patch, iters) signature, all features in parallel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .image_ops import build_pyramid


def _shift_bilinear(q, fx, fy, P: int, dy: int, dx: int):
    """Bilinear sample of the PxP template grid inside patch q ((S,S), S=P+3,
    origin at integer corner - 1), shifted by the static integer (dy, dx).
    fx/fy are the scalar fractional offsets of the grid origin."""
    a, b = 1 + dy, 1 + dx
    q00 = jax.lax.dynamic_slice(q, (a, b), (P, P))
    q01 = jax.lax.dynamic_slice(q, (a, b + 1), (P, P))
    q10 = jax.lax.dynamic_slice(q, (a + 1, b), (P, P))
    q11 = jax.lax.dynamic_slice(q, (a + 1, b + 1), (P, P))
    return (
        q00 * (1 - fx) * (1 - fy)
        + q01 * fx * (1 - fy)
        + q10 * (1 - fx) * fy
        + q11 * fx * fy
    )


def _lk_level(img0p, img1p, pad: int, pts0, guess, valid, half: int,
              iters: int, dtype):
    """One pyramid level. img*p are edge-padded by `pad`; pts0/guess (N,2) in
    the level's UNPADDED pixel coords."""
    P = 2 * half + 1
    S = P + 3

    def slice_patch(imgp, corner_xy):
        """(S,S) window whose [1,1] element is the integer corner."""
        ix = jnp.floor(corner_xy[0]).astype(jnp.int32)
        iy = jnp.floor(corner_xy[1]).astype(jnp.int32)
        q = jax.lax.dynamic_slice(imgp, (iy - 1 + pad, ix - 1 + pad), (S, S))
        return q, corner_xy[0] - ix, corner_xy[1] - iy

    def one(p0, g, v):
        q0, fx0, fy0 = slice_patch(img0p, p0 - half)
        t = _shift_bilinear(q0, fx0, fy0, P, 0, 0)
        # template gradients via central differences on the same patch
        dx = 0.5 * (_shift_bilinear(q0, fx0, fy0, P, 0, 1)
                    - _shift_bilinear(q0, fx0, fy0, P, 0, -1))
        dy = 0.5 * (_shift_bilinear(q0, fx0, fy0, P, 1, 0)
                    - _shift_bilinear(q0, fx0, fy0, P, -1, 0))
        gxx = jnp.sum(dx * dx)
        gxy = jnp.sum(dx * dy)
        gyy = jnp.sum(dy * dy)
        det = gxx * gyy - gxy * gxy
        ok_g = det > 1e-6
        det_safe = jnp.where(ok_g, det, 1.0)

        def body(_, cur):
            q1, fx1, fy1 = slice_patch(img1p, cur - half)
            diff = _shift_bilinear(q1, fx1, fy1, P, 0, 0) - t
            bx = jnp.sum(diff * dx)
            by = jnp.sum(diff * dy)
            du = -(gyy * bx - gxy * by) / det_safe
            dv = -(-gxy * bx + gxx * by) / det_safe
            return cur + jnp.stack([du, dv])

        p1 = jax.lax.fori_loop(0, iters, body, g)
        # residual check: mean abs diff after convergence
        q1, fx1, fy1 = slice_patch(img1p, p1 - half)
        err = jnp.mean(jnp.abs(_shift_bilinear(q1, fx1, fy1, P, 0, 0) - t))
        return p1, v & ok_g, err

    return jax.vmap(one)(pts0, guess, valid)


@functools.partial(jax.jit, static_argnames=("levels", "half", "iters"))
def pyramidal_lk(
    img0, img1, pts0, valid, levels: int = 3, half: int = 10, iters: int = 10,
    guess0=None,
):
    """Track pts0 (N,2) from img0 to img1 (both (H,W) float). Returns
    (pts1 (N,2), ok (N,), err (N,)). 21x21 window = half 10.

    guess0: optional (N,2) initial position in img1 (full-res coords) —
    cv::OPTFLOW_USE_INITIAL_FLOW semantics; used by the tracker's
    forward-backward check to run the backward pass single-level."""
    dtype = img0.dtype
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    pad = half + 3
    scale = 2.0 ** (levels - 1)
    guess = (pts0 if guess0 is None else guess0) / scale
    ok = valid
    err = jnp.zeros(pts0.shape[0], dtype)
    for lv in range(levels - 1, -1, -1):
        s = 2.0**lv
        p_lv = pts0 / s
        i0p = jnp.pad(pyr0[lv], pad, mode="edge")
        i1p = jnp.pad(pyr1[lv], pad, mode="edge")
        guess, ok, err = _lk_level(i0p, i1p, pad, p_lv, guess, ok, half, iters, dtype)
        if lv > 0:
            guess = guess * 2.0
    H, W = img0.shape
    inb = (
        (guess[:, 0] >= 1)
        & (guess[:, 0] < W - 1)
        & (guess[:, 1] >= 1)
        & (guess[:, 1] < H - 1)
    )
    ok = ok & inb & (err < 30.0)
    return guess, ok, err
