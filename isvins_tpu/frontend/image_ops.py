"""Image kernels: separable Gaussian blur, pyramid, CLAHE, Sobel gradients,
Shi-Tomasi response, non-maximum suppression, bilinear sampling.

These replace the OpenCV calls of feature_tracker_simple.cpp (CLAHE :86–92,
buildOpticalFlowPyramid/calcOpticalFlowPyrLK :114, goodFeaturesToTrack :140)
with XLA-fusable jnp ops: convolutions via lax.conv, histograms via one-hot
matmuls, patch gathers via vectorized bilinear interpolation — all batched,
statically shaped, jit-compiled once per image size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _gauss_kernel(sigma: float, radius: int, dtype):
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _conv1d_axis(img, k, axis: int):
    """1D correlation along `axis` with SAME (zero) padding, as shift-add:
    sum_i k[i] * img shifted by i: elementwise work that XLA fuses, instead
    of a single-channel lax.conv. Which is faster on the H100 is
    unmeasured."""
    r = (k.shape[0] - 1) // 2
    H, W = img.shape
    pad_width = [(0, 0), (0, 0)]
    pad_width[axis] = (r, r)
    p = jnp.pad(img, pad_width)
    out = jnp.zeros_like(img)
    for i in range(k.shape[0]):
        if axis == 0:
            out = out + k[i] * jax.lax.slice(p, (i, 0), (i + H, W))
        else:
            out = out + k[i] * jax.lax.slice(p, (0, i), (H, i + W))
    return out


def sep_conv2d(img, kx, ky):
    """Separable 2D convolution with SAME padding. img (H,W)."""
    return _conv1d_axis(_conv1d_axis(img, kx, 1), ky, 0)


def gaussian_blur(img, sigma: float = 1.0, radius: int = 2):
    k = _gauss_kernel(sigma, radius, img.dtype)
    return sep_conv2d(img, k, k)


def pyr_down(img):
    """Gaussian blur + 2x decimation (cv::pyrDown-like)."""
    return gaussian_blur(img, 1.0, 2)[::2, ::2]


def build_pyramid(img, levels: int):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def sobel(img):
    """Returns (gx, gy) with 3x3 Sobel, SAME padding (separable shift-add:
    smooth [1,2,1]/4 across, difference [-1,0,1]/2 along)."""
    smooth = jnp.array([0.25, 0.5, 0.25], img.dtype)
    diff = jnp.array([-0.5, 0.0, 0.5], img.dtype)
    gx = _conv1d_axis(_conv1d_axis(img, smooth, 0), diff, 1)
    gy = _conv1d_axis(_conv1d_axis(img, smooth, 1), diff, 0)
    return gx, gy


def shi_tomasi_response(img, window: int = 3):
    """Min-eigenvalue corner response (cv::goodFeaturesToTrack scoring)."""
    gx, gy = sobel(img)
    k = jnp.ones((window,), img.dtype) / window
    xx = sep_conv2d(gx * gx, k, k)
    yy = sep_conv2d(gy * gy, k, k)
    xy = sep_conv2d(gx * gy, k, k)
    tr = xx + yy
    det_term = jnp.sqrt(jnp.maximum((xx - yy) ** 2 + 4.0 * xy * xy, 0.0))
    return 0.5 * (tr - det_term)


def nms_topk(response, k: int, nms_radius: int, border: int = 8, forbid_mask=None):
    """Greedy-free NMS: local-max test via max-pool, then top-k by response.
    forbid_mask (H,W) True = excluded (existing-feature min-dist mask)."""
    H, W = response.shape
    r = nms_radius
    # square max-pool is separable: two 1D passes instead of one (2r+1)^2
    # window (33x33 at min_dist 16)
    pooled = jax.lax.reduce_window(
        response, -jnp.inf, jax.lax.max, (2 * r + 1, 1), (1, 1), "SAME"
    )
    pooled = jax.lax.reduce_window(
        pooled, -jnp.inf, jax.lax.max, (1, 2 * r + 1), (1, 1), "SAME"
    )
    is_max = response >= pooled
    resp = jnp.where(is_max, response, -jnp.inf)
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    resp = jnp.where(inb, resp, -jnp.inf)
    if forbid_mask is not None:
        resp = jnp.where(forbid_mask, -jnp.inf, resp)
    vals, idx = jax.lax.top_k(resp.reshape(-1), k)
    pys = idx // W
    pxs = idx % W
    ok = jnp.isfinite(vals)
    return jnp.stack([pxs, pys], axis=-1).astype(response.dtype), vals, ok


def min_dist_mask(H: int, W: int, pts, valid, radius: int):
    """Disk mask around existing points (setMask semantics,
    feature_tracker_simple.cpp:37–69). pts (N,2) xy pixels."""
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(pts.dtype)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(pts.dtype)
    d2 = (
        (xx[None] - pts[:, 0][:, None, None]) ** 2
        + (yy[None] - pts[:, 1][:, None, None]) ** 2
    )
    hit = (d2 <= radius * radius) & valid[:, None, None]
    return jnp.any(hit, axis=0)


def bilinear_sample(img, xy):
    """Sample img (H,W) at subpixel xy (...,2) with border clamping."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    wx = x - x0
    wy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )


@functools.partial(jax.jit, static_argnames=("tiles", "bins"))
def clahe(img, clip_limit: float = 3.0, tiles: int = 8, bins: int = 256):
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(3.0, (8,8)), feature_tracker_simple.cpp:86–92).

    Tile histograms are built with one one-hot matmul, clipped with uniform
    redistribution, turned into CDF LUTs, and applied with bilinear
    interpolation between the four surrounding tile LUTs."""
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    Hc, Wc = th * tiles, tw * tiles
    imc = img[:Hc, :Wc]
    ii = jnp.clip(imc, 0, bins - 1).astype(jnp.int32)

    tiled = ii.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3).reshape(tiles * tiles, -1)
    onehot = jax.nn.one_hot(tiled, bins, dtype=jnp.float32)  # (T, th*tw, bins)
    hist = jnp.sum(onehot, axis=1)  # (T, bins)

    npx = th * tw
    limit = jnp.maximum(clip_limit * npx / bins, 1.0)
    excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, limit) + excess / bins

    cdf = jnp.cumsum(hist, axis=1)
    cdf = (cdf - cdf[:, :1]) / jnp.maximum(cdf[:, -1:] - cdf[:, :1], 1.0) * (bins - 1)
    luts = cdf.reshape(tiles, tiles, bins)

    # bilinear interpolation between tile LUTs
    yy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    ty = jnp.clip(yy / th - 0.5, 0.0, tiles - 1.001)
    tx = jnp.clip(xx / tw - 0.5, 0.0, tiles - 1.001)
    ty0 = jnp.floor(ty).astype(jnp.int32)
    tx0 = jnp.floor(tx).astype(jnp.int32)
    ty1 = jnp.minimum(ty0 + 1, tiles - 1)
    tx1 = jnp.minimum(tx0 + 1, tiles - 1)
    wy = ty - ty0
    wx = tx - tx0

    iv = jnp.clip(img, 0, bins - 1).astype(jnp.int32)
    v00 = luts[ty0, tx0, iv]
    v01 = luts[ty0, tx1, iv]
    v10 = luts[ty1, tx0, iv]
    v11 = luts[ty1, tx1, iv]
    out = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx
    return out.astype(img.dtype) if jnp.issubdtype(img.dtype, jnp.floating) else out
