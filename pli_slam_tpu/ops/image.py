"""Image ops: Gaussian blur, bilinear resize, pyramids, gradients.

JAX replacement for the reference's OpenCV usage inside
`ORBextractor::ComputePyramid` (reference: src/ORBextractor.cc:1152 —
cv::resize + copyMakeBorder) and the pre-descriptor GaussianBlur
(reference: src/ORBextractor.cc:1105). Everything is expressed as
XLA convolutions / gathers with static shapes so the whole pyramid
builds in one fused device program.

Images are float32 `[H, W]` (single channel), values in [0, 255].
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp


def gaussian_kernel1d(sigma: float, radius: int) -> jax.Array:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _sep_filter(img: jax.Array, taps: jax.Array, axis: int) -> jax.Array:
    """1-D filter along `axis` via shifted adds.

    A k-tap separable filter as k rolls + fused multiply-adds is purely
    elementwise, so XLA fuses it instead of lowering a single-channel
    2-D conv (a design choice not yet measured on the card).
    Edge handling approximates replicate-padding (roll wraps, but the
    border pixels involved are masked out by every consumer).
    """
    radius = taps.shape[0] // 2
    out = jnp.zeros_like(img)
    for i in range(taps.shape[0]):
        out = out + taps[i] * jnp.roll(img, radius - i, axis=axis)
    return out


def gaussian_blur(img: jax.Array, sigma: float = 2.0, radius: int = 3) -> jax.Array:
    """Separable Gaussian blur as shifted adds. Accepts [..., H, W].

    (reference blurs with 7x7 sigma=2 before computing descriptors,
    src/ORBextractor.cc:1105)
    """
    k = gaussian_kernel1d(sigma, radius)
    return _sep_filter(_sep_filter(img, k, -2), k, -1)


def bilinear_resize(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Bilinear resize (align_corners=False, half-pixel centers, like cv::resize)."""
    h, w = img.shape
    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * (h / out_h) - 0.5
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * (w / out_w) - 0.5
    ys = jnp.clip(ys, 0.0, h - 1.0)
    xs = jnp.clip(xs, 0.0, w - 1.0)
    y0 = jnp.floor(ys).astype(jnp.int32)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Static per-level (H, W) shapes (reference: mvScaleFactor layout)."""
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def build_pyramid(img: jax.Array, n_levels: int, scale_factor: float) -> list[jax.Array]:
    """Image pyramid: each level resized from the previous (like ComputePyramid)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(bilinear_resize(levels[-1], *shapes[lvl]))
    return levels


def sobel_gradients(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sobel gx, gy as separable shifted adds (Sobel = smooth [1,2,1] x diff
    [-1,0,1]) instead of single-channel 2-D convs. Accepts [..., H, W]."""
    smooth = jnp.array([1.0, 2.0, 1.0], jnp.float32)
    diff = jnp.array([-1.0, 0.0, 1.0], jnp.float32)
    gx = _sep_filter(_sep_filter(img, smooth, -2), diff, -1)
    gy = _sep_filter(_sep_filter(img, smooth, -1), diff, -2)
    return gx, gy


def bilinear_sample(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Sample image at float pixel coords uv [...,2] = (x, y), clamped."""
    h, w = img.shape
    x = jnp.clip(uv[..., 0], 0.0, w - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def nearest_sample(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Nearest-neighbor sample at float coords uv [...,2] = (x, y), clamped.

    ORB descriptors use rounded rotated coordinates (reference rBRIEF
    GET_VALUE macro, src/ORBextractor.cc), so nearest sampling matches.
    """
    h, w = img.shape
    x = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, h - 1)
    return img[y, x]
