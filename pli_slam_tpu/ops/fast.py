"""FAST-9/16 corner detection as whole-image batched integer ops.

JAX replacement for the reference's per-pixel OpenCV
`FAST(...)` calls inside `ORBextractor::ComputeKeyPointsOctTree`
(reference: src/ORBextractor.cc:763-860). Instead of scalar loops the
whole image is tested at once: the 16-pixel Bresenham ring is
materialized as 16 `roll`-shifted copies, the segment test becomes a
16-bit ring-mask contiguity check done with shifts/ANDs on `[H, W]`
int32 planes, and non-max suppression is a 3x3 `reduce_window`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (dx, dy), clockwise from 12 o'clock —
# the standard FAST-16 ring.
RING_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

_ARC_LEN = 9  # FAST-9: need 9 contiguous ring pixels all brighter / all darker
_ARC_MASK = (1 << _ARC_LEN) - 1


def _ring_stack(img: jax.Array) -> jax.Array:
    """[16, ..., H, W] of ring-shifted copies: ring[i][..., y, x] =
    img[..., y+dy_i, x+dx_i]. Accepts leading batch dims (pyramid stack)."""
    shifted = [jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1)) for dx, dy in RING_OFFSETS]
    return jnp.stack(shifted, axis=0)


def _has_contiguous_arc(ring_bits: jax.Array) -> jax.Array:
    """True where the 16-bit ring mask contains >= 9 contiguous set bits (cyclic)."""
    wrapped = ring_bits | (ring_bits << 16)  # unwrap the cycle into 32 bits
    ok = jnp.zeros_like(ring_bits, dtype=bool)
    for s in range(16):
        ok = ok | (((wrapped >> s) & _ARC_MASK) == _ARC_MASK)
    return ok


def fast_score(img: jax.Array, threshold: float, diff: jax.Array | None = None) -> tuple[jax.Array, jax.Array]:
    """FAST-9/16 corner response over the full image.

    Returns (score [H,W] float32, is_corner [H,W] bool). Score is the
    sum of threshold-excess absolute differences on the dominant side
    (the cv::FAST V-score up to normalization). A 3-pixel border is
    masked out. `diff` (the precomputed ring-difference stack) can be
    shared between threshold passes.
    """
    if diff is None:
        ring = _ring_stack(img)  # [16, H, W]
        diff = ring - img[None]
    brighter = diff > threshold
    darker = diff < -threshold

    weights = (1 << jnp.arange(16, dtype=jnp.int32)).reshape((16,) + (1,) * (diff.ndim - 1))
    bits_b = jnp.sum(jnp.where(brighter, weights, 0), axis=0)
    bits_d = jnp.sum(jnp.where(darker, weights, 0), axis=0)
    corner = _has_contiguous_arc(bits_b) | _has_contiguous_arc(bits_d)

    excess_b = jnp.sum(jnp.where(brighter, diff - threshold, 0.0), axis=0)
    excess_d = jnp.sum(jnp.where(darker, -diff - threshold, 0.0), axis=0)
    score = jnp.maximum(excess_b, excess_d)

    h, w = img.shape[-2:]
    ys = jax.lax.broadcasted_iota(jnp.int32, img.shape, img.ndim - 2)
    xs = jax.lax.broadcasted_iota(jnp.int32, img.shape, img.ndim - 1)
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    corner = corner & interior
    return jnp.where(corner, score, 0.0), corner


def nms_3x3(score: jax.Array) -> jax.Array:
    """Keep local maxima of the score map (3x3 window). Accepts [..., H, W]."""
    nb = score.ndim - 2
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max,
        (1,) * nb + (3, 3), (1,) * nb + (1, 1), "SAME",
    )
    return (score >= m) & (score > 0.0)


def detect(img: jax.Array, threshold: float, min_threshold: float | None = None) -> tuple[jax.Array, jax.Array]:
    """Full detection: score + segment test + NMS, with a low-threshold
    fallback blended in where the strict threshold found nothing nearby.

    The reference re-runs FAST at `minThFAST` in cells with no response
    (src/ORBextractor.cc:805-815); here the low-threshold response is
    simply kept at a score discount so cell-wise top-K naturally prefers
    strict corners but can fall back — same intent, no second pass.
    """
    diff = _ring_stack(img) - img[None]
    score_hi, _ = fast_score(img, threshold, diff)
    if min_threshold is not None and min_threshold < threshold:
        score_lo, _ = fast_score(img, min_threshold, diff)
        # strict corners dominate: lift them above every fallback corner
        score = jnp.where(score_hi > 0, score_hi + 1e4, score_lo)
    else:
        score = score_hi
    keep = nms_3x3(score)
    return jnp.where(keep, score, 0.0), keep
