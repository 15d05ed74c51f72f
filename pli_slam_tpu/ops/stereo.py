"""Rectified stereo point matching with sub-pixel SAD refinement.

JAX replacement for `Frame::ComputeStereoMatches` (reference:
src/Frame.cc:976-1154): the reference row-buckets right keypoints, does
descriptor search per left keypoint, then slides an 11x11 SAD window
for sub-pixel disparity. Here the candidate search is one gated Hamming
matmul (row band + disparity range gates) and the SAD refinement is a
batched gather of patch stacks — no per-keypoint loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import matching
from pli_slam_tpu.ops.orb import Features

SAD_HALF = 5  # 11x11 window (reference w=5)
SAD_SHIFT = 5  # search +-5 columns around the descriptor match (reference L=5)


def _gather_patch_rows(img: jax.Array, cx: jax.Array, cy: jax.Array, half_h: int, half_w: int) -> jax.Array:
    """Gather [N, 2*half_h+1, 2*half_w+1] patches centered at (cx, cy) int32.

    vmapped dynamic_slice lowers to a gather with contiguous
    (rows x cols) slice sizes — one fetch per patch instead of one per
    pixel.
    """
    h, w = img.shape
    ph, pw = 2 * half_h + 1, 2 * half_w + 1
    y0 = jnp.clip(cy - half_h, 0, h - ph)
    x0 = jnp.clip(cx - half_w, 0, w - pw)
    return jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(img, (yy, xx), (ph, pw)))(y0, x0)


def match_stereo(
    left: Features,
    right: Features,
    img_left: jax.Array,
    img_right: jax.Array,
    max_disparity: float,
    min_disparity: float = 0.1,
    row_band: float = 2.0,
    max_dist: float = 60.0,
) -> tuple[jax.Array, jax.Array]:
    """Match left->right features and refine disparity to sub-pixel.

    Returns (u_right [N] float32, ok [N] bool) aligned with `left` slots;
    u_right = u_left - disparity (the reference's mvuRight convention,
    Frame.cc:1140). Slots without a stereo match carry ok=False.
    """
    dist = matching.hamming_matrix(left.desc, right.desc)
    # gates: same row (scaled band like the reference's scale-dependent r),
    # positive disparity within range, compatible octave
    band = row_band * jnp.maximum(left.scale[:, None], right.scale[None, :])
    g_row = jnp.abs(left.uv[:, 1][:, None] - right.uv[:, 1][None, :]) <= band
    disp = left.uv[:, 0][:, None] - right.uv[:, 0][None, :]
    g_disp = (disp >= min_disparity) & (disp <= max_disparity)
    g_scale = matching.scale_gate(left.octave, right.octave, 1)
    gate = g_row & g_disp & g_scale

    idx_r, best, ok = matching.match_nn(
        dist, left.valid, right.valid, gate, max_dist=max_dist, ratio=0.85
    )
    # mutual best-match check kills most repeated-texture mismatches
    ok = matching.mutual_consistency(idx_r, ok, dist, left.valid, right.valid, gate)

    # --- sub-pixel SAD refinement around the matched column ------------
    # (reference: Frame.cc:1049-1116 — 11x11 mean-normalized SAD, +-5 px,
    # parabola fit over the best three)
    xl = jnp.round(left.uv[:, 0]).astype(jnp.int32)
    yl = jnp.round(left.uv[:, 1]).astype(jnp.int32)
    xr0 = jnp.round(right.uv[idx_r, 0]).astype(jnp.int32)

    patch_l = _gather_patch_rows(img_left, xl, yl, SAD_HALF, SAD_HALF)  # [N,11,11]
    strip_r = _gather_patch_rows(img_right, xr0, yl, SAD_HALF, SAD_HALF + SAD_SHIFT)  # [N,11,21]
    patch_l = patch_l - patch_l.mean(axis=(1, 2), keepdims=True)

    def sad_at(offset):
        win = jax.lax.dynamic_slice_in_dim(strip_r, offset, 2 * SAD_HALF + 1, axis=2)
        win = win - win.mean(axis=(1, 2), keepdims=True)
        return jnp.sum(jnp.abs(patch_l - win), axis=(1, 2))

    sads = jnp.stack([sad_at(o) for o in range(2 * SAD_SHIFT + 1)], axis=1)  # [N, 11]
    best_o = jnp.argmin(sads, axis=1)
    center = jnp.clip(best_o, 1, 2 * SAD_SHIFT - 1)
    s_m = jnp.take_along_axis(sads, (center - 1)[:, None], axis=1)[:, 0]
    s_0 = jnp.take_along_axis(sads, center[:, None], axis=1)[:, 0]
    s_p = jnp.take_along_axis(sads, (center + 1)[:, None], axis=1)[:, 0]
    denom = s_m + s_p - 2.0 * s_0
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    u_r = xr0.astype(jnp.float32) + (center - SAD_SHIFT).astype(jnp.float32) + delta

    disparity = left.uv[:, 0] - u_r
    ok = ok & (disparity >= min_disparity) & (disparity <= max_disparity)

    # median-SAD outlier rejection (reference: 1.5*1.4*median, Frame.cc:1120-1135)
    from pli_slam_tpu.ops.robust import masked_median

    best_sad = jnp.take_along_axis(sads, best_o[:, None], axis=1)[:, 0]
    med = masked_median(best_sad, ok)
    ok = ok & (best_sad <= 2.1 * med + 1e-6)
    return u_r, ok


def depths_from_stereo(left: Features, u_right: jax.Array, ok: jax.Array, bf: float) -> jax.Array:
    """Per-slot depth (bf / disparity); invalid slots get -1 (reference mvDepth)."""
    disparity = left.uv[:, 0] - u_right
    depth = bf / jnp.maximum(disparity, 1e-6)
    return jnp.where(ok, depth, -1.0)
