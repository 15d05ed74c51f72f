"""ORB feature extraction: pyramid FAST + IC-angle + steered BRIEF, fully batched.

JAX replacement for `ORBextractor` (reference:
src/ORBextractor.cc — `operator()` :1068, `ComputePyramid` :1152,
`ComputeKeyPointsOctTree` :763, `DistributeOctTree` :537, `IC_Angle`
:75, `computeOrbDescriptor` :115). Design inversions:

- the quadtree feature distribution becomes grid-cell top-k followed by
  a per-level global top-K (tile-local selection, same uniformity goal,
  no sequential tree);
- IC-angle moments are whole-image separable filters gathered at
  keypoint sites instead of per-keypoint patch loops;
- the descriptor pattern is a seeded Gaussian BRIEF-256 pair set
  (original pattern, NOT the OpenCV learned table) — self-consistent
  within this framework, which builds its own vocabulary;
- descriptors are produced both bit-packed (`[N, 8] uint32`) and as
  ±1 `int8 [N, 256]` so Hamming matching runs as an int8 matmul
  (hamming = (256 - dot)/2).

Outputs are fixed-capacity padded arrays with a validity mask.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.ops import fast as fast_ops
from pli_slam_tpu.ops import image as image_ops
from pli_slam_tpu.utils.config import OrbConfig

PATCH_RADIUS = 15  # IC-angle circular patch (reference HALF_PATCH_SIZE)
EDGE_MARGIN = 19  # keep full rotated BRIEF pattern inside (reference EDGE_THRESHOLD)


def brief_pattern(seed: int = 1234, n_bits: int = 256, sigma: float = 31.0 / 5.0) -> np.ndarray:
    """Seeded Gaussian BRIEF pair pattern: [n_bits, 2, 2] int offsets in [-13, 13]."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -13, 13).astype(np.int32)


_PATTERN = brief_pattern()

# Pool-based BRIEF: the classic pattern needs 2*n_bits random image
# gathers per keypoint (random gathers vectorize poorly; a design choice
# not yet measured on the card). Instead gather a POOL of
# `_POOL_N` rotated sample points once per keypoint and realize the 256
# comparison pairs as two one-hot [256, pool] matmuls over the
# gathered values: 4x fewer gathers, identical steering math. Pairs are
# sampled so both endpoints are distinct and pair displacement keeps the
# BRIEF Gaussian statistics.
_POOL_N = 128


def _brief_pool_and_pairs(seed: int = 1234, n_bits: int = 256, sigma: float = 31.0 / 5.0):
    rng = np.random.default_rng(seed)
    pool = np.clip(np.round(rng.normal(0.0, sigma, size=(_POOL_N, 2))), -13, 13)
    pairs = np.empty((n_bits, 2), np.int32)
    seen = set()
    k = 0
    while k < n_bits:
        a, b = rng.integers(0, _POOL_N, 2)
        if a == b or (a, b) in seen or (b, a) in seen:
            continue
        seen.add((a, b))
        pairs[k] = (a, b)
        k += 1
    return pool.astype(np.float32), pairs


_POOL, _PAIRS = _brief_pool_and_pairs()
_SEL_A = np.eye(_POOL_N, dtype=np.float32)[_PAIRS[:, 0]]  # [256, pool]
_SEL_B = np.eye(_POOL_N, dtype=np.float32)[_PAIRS[:, 1]]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Features:
    """Padded keypoint set in level-0 pixel coordinates."""

    uv: jax.Array  # [N, 2] float32 (x, y) in level-0 coords
    response: jax.Array  # [N] float32
    angle: jax.Array  # [N] float32 radians
    octave: jax.Array  # [N] int32
    scale: jax.Array  # [N] float32 (scale factor of the octave)
    desc: jax.Array  # [N, 256] int8, ±1 (0 rows for invalid)
    valid: jax.Array  # [N] bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))


def level_feature_counts(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric per-level budget (reference: ORBextractor ctor, mnFeaturesPerLevel)."""
    q = 1.0 / scale_factor
    first = n_features * (1 - q) / (1 - q ** n_levels)
    counts = [int(round(first * q ** lvl)) for lvl in range(n_levels)]
    counts[-1] = max(n_features - sum(counts[:-1]), 0)
    return counts


def _ic_angle_maps(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Whole-image intensity-centroid moments m10, m01 over a square patch.

    Square (not circular) support makes the kernels rank-1 separable:
    m10 = (1_y * img) ⊛ x,  m01 = (y ⊛ img) * 1_x — four 31-tap 1-D
    shifted-add passes instead of one 961-tap single-channel 2-D conv.
    The slight anisotropy vs ORB's circular patch is irrelevant here:
    descriptors and vocabulary are self-consistent within this framework.
    """
    r = PATCH_RADIUS
    ones = jnp.ones(2 * r + 1, jnp.float32)
    ramp = jnp.arange(-r, r + 1, dtype=jnp.float32)
    # NOTE on roll direction: _sep_filter computes out[i] = sum_k taps[k] ·
    # img[i - (r - k)] = sum_d taps[r+d] · img[i+d], so taps must be the
    # weight of the NEIGHBOR AT OFFSET +d at index r+d — `ramp` is exactly that.
    col_sum = image_ops._sep_filter(img, ones, -2)  # sum over y-window
    m10 = image_ops._sep_filter(col_sum, ramp, -1)  # weight x-offsets
    row_sum = image_ops._sep_filter(img, ones, -1)
    m01 = image_ops._sep_filter(row_sum, ramp, -2)
    return m10, m01


def _cell_topk_candidates(score: jax.Array, cell: int, k_cell: int):
    """Per-cell top-k over a zero-padded score map [..., H, W] -> flat
    (scores, ys, xs), each [..., nc*k].

    k_cell is small (<=8), so iterative argmax+mask (k_cell elementwise
    passes) replaces `lax.top_k`'s per-row sort (a design choice not yet
    measured on the card).
    """
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    hp = -(-h // cell) * cell
    wp = -(-w // cell) * cell
    pad = [(0, 0)] * len(lead) + [(0, hp - h), (0, wp - w)]
    s = jnp.pad(score, pad)
    ncy, ncx = hp // cell, wp // cell
    cells = (
        s.reshape(lead + (ncy, cell, ncx, cell))
        .swapaxes(-3, -2)
        .reshape(lead + (ncy * ncx, cell * cell))
    )
    nc = ncy * ncx
    col = jnp.arange(cell * cell, dtype=jnp.int32)
    top_s_list, top_i_list = [], []
    for _ in range(k_cell):
        i = jnp.argmax(cells, axis=-1).astype(jnp.int32)
        v = jnp.take_along_axis(cells, i[..., None], axis=-1)[..., 0]
        top_s_list.append(v)
        top_i_list.append(i)
        cells = jnp.where(col == i[..., None], -jnp.inf, cells)
    top_s = jnp.stack(top_s_list, axis=-1)  # [..., nc, k]
    top_i = jnp.stack(top_i_list, axis=-1)
    cy = (jnp.arange(nc, dtype=jnp.int32) // ncx).reshape((1,) * len(lead) + (nc, 1))
    cx = (jnp.arange(nc, dtype=jnp.int32) % ncx).reshape((1,) * len(lead) + (nc, 1))
    ys = cy * cell + top_i // cell
    xs = cx * cell + top_i % cell
    return (
        top_s.reshape(lead + (nc * k_cell,)),
        ys.reshape(lead + (nc * k_cell,)),
        xs.reshape(lead + (nc * k_cell,)),
    )


def _extract_level(img: jax.Array, k_level: int, cfg: OrbConfig):
    """One pyramid level -> (xy [K,2] f32 level coords, response [K], angle [K], valid [K], desc ±1 [K,256])."""
    h, w = img.shape
    score, _ = fast_ops.detect(img, cfg.fast_threshold, cfg.fast_min_threshold)
    # mask border so the rotated descriptor patch stays inside
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN) & (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN)
    score = jnp.where(inside, score, 0.0)

    cell = 32
    n_cells = (-(-h // cell)) * (-(-w // cell))
    k_cell = max(1, min(8, -(-4 * k_level // max(n_cells, 1))))
    cand_s, cand_y, cand_x = _cell_topk_candidates(score, cell, k_cell)
    top_s, top_i = jax.lax.top_k(cand_s, min(k_level, cand_s.shape[0]))
    kx = cand_x[top_i]
    ky = cand_y[top_i]
    valid = top_s > 0.0

    # orientation from intensity-centroid moments
    m10, m01 = _ic_angle_maps(img)
    angle = jnp.arctan2(m01[ky, kx], m10[ky, kx])

    # steered pool-BRIEF on the blurred level: one gather per pool point,
    # pair comparisons realized as one-hot matmuls (see _brief_pool_and_pairs)
    blurred = image_ops.gaussian_blur(img, sigma=2.0, radius=3)
    pool = jnp.asarray(_POOL)  # [P, 2]
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # [K]
    px, py = pool[:, 0], pool[:, 1]  # [P]
    rx = ca[:, None] * px[None] - sa[:, None] * py[None]  # [K, P]
    ry = sa[:, None] * px[None] + ca[:, None] * py[None]
    sx = jnp.clip(jnp.round(kx[:, None] + rx).astype(jnp.int32), 0, w - 1)
    sy = jnp.clip(jnp.round(ky[:, None] + ry).astype(jnp.int32), 0, h - 1)
    vals = blurred[sy, sx]  # [K, P]
    va = jnp.einsum("kp,bp->kb", vals, jnp.asarray(_SEL_A),
                    precision=jax.lax.Precision.HIGHEST)
    vb = jnp.einsum("kp,bp->kb", vals, jnp.asarray(_SEL_B),
                    precision=jax.lax.Precision.HIGHEST)
    bits = va < vb  # [K, 256]
    desc = jnp.where(bits, jnp.int8(1), jnp.int8(-1))
    desc = jnp.where(valid[:, None], desc, jnp.int8(0))

    # pad if the level produced fewer candidates than requested
    k_have = top_s.shape[0]
    if k_have < k_level:
        pad = k_level - k_have
        kx = jnp.pad(kx, (0, pad))
        ky = jnp.pad(ky, (0, pad))
        top_s = jnp.pad(top_s, (0, pad))
        angle = jnp.pad(angle, (0, pad))
        valid = jnp.pad(valid, (0, pad))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
    xy = jnp.stack([kx.astype(jnp.float32), ky.astype(jnp.float32)], axis=-1)
    return xy, top_s, angle, valid, desc


def extract(img: jax.Array, cfg: OrbConfig) -> Features:
    """Full multi-scale ORB extraction. `img` is [H, W] float32 in [0,255].

    Returns fixed-capacity `Features` with capacity == cfg.n_features.
    """
    levels = image_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    counts = level_feature_counts(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    parts = []
    for lvl, (level_img, k_level) in enumerate(zip(levels, counts)):
        if k_level <= 0:
            continue
        xy, resp, angle, valid, desc = _extract_level(level_img, k_level, cfg)
        s = cfg.scale_factor ** lvl
        parts.append(
            (
                xy * s,
                resp,
                angle,
                jnp.full(xy.shape[:1], lvl, jnp.int32),
                jnp.full(xy.shape[:1], s, jnp.float32),
                desc,
                valid,
            )
        )
    uv = jnp.concatenate([p[0] for p in parts], axis=0)
    response = jnp.concatenate([p[1] for p in parts], axis=0)
    angle = jnp.concatenate([p[2] for p in parts], axis=0)
    octave = jnp.concatenate([p[3] for p in parts], axis=0)
    scale = jnp.concatenate([p[4] for p in parts], axis=0)
    desc = jnp.concatenate([p[5] for p in parts], axis=0)
    valid = jnp.concatenate([p[6] for p in parts], axis=0)
    return Features(uv=uv, response=response, angle=angle, octave=octave, scale=scale, desc=desc, valid=valid)


def pack_descriptors(desc_pm1: jax.Array) -> jax.Array:
    """±1 int8 [N, 256] -> packed uint32 [N, 8] (bit i set where desc > 0)."""
    bits = (desc_pm1 > 0).astype(jnp.uint32).reshape(desc_pm1.shape[0], 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)


def unpack_descriptors(packed: jax.Array) -> jax.Array:
    """Packed uint32 [N, 8] -> ±1 int8 [N, 256]."""
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (packed[..., None] >> shifts) & jnp.uint32(1)
    pm1 = jnp.where(bits > 0, jnp.int8(1), jnp.int8(-1))
    return pm1.reshape(packed.shape[0], 256)
