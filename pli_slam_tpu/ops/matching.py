"""Binary-descriptor matching as int8 matmuls with predicate gating.

One kernel family replaces every matcher in the reference:
`ORBmatcher::SearchByProjection/SearchByBoW/SearchForTriangulation/Fuse`
(reference: src/ORBmatcher.cc, include/ORBmatcher.h:46-89) and
`LineMatcher::match/matchNNR/matchGrid` (reference:
src/LineMatcher.cpp:139-398). The reference walks grid buckets per
feature; here the full `[N1, N2]` distance matrix is one int8 matmul —
descriptors are ±1 vectors, so `hamming = (256 - dot) / 2` — and every
search constraint (window radius, epipolar band, scale level, frustum)
becomes a boolean gate added to the distance matrix before the argmin.

Tracking matches N=1200 features against a 4096-row local map, and the
keyframe fuse step against the 16384-row point store: one s8 x s8 -> s32
GEMM each, followed by fusible elementwise gates and row reductions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = jnp.float32(1e9)


def hamming_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Pairwise Hamming distance. d1 [N1,B] int8 ±1, d2 [N2,B] -> [N1,N2] float32.

    Invalid (all-zero) descriptor rows produce distance B/2 (neutral);
    gate them out with masks.
    """
    b = d1.shape[-1]
    dot = jax.lax.dot_general(
        d1, d2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (b - dot).astype(jnp.float32) * 0.5


def match_nn(
    dist: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    gate: jax.Array | None = None,
    max_dist: float = 50.0,
    ratio: float = 1.0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Row-wise nearest neighbor with optional gate and Lowe ratio test.

    dist: [N1, N2]; gate: bool [N1, N2] (True = allowed).
    Returns (idx2 [N1] int32, best_dist [N1], ok [N1] bool).
    ratio < 1 applies best < ratio * second_best (reference mfNNratio).
    """
    d = jnp.where(valid2[None, :], dist, BIG)
    if gate is not None:
        d = jnp.where(gate, d, BIG)
    best_idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    ok = valid1 & (best <= max_dist)
    if ratio < 1.0:
        d2nd = jnp.where(
            jax.nn.one_hot(best_idx, d.shape[1], dtype=bool), BIG, d
        ).min(axis=1)
        ok = ok & (best < ratio * d2nd)
    return best_idx, best, ok


def mutual_consistency(idx12: jax.Array, ok1: jax.Array, dist: jax.Array, valid1: jax.Array, valid2: jax.Array, gate: jax.Array | None = None) -> jax.Array:
    """Keep only mutual best matches: argmin over rows must invert over columns."""
    d = jnp.where(valid1[:, None] & valid2[None, :], dist, BIG)
    if gate is not None:
        d = jnp.where(gate, d, BIG)
    best_for_2 = jnp.argmin(d, axis=0).astype(jnp.int32)  # [N2]
    n1 = dist.shape[0]
    rows = jnp.arange(n1, dtype=jnp.int32)
    return ok1 & (best_for_2[idx12] == rows)


def dedup_matches(idx2: jax.Array, best: jax.Array, ok: jax.Array, n2: int) -> jax.Array:
    """Resolve collisions where several rows matched the same column:
    keep only the row with the smallest distance per column.

    (The reference resolves this with `vnMatches21`/rotation checks in
    SearchForInitialization, ORBmatcher.cc; here it is a segment-min.)
    """
    d = jnp.where(ok, best, BIG)
    col_min = jnp.full((n2,), BIG).at[idx2].min(d)
    return ok & (d <= col_min[idx2])


def window_gate(uv1: jax.Array, uv2: jax.Array, radius: float) -> jax.Array:
    """Spatial window predicate: ||uv1_i - uv2_j|| <= radius. [N1,N2] bool.

    Replaces the reference's `GetFeaturesInArea` grid-bucket lookup
    (src/Frame.cc:530) — the grid existed to cheapen this test on CPU;
    the dense predicate needs no buckets. Expansion
    ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b keeps the [N1,N2] computation a
    single matmul instead of materializing [N1,N2,2].
    """
    cross = jax.lax.dot_general(
        uv1, uv2, dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    n1 = jnp.sum(uv1 * uv1, axis=-1)
    n2 = jnp.sum(uv2 * uv2, axis=-1)
    d2 = n1[:, None] + n2[None, :] - 2.0 * cross
    return d2 <= radius * radius


def row_band_gate(v1: jax.Array, v2: jax.Array, band: float) -> jax.Array:
    """Epipolar row band for rectified stereo: |v1_i - v2_j| <= band."""
    return jnp.abs(v1[:, None] - v2[None, :]) <= band


def scale_gate(octave1: jax.Array, octave2: jax.Array, max_diff: int = 1) -> jax.Array:
    """Scale-consistency predicate (reference checks octave in [o-1, o+1])."""
    return jnp.abs(octave1[:, None] - octave2[None, :]) <= max_diff


def rotation_consistency(
    angle1: jax.Array, angle2: jax.Array, idx2: jax.Array, ok: jax.Array, n_bins: int = 30, top: int = 3
) -> jax.Array:
    """Rotation-histogram filter (reference: ORBmatcher `ComputeThreeMaxima`
    + HISTO_LENGTH voting, src/ORBmatcher.cc): keep matches whose angle
    difference falls in one of the `top` most popular of `n_bins` bins.
    """
    dtheta = angle1 - angle2[idx2]
    dtheta = jnp.mod(dtheta, 2.0 * jnp.pi)
    bins = jnp.clip((dtheta * (n_bins / (2.0 * jnp.pi))).astype(jnp.int32), 0, n_bins - 1)
    counts = jnp.zeros(n_bins, jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top_bins = jax.lax.top_k(counts, top)[1]
    in_top = jnp.any(bins[:, None] == top_bins[None, :], axis=1)
    return ok & in_top


def match_descriptors(
    d1: jax.Array,
    d2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    gate: jax.Array | None = None,
    max_dist: float = 50.0,
    ratio: float = 1.0,
    mutual: bool = True,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Convenience wrapper: hamming -> NN -> (mutual) -> dedup."""
    dist = hamming_matrix(d1, d2)
    idx2, best, ok = match_nn(dist, valid1, valid2, gate, max_dist, ratio)
    if mutual:
        ok = mutual_consistency(idx2, ok, dist, valid1, valid2, gate)
    else:
        ok = dedup_matches(idx2, best, ok, d2.shape[0])
    return idx2, best, ok
