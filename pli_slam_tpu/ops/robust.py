"""Robust weighting and robust statistics.

Reference behavior replaced:
- `robustWeightCauchy` (reference: include/Auxiliar.h:86, used throughout
  the hand-rolled GN pose solver src/Optimizer.cc:8850)
- `vector_stdv_mad` MAD scale estimation (reference: src/Auxiliar.cc,
  used by `removeOutliers` src/Optimizer.cc:1261)
- g2o Huber kernels (reference: Thirdparty/g2o robust_kernel_impl)

All functions support masked, padded inputs (the fixed-shape data model) — pass a
boolean `mask` and padding entries are excluded from statistics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cauchy_weight(r2: jax.Array, c2: float | jax.Array = 1.0) -> jax.Array:
    """IRLS weight for the Cauchy loss, rho(r) = c^2/2 log(1 + r^2/c^2).

    Takes the *squared* residual. w = 1 / (1 + r^2/c^2).
    """
    return 1.0 / (1.0 + r2 / c2)


def huber_weight(r2: jax.Array, delta: float | jax.Array = 1.0) -> jax.Array:
    """IRLS weight for the Huber loss on squared residual r2."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-24))
    return jnp.where(r <= delta, 1.0, delta / r)


def tukey_weight(r2: jax.Array, c: float | jax.Array = 4.685) -> jax.Array:
    u2 = r2 / (c * c)
    w = jnp.where(u2 < 1.0, (1.0 - u2) ** 2, 0.0)
    return w


def masked_median(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Median over mask==True entries of a 1-D array (padding-safe).

    Implemented by sorting with +inf padding and gathering the middle of
    the valid prefix — static shapes, jit-safe.
    """
    n = jnp.sum(mask.astype(jnp.int32))
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    xs = jnp.sort(jnp.where(mask, x, big))
    lo = jnp.maximum((n - 1) // 2, 0)
    hi = jnp.maximum(n // 2, 0)
    med = 0.5 * (xs[lo] + xs[hi])
    return jnp.where(n > 0, med, jnp.zeros_like(med))


def mad_sigma(r: jax.Array, mask: jax.Array) -> jax.Array:
    """Robust scale: 1.4826 * median(|r - median(r)|) over valid entries.

    Reference: `vector_stdv_mad` (src/Auxiliar.cc), consumed with inlier
    factor k (Config::inlierK) in `removeOutliers` (src/Optimizer.cc:1261).
    """
    med = masked_median(r, mask)
    return 1.4826 * masked_median(jnp.abs(r - med), mask)


def mad_inlier_mask(r: jax.Array, mask: jax.Array, k: float = 4.0, min_sigma: float = 1e-4) -> jax.Array:
    """Inlier mask: |r - median| <= k * MAD-sigma (only among valid entries)."""
    med = masked_median(r, mask)
    sigma = jnp.maximum(mad_sigma(r, mask), min_sigma)
    return mask & (jnp.abs(r - med) <= k * sigma)
