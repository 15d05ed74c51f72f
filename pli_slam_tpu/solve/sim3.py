"""Closed-form Sim3/SE3 from 3D-3D correspondences + batched RANSAC.

JAX replacement for `Sim3Solver` (reference: src/Sim3Solver.cc —
Horn's closed form `ComputeSim3` :316 inside an early-exit RANSAC
`iterate` :152). The sequential RANSAC becomes a fixed batch of
hypotheses evaluated in parallel (SURVEY.md §7.3 item 6): H hypothesis
triplets are sampled with a fold-in-seed, all Horn solutions computed by
one batched SVD-free quaternion method, and all inlier counts reduced at
once; the best hypothesis is refined on its inliers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import lie

_HI = jax.lax.Precision.HIGHEST


def horn_alignment(x: jax.Array, y: jax.Array, w: jax.Array, with_scale: bool = True):
    """Weighted closed-form alignment y ~ s R x + t over [..., N, 3] sets.

    Horn's quaternion method (as in the reference) via the 4x4 N-matrix
    eigenvector; batched over leading dims. Degenerate inputs (all
    weights ~0) return identity.
    """
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-9)
    mu_x = jnp.sum(x * wn[..., None], axis=-2)
    mu_y = jnp.sum(y * wn[..., None], axis=-2)
    xc = x - mu_x[..., None, :]
    yc = y - mu_y[..., None, :]
    S = jnp.einsum("...ni,...n,...nj->...ij", xc, wn, yc, precision=_HI)  # covariance x->y
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            jnp.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            jnp.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            jnp.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        axis=-2,
    )
    # largest eigenvector of the symmetric 4x4 N
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[..., :, -1]  # (w, x, y, z) ordering matches our quat layout
    R = lie.rotation_from_quat(q)
    if with_scale:
        num = jnp.einsum("...ni,...n,...ni->...", jnp.einsum("...ij,...nj->...ni", R, xc, precision=_HI), wn, yc, precision=_HI)
        den = jnp.einsum("...ni,...n,...ni->...", xc, wn, xc, precision=_HI)
        s = num / jnp.maximum(den, 1e-12)
        s = jnp.where(jnp.isfinite(s) & (s > 1e-3), s, 1.0)
    else:
        s = jnp.ones(R.shape[:-2])
    t = mu_y - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_x, precision=_HI)
    return R, t, s


def ransac_sim3(
    x: jax.Array,  # [N,3] points in frame A
    y: jax.Array,  # [N,3] corresponding points in frame B
    mask: jax.Array,  # [N] bool valid correspondences
    key: jax.Array,
    n_hypotheses: int = 256,
    inlier_thresh: float = 0.2,
    with_scale: bool = True,
):
    """Batched-hypothesis RANSAC. Returns (R, t, s, inliers [N] bool, n_inliers).

    All hypotheses are 3-point Horn solutions scored in parallel; the
    winner is refined once on its inliers (the reference refines via
    ComputeSim3 on the consensus set too).
    """
    n = x.shape[0]
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-9)
    idx = jax.random.choice(key, n, shape=(n_hypotheses, 3), replace=True, p=probs)
    xs = x[idx]  # [H,3,3]
    ys = y[idx]
    w3 = jnp.ones((n_hypotheses, 3))
    R, t, s = horn_alignment(xs, ys, w3, with_scale)  # batched over H

    # score every hypothesis against all correspondences
    pred = s[:, None, None] * jnp.einsum("hij,nj->hni", R, x, precision=_HI) + t[:, None, :]
    err = jnp.linalg.norm(pred - y[None], axis=-1)  # [H, N]
    inl = (err < inlier_thresh) & mask[None, :]
    counts = inl.sum(axis=1)
    best = jnp.argmax(counts)

    # refinement on the winning consensus set
    w_ref = inl[best].astype(jnp.float32)
    R_b, t_b, s_b = horn_alignment(x, y, w_ref, with_scale)
    pred_b = s_b * jnp.einsum("ij,nj->ni", R_b, x, precision=_HI) + t_b
    err_b = jnp.linalg.norm(pred_b - y, axis=-1)
    inliers = (err_b < inlier_thresh) & mask
    # guard: if refinement somehow lost the consensus, keep the raw best
    better = inliers.sum() >= counts[best]
    R_f = jnp.where(better, R_b, R[best])
    t_f = jnp.where(better, t_b, t[best])
    s_f = jnp.where(better, s_b, s[best])
    inl_f = jnp.where(better, inliers, inl[best])
    return R_f, t_f, s_f, inl_f, inl_f.sum()
