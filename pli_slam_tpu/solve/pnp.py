"""Batched P3P/PnP RANSAC for relocalization.

JAX replacement for `MLPnPsolver` (reference: src/MLPnPsolver.cpp
— ML-PnP inside an early-exit RANSAC `iterate` :70, consumed by
Tracking::Relocalization src/Tracking.cc:4223) and the vestigial EPnP
(src/PnPsolver.cc). The sequential RANSAC becomes a fixed hypothesis
batch: each hypothesis aligns 3 world points to their back-projected
camera-frame counterparts via Horn (a closed-form P3P surrogate given a
depth seed), all hypotheses score in parallel, and the winner is
polished by the shared GN pose solver (solve/gn.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import camera as cam_ops
from pli_slam_tpu.ops import lie
from pli_slam_tpu.solve import sim3
from pli_slam_tpu.utils.config import OptimizerConfig

_HI = jax.lax.Precision.HIGHEST


def _sample_probs(mask: jax.Array) -> jax.Array:
    """Hypothesis sampling weights; uniform fallback when the mask is
    all-False (jax.random.choice with an all-zero p is undefined — the
    min_inliers gate rejects whatever the fallback samples produce)."""
    probs = mask.astype(jnp.float32)
    total = probs.sum()
    uniform = jnp.full_like(probs, 1.0 / probs.shape[0])
    return jnp.where(total > 0, probs / jnp.maximum(total, 1e-9), uniform)


def ransac_pnp(
    cam,
    x_w: jax.Array,  # [N,3] world points
    uv: jax.Array,  # [N,2] observed pixels
    depth_seed: jax.Array,  # [N] depth estimates (stereo) for hypothesis lift
    mask: jax.Array,  # [N]
    key: jax.Array,
    n_hypotheses: int = 256,
    inlier_px: float = 4.0,
    min_inliers: int = 15,
):
    """Returns (R_cw, t_cw, inliers [N], n_inliers, ok).

    Hypotheses use the stereo depth seed to lift 2D observations into
    camera-frame 3D, then solve 3-point rigid alignment in closed form
    — each hypothesis costs one 4x4 eigendecomposition, all in parallel.
    """
    n = x_w.shape[0]
    probs = _sample_probs(mask)
    idx = jax.random.choice(key, n, shape=(n_hypotheses, 3), replace=True, p=probs)

    rays = cam_ops.unproject(cam, uv)  # [N,3] z=1
    x_c_seed = rays * depth_seed[:, None]
    xs_w = x_w[idx]  # [H,3,3]
    xs_c = x_c_seed[idx]
    w3 = jnp.ones((n_hypotheses, 3))
    R_h, t_h, _ = sim3.horn_alignment(xs_w, xs_c, w3, with_scale=False)  # world->cam

    # score: reprojection inliers
    xc = jnp.einsum("hij,nj->hni", R_h, x_w, precision=_HI) + t_h[:, None, :]
    uv_p = cam_ops.project(cam, xc)
    err2 = jnp.sum((uv_p - uv[None]) ** 2, axis=-1)
    inl = (err2 < inlier_px * inlier_px) & (xc[..., 2] > 0.05) & mask[None]
    counts = inl.sum(axis=1)
    best = jnp.argmax(counts)
    R_b, t_b = R_h[best], t_h[best]
    inliers = inl[best]
    n_in = counts[best]
    ok = n_in >= min_inliers
    return R_b, t_b, inliers, n_in, ok


def ransac_pnp_dlt(
    cam,
    x_w: jax.Array,  # [N,3] world points
    uv: jax.Array,  # [N,2] observed pixels
    mask: jax.Array,  # [N]
    key: jax.Array,
    n_hypotheses: int = 256,
    inlier_px: float = 4.0,
    min_inliers: int = 15,
):
    """Depth-free PnP RANSAC: 6-point DLT hypotheses, batched.

    The monocular relocalization path (reference MLPnP is mono-native:
    it consumes bearing vectors only, src/MLPnPsolver.cpp, dispatched at
    src/Tracking.cc:4223) — no stereo depth seed exists, so each
    hypothesis solves the projective DLT on 6 2D-3D pairs via SVD
    (12x12), then orthonormalizes the rotation block. All hypotheses
    solve in one batched SVD; the winner is scored by reprojection like
    the stereo path.
    """
    n = x_w.shape[0]
    probs = _sample_probs(mask)
    idx = jax.random.choice(key, n, shape=(n_hypotheses, 6), replace=True, p=probs)

    rays = cam_ops.unproject(cam, uv)  # [N,3] z=1 (normalized image coords)
    X = x_w[idx]  # [H,6,3]
    xn = rays[idx][..., :2]  # [H,6,2] normalized (u,v)
    ones = jnp.ones(X.shape[:2])
    Xh = jnp.concatenate([X, ones[..., None]], axis=-1)  # [H,6,4]
    zero = jnp.zeros_like(Xh)
    # rows: [X 0 -u*X] and [0 X -v*X]  (P stacked as [p1; p2; p3])
    r1 = jnp.concatenate([Xh, zero, -xn[..., 0:1] * Xh], axis=-1)  # [H,6,12]
    r2 = jnp.concatenate([zero, Xh, -xn[..., 1:2] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=1)  # [H,12,12]
    # null vector = right singular vector of smallest singular value
    _, _, vt = jnp.linalg.svd(A)
    p = vt[:, -1, :]  # [H,12]
    P = p.reshape(-1, 3, 4)
    # resolve the projective sign on P ITSELF: the true P has
    # det(M) = s^3 > 0 (M = sR, proper R, positive scale), so flipping P
    # where det(M) < 0 recovers +P_true directly — elementwise-negating
    # R after extraction yields a garbage nearest-rotation (nearest SO(3)
    # to -R is a degenerate 180-degree flip) and wastes ~half the
    # hypotheses
    M = P[:, :, :3]
    sdet = jnp.sign(jnp.linalg.det(M))
    P = P * jnp.where(sdet == 0, 1.0, sdet)[:, None, None]
    M = P[:, :, :3]
    # orthonormalize: M = s R; det(M) > 0 now, so det(U Vt) = +1 and
    # U Vt is the proper rotation with no correction term
    U, S, Vt = jnp.linalg.svd(M)
    R_h = jnp.einsum("hij,hjk->hik", U, Vt, precision=_HI)
    scale = jnp.mean(S, axis=-1)
    t_h = P[:, :, 3] / jnp.maximum(scale, 1e-12)[:, None]

    xc = jnp.einsum("hij,nj->hni", R_h, x_w, precision=_HI) + t_h[:, None, :]
    uv_p = cam_ops.project(cam, xc)
    err2 = jnp.sum((uv_p - uv[None]) ** 2, axis=-1)
    inl = (err2 < inlier_px * inlier_px) & (xc[..., 2] > 0.05) & mask[None]
    counts = inl.sum(axis=1)
    best = jnp.argmax(counts)
    R_b, t_b = R_h[best], t_h[best]
    inliers = inl[best]
    n_in = counts[best]
    ok = n_in >= min_inliers
    return R_b, t_b, inliers, n_in, ok


def solve_pnp(
    cam, x_w, uv, u_right, stereo_mask, depth_seed, sigma2, mask, key,
    opt_cfg: OptimizerConfig | None = None,
    inlier_px: float = 4.0, min_inliers: int = 15,
    mono: bool = False,
):
    """RANSAC + GN polish (the reference's iterate->PoseOptimization loop).

    `inlier_px` must budget for LANDMARK position noise seen from a novel
    viewpoint, not just detector noise — relocalization uses ~2x the
    tracking gate (the reference's per-octave chi2 scaling plays the
    same role, src/MLPnPsolver.h:65 RANSAC parameters)."""
    from pli_slam_tpu.solve import gn

    opt_cfg = opt_cfg or OptimizerConfig()
    if mono:
        R0, t0, inl, n_in, ok = ransac_pnp_dlt(
            cam, x_w, uv, mask, key,
            inlier_px=inlier_px, min_inliers=min_inliers,
        )
    else:
        R0, t0, inl, n_in, ok = ransac_pnp(
            cam, x_w, uv, depth_seed, mask, key,
            inlier_px=inlier_px, min_inliers=min_inliers,
        )
    n_l = 8
    # the polish must model the ASSOCIATION noise the RANSAC gate
    # accepted (landmark position error seen from a novel viewpoint),
    # not the ~1 px detector noise — otherwise the robust weights treat
    # every genuine inlier as an outlier and the GN wanders off the
    # RANSAC optimum
    sigma2_eff = sigma2 * jnp.maximum((inlier_px / 2.0) ** 2, 1.0)
    obs = gn.PoseObservations(
        x_w=x_w,
        uvr=jnp.concatenate([uv, u_right[:, None]], axis=-1),
        stereo_mask=stereo_mask,
        point_mask=inl,
        sigma2_pt=sigma2_eff,
        xs_w=jnp.zeros((n_l, 3)), xe_w=jnp.zeros((n_l, 3)),
        l_obs=jnp.zeros((n_l, 3)), line_mask=jnp.zeros(n_l, bool),
        sigma2_ln=jnp.ones(n_l),
    )
    res = gn.solve_pose(cam, obs, R0, t0, opt_cfg)
    return res.R_cw, res.t_cw, res.inlier_pt, res.n_inliers, ok
