"""Frame-pose Gauss-Newton solver over point + line residuals.

JAX replacement for the reference's hand-rolled GN pose pipeline
(reference: src/Optimizer.cc — `PoseOptimizationWithLine` :1086-1259,
`optimizeFunctions` :8719-8877, `gaussNewtonOptimization` :8569,
`removeOutliers` :1261-1395) and the g2o `PoseOptimization` :770.

The reference's pipeline — GN rounds interleaved with MAD-based
outlier reclassification, Cauchy robust weights, fixed iteration
budgets — is kept semantically, but everything runs as one jitted
device program: fixed-size padded observation arrays, masked
reductions, `fori_loop`s with static trip counts, and a 6x6 dense
solve per iteration. No data-dependent control flow.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import lie, robust
from pli_slam_tpu.solve import residuals as res
from pli_slam_tpu.utils.config import OptimizerConfig

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseObservations:
    """Padded per-frame observations against the map.

    Points: world position + (u, v, u_r) measurement; `stereo_mask`
    selects rows whose u_r is meaningful (-1 slots in the reference's
    mvuRight). Lines: world endpoints + normalized observed image line.
    `sigma2_*`: per-feature measurement variance (scale-dependent, the
    reference's mvInvLevelSigma2).
    """

    x_w: jax.Array  # [P,3]
    uvr: jax.Array  # [P,3]
    stereo_mask: jax.Array  # [P] bool
    point_mask: jax.Array  # [P] bool
    sigma2_pt: jax.Array  # [P]
    xs_w: jax.Array  # [L,3]
    xe_w: jax.Array  # [L,3]
    l_obs: jax.Array  # [L,3]
    line_mask: jax.Array  # [L] bool
    sigma2_ln: jax.Array  # [L]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseResult:
    R_cw: jax.Array
    t_cw: jax.Array
    inlier_pt: jax.Array  # [P] bool
    inlier_ln: jax.Array  # [L] bool
    n_inliers: jax.Array  # [] int32 (points + lines)
    cost: jax.Array  # [] final robust cost


def _accumulate(cam, R, t, obs: PoseObservations, pt_mask, ln_mask, cauchy_c2: float):
    """One linearization: robust H [6,6], g [6], cost, per-feature chi2."""
    r_pt, J_pt, x_c = res.point_residuals_stereo(cam, R, t, obs.x_w, obs.uvr)
    # zero the u_r row where no stereo measurement
    row_mask = jnp.stack(
        [jnp.ones_like(obs.stereo_mask), jnp.ones_like(obs.stereo_mask), obs.stereo_mask],
        axis=-1,
    ).astype(r_pt.dtype)
    r_pt = r_pt * row_mask
    J_pt = J_pt * row_mask[..., None]
    behind = x_c[..., 2] <= 0.05
    m_pt = pt_mask & obs.point_mask & ~behind
    chi2_pt = jnp.sum(r_pt * r_pt, axis=-1) / obs.sigma2_pt
    w_pt = robust.cauchy_weight(chi2_pt, cauchy_c2) / obs.sigma2_pt
    w_pt = jnp.where(m_pt, w_pt, 0.0)

    r_ln, J_ln, aux = res.line_residuals(cam, R, t, obs.xs_w, obs.xe_w, obs.l_obs)
    xs_c, xe_c = aux[0], aux[1]
    behind_ln = (xs_c[..., 2] <= 0.05) | (xe_c[..., 2] <= 0.05)
    m_ln = ln_mask & obs.line_mask & ~behind_ln
    chi2_ln = jnp.sum(r_ln * r_ln, axis=-1) / obs.sigma2_ln
    w_ln = robust.cauchy_weight(chi2_ln, cauchy_c2) / obs.sigma2_ln
    w_ln = jnp.where(m_ln, w_ln, 0.0)

    H = (
        jnp.einsum("nij,n,nik->jk", J_pt, w_pt, J_pt, precision=_HI)
        + jnp.einsum("nij,n,nik->jk", J_ln, w_ln, J_ln, precision=_HI)
    )
    g = (
        jnp.einsum("nij,n,ni->j", J_pt, w_pt, r_pt, precision=_HI)
        + jnp.einsum("nij,n,ni->j", J_ln, w_ln, r_ln, precision=_HI)
    )
    cost = jnp.sum(w_pt * chi2_pt * obs.sigma2_pt) + jnp.sum(w_ln * chi2_ln * obs.sigma2_ln)
    return H, g, cost, chi2_pt, chi2_ln, m_pt, m_ln


def _gn_iterations(cam, R, t, obs, pt_mask, ln_mask, iters: int, cauchy_c2: float, damping: float):
    def body(_, carry):
        R, t = carry
        H, g, _, _, _, _, _ = _accumulate(cam, R, t, obs, pt_mask, ln_mask, cauchy_c2)
        H = H + damping * jnp.eye(6)
        # r = obs - pred, J = dr/ddelta  =>  delta = -H^{-1} J^T W r
        delta = -jnp.linalg.solve(H, g)
        # guard: reject non-finite or huge steps
        bad = ~jnp.all(jnp.isfinite(delta)) | (jnp.linalg.norm(delta) > 1.0)
        delta = jnp.where(bad, jnp.zeros_like(delta), delta)
        dR, dt = lie.se3_exp(delta)
        R_new = lie.normalize_rotation(lie._mm(dR, R))
        t_new = lie._einsum("ij,j->i", dR, t) + dt
        return R_new, t_new

    R, t = jax.lax.fori_loop(0, iters, body, (R, t))
    return R, t


def solve_pose(
    cam,
    obs: PoseObservations,
    R0: jax.Array,
    t0: jax.Array,
    cfg: OptimizerConfig,
    cauchy_c2: float = 5.991,
) -> PoseResult:
    """Reference pipeline (src/Optimizer.cc:1146-1163): GN -> MAD outlier
    rejection -> GN -> ... -> refinement iterations, all statically unrolled.
    """
    R, t = R0, t0
    pt_mask = jnp.ones(obs.point_mask.shape, bool)
    ln_mask = jnp.ones(obs.line_mask.shape, bool)

    for _ in range(cfg.pose_rounds - 1):
        R, t = _gn_iterations(cam, R, t, obs, pt_mask, ln_mask, cfg.pose_gn_iters, cauchy_c2, cfg.damping_init)
        _, _, _, chi2_pt, chi2_ln, m_pt, m_ln = _accumulate(cam, R, t, obs, pt_mask, ln_mask, cauchy_c2)
        # MAD gate on residual magnitudes among currently-valid features
        r_pt = jnp.sqrt(jnp.maximum(chi2_pt, 0.0))
        r_ln = jnp.sqrt(jnp.maximum(chi2_ln, 0.0))
        # keep a feature if it passes the MAD gate, or rescue it when its
        # chi2 is below the absolute threshold (MAD sigma can collapse
        # when almost everything agrees)
        pt_mask = robust.mad_inlier_mask(r_pt, m_pt, cfg.mad_k) | (m_pt & (chi2_pt < cauchy_c2))
        ln_mask = robust.mad_inlier_mask(r_ln, m_ln, cfg.mad_k) | (m_ln & (chi2_ln < cauchy_c2))

    R, t = _gn_iterations(cam, R, t, obs, pt_mask, ln_mask, cfg.pose_gn_iters_refine, cauchy_c2, cfg.damping_init)
    _, _, cost, chi2_pt, chi2_ln, m_pt, m_ln = _accumulate(cam, R, t, obs, pt_mask, ln_mask, cauchy_c2)
    inlier_pt = m_pt & (chi2_pt < cauchy_c2)
    inlier_ln = m_ln & (chi2_ln < 7.815)
    n = jnp.sum(inlier_pt.astype(jnp.int32)) + jnp.sum(inlier_ln.astype(jnp.int32))
    return PoseResult(R_cw=R, t_cw=t, inlier_pt=inlier_pt, inlier_ln=inlier_ln, n_inliers=n, cost=cost)
