"""Joint visual-inertial initialization (the real 3-stage IMU init).

JAX replacement for `Optimizer::InertialOptimization` (reference:
src/Optimizer.cc:5241-5755 — g2o graph over VertexGDir (2-dof gravity
direction), VertexScale, shared VertexGyroBias/VertexAccBias with
priorG/priorA priors, and per-keyframe VertexVelocity, poses fixed,
EdgeInertialGS factors) as consumed by `LocalMapping::InitializeIMU`
(reference: src/LocalMapping.cc:1154-1335). The whole MAP problem is a
single dense Gauss-Newton over a packed state vector

    x = [ dphi_g (2), log_s (1), bg (3), ba (3), v_0..v_{K-1} (3K) ]

with the 9-dof preintegration residual between consecutive keyframes
(solve/residuals.imu_residual, gravity = Exp([dphi;0]) Rwg0 g0, keyframe
positions scaled by s) plus bias priors. The system is tiny
(K<=32 -> dim<=105), so jacfwd + one dense solve per iteration is
microseconds; everything jits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import imu as imu_ops
from pli_slam_tpu.ops import lie
from pli_slam_tpu.solve import residuals as res
from pli_slam_tpu.utils.config import ImuConfig

_HI = jax.lax.Precision.HIGHEST


def inertial_optimization(
    preint,  # stacked Preintegrated [K-1] chain factors (k -> k+1)
    chain_mask: jax.Array,  # [K-1] bool — factor exists
    R_wb: jax.Array,  # [K,3,3] body rotations from visual SLAM (fixed)
    p_wb: jax.Array,  # [K,3] body positions (fixed up to scale)
    v0: jax.Array,  # [K,3] initial velocities
    Rwg0: jax.Array,  # [3,3] initial gravity-direction rotation
    bg0: jax.Array,
    ba0: jax.Array,
    imu_cfg: ImuConfig,
    prior_g: float = 1e2,
    prior_a: float = 1e6,
    fix_scale: bool = True,
    fix_bias: bool = False,
    iters: int = 15,
):
    """Returns (Rwg [3,3], scale, bg [3], ba [3], v [K,3]).

    gravity_w = Rwg @ [0,0,-gravity]; for mono, map positions should be
    multiplied by `scale` afterwards (reference ApplyScaledRotation,
    src/Map.cc:657 — which the reference forgets to apply to MapLines;
    the tracker-side apply_scale here transforms lines too).
    """
    K = R_wb.shape[0]
    D = 9 + 3 * K
    g0 = jnp.array([0.0, 0.0, -imu_cfg.gravity])
    # per-factor information from preintegration covariance (floored —
    # see solve/vi_ba.py on f32 underflow of near-ideal covariances)
    info = jnp.linalg.inv(preint.cov + jnp.eye(9)[None] * 1e-6)  # [K-1,9,9]
    # weight by sqrt-info via Cholesky so GN sees whitened residuals
    Lw = jnp.linalg.cholesky(info)  # [K-1,9,9], lower

    ks = jnp.arange(K - 1)

    def residuals(x):
        dphi = jnp.concatenate([x[0:2], jnp.zeros(1)])
        Rwg = lie._mm(Rwg0, lie.so3_exp(dphi))
        s = jnp.where(fix_scale, 1.0, jnp.exp(x[2]))
        bg = bg0 + x[3:6]
        ba = ba0 + x[6:9]
        v = x[9:].reshape(K, 3)
        g_w = lie._einsum("ij,j->i", Rwg, g0)

        def factor(k):
            pre_k = jax.tree_util.tree_map(lambda a: a[k], preint)
            r = res.imu_residual(
                pre_k,
                R_wb[k], s * p_wb[k], v[k],
                R_wb[k + 1], s * p_wb[k + 1], v[k + 1],
                bg, ba, g_w,
            )
            return lie._einsum("ij,j->i", Lw[k], r)

        r_chain = jax.vmap(factor)(ks)  # [K-1, 9]
        r_chain = jnp.where(chain_mask[:, None], r_chain, 0.0)
        r_pri = jnp.concatenate([jnp.sqrt(prior_g) * (bg - 0.0), jnp.sqrt(prior_a) * (ba - 0.0)])
        return jnp.concatenate([r_chain.reshape(-1), r_pri])

    def gn_step(x, _):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)  # [R, D]
        H = lie._mm(J.T, J) + 1e-6 * jnp.eye(D)
        g = lie._einsum("ij,j->i", J.T, r)
        if fix_scale:
            H = H.at[2, :].set(0.0).at[:, 2].set(0.0).at[2, 2].set(1.0)
            g = g.at[2].set(0.0)
        if fix_bias:
            # ScaleRefinement mode: bias vertices held at their
            # linearization point (reference fixes them, not priors —
            # Optimizer::InertialOptimization(Map*,Rwg,scale),
            # src/Optimizer.cc:5755)
            for i in range(3, 9):
                H = H.at[i, :].set(0.0).at[:, i].set(0.0).at[i, i].set(1.0)
            g = g.at[3:9].set(0.0)
        dx = -jnp.linalg.solve(H, g)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
        return x + dx, jnp.sum(r * r)

    x0 = jnp.concatenate([jnp.zeros(9), v0.reshape(-1)])
    x, costs = jax.lax.scan(gn_step, x0, None, length=iters)
    dphi = jnp.concatenate([x[0:2], jnp.zeros(1)])
    Rwg = lie._mm(Rwg0, lie.so3_exp(dphi))
    s = jnp.where(fix_scale, 1.0, jnp.exp(x[2]))
    return Rwg, s, bg0 + x[3:6], ba0 + x[6:9], x[9:].reshape(K, 3), costs


def gravity_dir_seed(preint, chain_mask, R_wb, gravity: float):
    """Heuristic gravity direction from summed preintegrated velocity
    deltas (reference LocalMapping.cc:1206-1234): dirG = -sum R_wb dV."""
    dV_w = jnp.einsum("kij,kj->ki", R_wb[:-1], preint.dV, precision=_HI)
    dirG = -jnp.sum(jnp.where(chain_mask[:, None], dV_w, 0.0), axis=0)
    dirG = dirG / jnp.maximum(jnp.linalg.norm(dirG), 1e-9)
    gI = jnp.array([0.0, 0.0, -1.0])
    v = jnp.cross(gI, dirG)
    ang = jnp.arccos(jnp.clip(jnp.dot(gI, dirG), -1.0, 1.0))
    axis = v / jnp.maximum(jnp.linalg.norm(v), 1e-9)
    return lie.so3_exp(axis * ang)  # Rwg: maps gI -> dirG


def velocity_seed(p_wb: jax.Array, stamps: jax.Array) -> jax.Array:
    """Central-difference keyframe velocities from positions."""
    K = p_wb.shape[0]
    a = jnp.clip(jnp.arange(K) - 1, 0, K - 1)
    b = jnp.clip(jnp.arange(K) + 1, 0, K - 1)
    dt = jnp.maximum(stamps[b] - stamps[a], 1e-6)
    return (p_wb[b] - p_wb[a]) / dt[:, None]
