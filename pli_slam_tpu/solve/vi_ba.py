"""Visual-inertial windowed bundle adjustment (LocalInertialBA).

JAX replacement for `Optimizer::LocalInertialBA` (reference:
src/Optimizer.cc:4547 — temporal window of <=10/25 keyframes chained by
`mPrevKF` EdgeInertial factors + visual edges, solved by g2o). Here the
per-pose state is 15-dof (T_cw twist ⊕ velocity ⊕ gyro bias ⊕ accel
bias); landmarks are eliminated exactly as in solve/ba.py (they couple
only to the 6-dof pose part — the shared `assemble_visual` produces the
reduced camera system), and the preintegration + bias-random-walk
factors between consecutive window keyframes add pose-pose blocks to
the dense reduced system [15W, 15W] — still tiny (W<=10 -> 150^2).

Visual Jacobians are the analytic ones from solve/ba.py; each IMU factor
is a 15-dim residual `jacfwd`-ed over its two poses' 30 state dofs
(vmapped over the chain). Both parts share the same left-multiplicative
T_cw twist parametrization; the IMU factor converts camera->body through
the fixed body-camera extrinsics T_cb (reference ImuCamPose,
src/G2oTypes.cc) inside the residual, so the chain rule to the camera
twist is handled by the same jacfwd.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import imu as imu_ops
from pli_slam_tpu.ops import lie
from pli_slam_tpu.solve import ba as ba_mod
from pli_slam_tpu.utils.config import ImuConfig, OptimizerConfig

_HI = jax.lax.Precision.HIGHEST
_DEBUG_CAPTURE = None  # set to a dict to capture the last solve (tests/debug)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VIBAProblem:
    """BAProblem + per-pose inertial state + chain preintegrations."""

    base: ba_mod.BAProblem
    v: jax.Array  # [W,3] world velocities
    bg: jax.Array  # [W,3]
    ba: jax.Array  # [W,3]
    preint: imu_ops.Preintegrated  # stacked [W-1, ...] chain factors
    imu_mask: jax.Array  # [W-1] bool — factor between k and k+1 valid
    gravity_w: jax.Array  # [3]
    R_cb: jax.Array  # [3,3] body->camera rotation (Extrinsics)
    t_cb: jax.Array  # [3]


def _imu_chain_residual(prob: VIBAProblem, R, t, v, bg, ba_, k, delta_i, delta_j, imu_cfg: ImuConfig):
    """15-dim residual of chain factor k under state perturbations."""

    def perturb(Rk, tk, vk, bgk, bak, d):
        dR, dt = lie.se3_exp(d[:6])
        R2 = lie._mm(dR, Rk)
        t2 = lie._einsum("ij,j->i", dR, tk) + dt
        return R2, t2, vk + d[6:9], bgk + d[9:12], bak + d[12:15]

    Ri, ti, vi, bgi, bai = perturb(R[k], t[k], v[k], bg[k], ba_[k], delta_i)
    Rj, tj, vj, bgj, baj = perturb(R[k + 1], t[k + 1], v[k + 1], bg[k + 1], ba_[k + 1], delta_j)
    # camera -> body through T_cb: R_wb = R_cw^T R_cb, p = R_cw^T (t_cb - t_cw)
    Rwi = lie._mm(Ri.T, prob.R_cb)
    pwi = lie._einsum("ij,j->i", Ri.T, prob.t_cb - ti)
    Rwj = lie._mm(Rj.T, prob.R_cb)
    pwj = lie._einsum("ij,j->i", Rj.T, prob.t_cb - tj)
    pre_k = jax.tree_util.tree_map(lambda x: x[k], prob.preint)
    from pli_slam_tpu.solve import residuals as res

    r_imu = res.imu_residual(pre_k, Rwi, pwi, vi, Rwj, pwj, vj, bgi, bai, prob.gravity_w)
    r_bg = bgj - bgi
    r_ba = baj - bai
    return jnp.concatenate([r_imu, r_bg, r_ba])


def vi_ba_iteration(cam, prob: VIBAProblem, idx_p, idx_l, R, t, v, bg, ba_, pts, lns,
                    cfg: OptimizerConfig, imu_cfg: ImuConfig, damping):
    base = prob.base
    W = R.shape[0]
    D = 15

    # ---- visual part: shared scatter-free assembly from solve/ba.py -----
    (S6, rhs6, (Hll_p_inv, gl_p, Wb_p, active_p), (Hll_l_inv, gl_l, Wb_l, active_l),
     _cost, chi2_p, chi2_l) = ba_mod.assemble_visual(
        cam, base, idx_p, idx_l, R, t, pts, lns, cfg, damping
    )

    # ---- lift to the 15-dof system --------------------------------------
    S = jnp.zeros((W, W, D, D))
    S = S.at[:, :, :6, :6].set(S6)
    rhs = jnp.zeros((W, D)).at[:, :6].set(rhs6)

    # ---- IMU chain factors ----------------------------------------------
    dtk = jnp.maximum(prob.preint.dt, 1e-3)  # [W-1]
    # covariance floor: ideal/short-window preintegration covariances
    # underflow float32 to ~0; unfloored information (~1e8+) swamps the
    # visual blocks and destroys the f32 solve
    info_imu = jnp.linalg.inv(prob.preint.cov + jnp.eye(9)[None] * 1e-6)  # [W-1,9,9]
    info_bg = jnp.eye(3)[None] / (imu_cfg.walk_gyro ** 2 * dtk)[:, None, None]
    info_ba = jnp.eye(3)[None] / (imu_cfg.walk_acc ** 2 * dtk)[:, None, None]

    z15 = jnp.zeros(15)

    def one_factor(k):
        r0 = _imu_chain_residual(prob, R, t, v, bg, ba_, k, z15, z15, imu_cfg)
        Ji = jax.jacfwd(lambda d: _imu_chain_residual(prob, R, t, v, bg, ba_, k, d, z15, imu_cfg))(z15)
        Jj = jax.jacfwd(lambda d: _imu_chain_residual(prob, R, t, v, bg, ba_, k, z15, d, imu_cfg))(z15)
        return r0, Ji, Jj

    ks = jnp.arange(W - 1)
    r_f, Ji_f, Jj_f = jax.vmap(one_factor)(ks)  # [W-1,15], [W-1,15,15] x2
    info = jnp.zeros((W - 1, 15, 15))
    info = info.at[:, :9, :9].set(info_imu)
    info = info.at[:, 9:12, 9:12].set(info_bg)
    info = info.at[:, 12:15, 12:15].set(info_ba)
    wmask = prob.imu_mask.astype(jnp.float32)[:, None, None]
    info = info * wmask

    Hii = jnp.einsum("kai,kab,kbj->kij", Ji_f, info, Ji_f, precision=_HI)
    Hjj = jnp.einsum("kai,kab,kbj->kij", Jj_f, info, Jj_f, precision=_HI)
    Hij = jnp.einsum("kai,kab,kbj->kij", Ji_f, info, Jj_f, precision=_HI)
    gi = jnp.einsum("kai,kab,kb->ki", Ji_f, info, r_f, precision=_HI)
    gj = jnp.einsum("kai,kab,kb->ki", Jj_f, info, r_f, precision=_HI)
    S = S.at[ks, ks].add(Hii)
    S = S.at[ks + 1, ks + 1].add(Hjj)
    S = S.at[ks, ks + 1].add(Hij)
    S = S.at[ks + 1, ks].add(jnp.swapaxes(Hij, -1, -2))
    rhs = rhs.at[ks].add(-gi)
    rhs = rhs.at[ks + 1].add(-gj)

    # ---- gauge + damping + solve ----------------------------------------
    # Fix only the POSE dofs (cols 0:6) of gauge/boundary keyframes;
    # their velocities and biases stay free — hard-fixing them anchors
    # the whole velocity chain to the boundary value through the r_v
    # factors (the reference's marginalization prior plays this role).
    eyeD = jnp.eye(D)
    exists = base.pose_mask.astype(S.dtype)
    pose_free = (base.pose_mask & ~base.fixed_mask).astype(S.dtype)
    dof_free = jnp.concatenate(
        [jnp.tile(pose_free[:, None], (1, 6)), jnp.tile(exists[:, None], (1, 9))], axis=1
    )  # [W, D]
    S = S * dof_free[:, None, :, None] * dof_free[None, :, None, :]
    # soft priors on the boundary keyframes' inertial states (the
    # reference's EdgePriorPoseImu / marginalization prior): stiff enough
    # to suppress weakly-observable common-mode drift, soft enough to let
    # genuinely observed corrections through
    prior = jnp.concatenate(
        [jnp.zeros(6), jnp.full(3, 1e2), jnp.full(9 - 3, 1e4)]
    )  # [D]: v info 1e2, bias info 1e4
    fixed_f = (base.fixed_mask & base.pose_mask).astype(S.dtype)
    S = S.at[jnp.arange(W), jnp.arange(W)].add(
        jnp.eye(D)[None] * ((1.0 - dof_free)[:, None, :] + fixed_f[:, None, None] * prior[None, None, :])
        + damping * eyeD
    )
    rhs = rhs * dof_free

    Sd = S.transpose(0, 2, 1, 3).reshape(W * D, W * D)
    # Jacobi equilibration: the IMU information blocks sit ~5 orders of
    # magnitude above the visual ones; rescaling to unit diagonal keeps
    # the f32 Cholesky meaningful
    dscale = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
    Sd_eq = Sd * dscale[:, None] * dscale[None, :]
    rhs_eq = rhs.reshape(-1) * dscale
    delta = (jnp.linalg.solve(Sd_eq, rhs_eq) * dscale).reshape(W, D)
    if _DEBUG_CAPTURE is not None:
        _DEBUG_CAPTURE.update(Sd=Sd, rhs=rhs, delta=delta)
    bad = ~jnp.all(jnp.isfinite(delta))
    delta = jnp.where(bad, 0.0, delta)
    # trust-region style guard: clamp outsized steps (GN can overshoot
    # along weakly-observable inertial directions)
    step_norm = jnp.linalg.norm(delta, axis=-1, keepdims=True)
    delta = delta * jnp.minimum(1.0, 3.0 / jnp.maximum(step_norm, 1e-9))

    # ---- back-substitute landmarks (6-dof part only) ---------------------
    dp6 = delta[:, :6]
    delta_pt = ba_mod.back_substitute(Wb_p, Hll_p_inv, gl_p, dp6)
    delta_ln = ba_mod.back_substitute(Wb_l, Hll_l_inv, gl_l, dp6)
    delta_pt = jnp.where(bad, 0.0, delta_pt)
    delta_ln = jnp.where(bad, 0.0, delta_ln)

    dR, dt = lie.se3_exp(dp6)
    R_new = lie.normalize_rotation(jnp.einsum("wij,wjk->wik", dR, R, precision=_HI))
    t_new = jnp.einsum("wij,wj->wi", dR, t, precision=_HI) + dt
    v_new = v + delta[:, 6:9]
    bg_new = bg + delta[:, 9:12]
    ba_new = ba_ + delta[:, 12:15]
    pts_new = pts + jnp.where(active_p[:, None], delta_pt, 0.0)
    lns_new = lns + jnp.where(active_l[:, None], delta_ln, 0.0)
    return R_new, t_new, v_new, bg_new, ba_new, pts_new, lns_new


def solve_vi_ba(cam, prob: VIBAProblem, cfg: OptimizerConfig, imu_cfg: ImuConfig, iters: int | None = None):
    """Fixed-iteration damped GN over the visual-inertial window."""
    iters = cfg.local_ba_iters if iters is None else iters
    damping = jnp.asarray(cfg.damping_init, jnp.float32)
    idx_p, idx_l = ba_mod.prepare_indices(prob.base)

    def body(_, carry):
        R, t, v, bg, ba_, pts, lns = carry
        return vi_ba_iteration(cam, prob, idx_p, idx_l, R, t, v, bg, ba_, pts, lns, cfg, imu_cfg, damping)

    init = (prob.base.R, prob.base.t, prob.v, prob.bg, prob.ba, prob.base.pts, prob.base.lns)
    R, t, v, bg, ba_, pts, lns = jax.lax.fori_loop(0, iters, body, init)
    return R, t, v, bg, ba_, pts, lns
