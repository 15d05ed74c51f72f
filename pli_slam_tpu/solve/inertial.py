"""Visual-inertial state estimation: inertial frame-pose solve and IMU init.

JAX replacement for the reference's inertial optimizers
(reference: src/Optimizer.cc — `PoseInertialOptimizationLastKeyFrame`
:7425, `PoseInertialOptimizationLastFrame` :7820, `InertialOptimization`
overloads :5241-5755) built on the custom g2o types (VertexPose/
Velocity/GyroBias/AccBias, EdgeInertial — src/G2oTypes.h:127-632).

State per frame: body pose (R_wb, p_w), velocity v_w, biases (bg, ba).
The previous state is fixed (marginalized into the factor), matching
the reference's ...LastFrame/...LastKeyFrame structure. Residuals:

- stereo/mono point reprojection through fixed body->camera extrinsics
  T_cb (reference ImuCamPose);
- line endpoint-to-line residuals;
- the 9-dof preintegration factor (solve/residuals.imu_residual);
- bias random-walk to the previous bias (EdgeGyroRW/EdgeAccRW).

Visual Jacobians are analytic; the (tiny) IMU factor block uses
`jax.jacfwd`. GN iterations are fixed-count and fully jitted.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import camera as cam_ops
from pli_slam_tpu.ops import imu as imu_ops
from pli_slam_tpu.ops import lie, robust
from pli_slam_tpu.solve.gn import PoseObservations
from pli_slam_tpu.utils.config import ImuConfig, OptimizerConfig

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BodyState:
    """Body state in world frame (reference Frame/KeyFrame IMU fields)."""

    R_wb: jax.Array  # [3,3]
    p_w: jax.Array  # [3]
    v_w: jax.Array  # [3]
    bg: jax.Array  # [3]
    ba: jax.Array  # [3]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Extrinsics:
    """Body->camera transform T_cb (reference IMU::Calib Tbc inverse)."""

    R_cb: jax.Array  # [3,3]
    t_cb: jax.Array  # [3]

    @staticmethod
    def identity() -> "Extrinsics":
        return Extrinsics(R_cb=jnp.eye(3), t_cb=jnp.zeros(3))

    @staticmethod
    def from_Tbc(Tbc) -> "Extrinsics":
        """From the body->camera transform T_bc (reference IMU::Calib Tbc,
        parsed in src/Tracking.cc:761): T_cb = T_bc^-1. Accepts a 4x4
        array or 16 row-major floats; None means identity."""
        if Tbc is None:
            return Extrinsics.identity()
        T = jnp.asarray(Tbc, jnp.float32).reshape(4, 4)
        R_bc = T[:3, :3]
        t_bc = T[:3, 3]
        return Extrinsics(R_cb=R_bc.T, t_cb=-lie._einsum("ij,j->i", R_bc.T, t_bc))


def body_state_from_camera(R_cw, t_cw, v_w, bg, ba, ext: "Extrinsics") -> "BodyState":
    """Invert camera_pose(): recover the body state from T_cw + T_cb."""
    R_wb = lie._mm(R_cw.T, ext.R_cb)
    p_w = lie._einsum("ij,j->i", R_cw.T, ext.t_cb - t_cw)
    return BodyState(R_wb=R_wb, p_w=p_w, v_w=v_w, bg=bg, ba=ba)


def camera_pose(state: BodyState, ext: Extrinsics) -> tuple[jax.Array, jax.Array]:
    """T_cw from body state: x_c = R_cb R_bw (x_w - p_w) + t_cb."""
    R_bw = state.R_wb.T
    R_cw = lie._mm(ext.R_cb, R_bw)
    t_cw = ext.t_cb - lie._einsum("ij,j->i", R_cw, state.p_w)
    return R_cw, t_cw


def _state_from_delta(state: BodyState, delta: jax.Array) -> BodyState:
    """Right-multiplicative update on rotation; additive on the rest.

    delta = [dphi(3), dp(3), dv(3), dbg(3), dba(3)] — 15 dof.
    """
    return BodyState(
        R_wb=lie._mm(state.R_wb, lie.so3_exp(delta[0:3])),
        p_w=state.p_w + delta[3:6],
        v_w=state.v_w + delta[6:9],
        bg=state.bg + delta[9:12],
        ba=state.ba + delta[12:15],
    )


def solve_pose_inertial(
    cam,
    ext: Extrinsics,
    obs: PoseObservations,
    preint: imu_ops.Preintegrated,
    prev: BodyState,
    init: BodyState,
    opt_cfg: OptimizerConfig,
    imu_cfg: ImuConfig,
    cauchy_c2: float = 5.991,
    gravity_w=None,  # world gravity vector [3]; default magnitude along -z
):
    """GN over the 15-dof current state with the previous state fixed.

    Returns (state, inlier_pt, inlier_ln, n_inliers).
    """
    grav = imu_cfg.gravity if gravity_w is None else gravity_w
    # IMU factor information from the preintegration covariance PLUS the
    # previous state's uncertainty. The previous frame is an ESTIMATE
    # (visual accuracy ~mm / ~0.1 deg, velocity ~cm/s), not ground truth:
    # with the raw 45 ms preintegration covariance (~1e-10) the factor
    # freezes the pose at the IMU prediction and vision can never
    # correct it — prediction error then compounds frame over frame
    # until matching dies (observed on fast trajectories). The reference
    # gets the same softening through its 15-dim marginalization prior
    # on the previous frame (EdgePriorPoseImu / ConstraintPoseImu,
    # include/G2oTypes.h:703): here the prior is folded into the factor
    # covariance as fixed floors on the (phi, v, p) blocks.
    s_phi2 = imu_cfg.prev_sigma_rot ** 2
    s_v2 = imu_cfg.prev_sigma_vel ** 2
    s_p2 = imu_cfg.prev_sigma_pos ** 2
    prev_floor = jnp.diag(jnp.asarray([s_phi2] * 3 + [s_v2] * 3 + [s_p2] * 3))
    cov = preint.cov + prev_floor + jnp.eye(9) * 1e-8
    info_imu = jnp.linalg.inv(cov)
    # bias random-walk information (reference EdgeGyroRW/AccRW)
    dt = jnp.maximum(preint.dt, 1e-3)
    info_bg = jnp.eye(3) / (imu_cfg.walk_gyro ** 2 * dt)
    info_ba = jnp.eye(3) / (imu_cfg.walk_acc ** 2 * dt)

    def visual_terms(state: BodyState, pt_mask, ln_mask):
        from pli_slam_tpu.solve import residuals as res

        R_cw, t_cw = camera_pose(state, ext)
        r_pt, J_pt_cam, x_c = res.point_residuals_stereo(cam, R_cw, t_cw, obs.x_w, obs.uvr)
        row = jnp.stack(
            [jnp.ones_like(obs.stereo_mask), jnp.ones_like(obs.stereo_mask), obs.stereo_mask],
            axis=-1,
        ).astype(r_pt.dtype)
        r_pt = r_pt * row
        J_pt_cam = J_pt_cam * row[..., None]
        # chain rule: camera-twist Jacobian -> body-state (phi, p) Jacobian.
        # d x_c/d dphi = R_cb R_bw ( -R_wb hat(..)..) — derive via x_c(state):
        # x_c = R_cb R_bw (x_w - p); with R_wb <- R_wb Exp(dphi):
        #   d x_c/d dphi = R_cb d(Exp(-dphi) R_bw (x_w - p)) = R_cb hat(R_bw (x_w-p)) ...
        # Use the identity: d x_c / d dphi = R_cb * hat(b) where b = R_bw (x_w - p)
        # and d x_c / d dp = -R_cb R_bw.
        b = lie._einsum("ij,nj->ni", state.R_wb.T, obs.x_w - state.p_w)
        Jp2 = cam_ops.project_jacobian(cam, x_c)
        z = x_c[..., 2]
        inv_z2 = 1.0 / jnp.maximum(z * z, 1e-12)
        Jr_row = Jp2[..., 0, :] + jnp.stack(
            [jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * inv_z2], axis=-1
        )
        Jproj = jnp.concatenate([Jp2, Jr_row[..., None, :]], axis=-2) * row[..., None]
        dxc_dphi = lie._einsum("ij,njk->nik", ext.R_cb, lie.hat(b))
        dxc_dp = -lie._mm(ext.R_cb, state.R_wb.T)
        J_phi = -jnp.einsum("nij,njk->nik", Jproj, dxc_dphi, precision=_HI)
        J_p = -jnp.einsum("nij,jk->nik", Jproj, dxc_dp, precision=_HI)

        behind = z <= 0.05
        m_pt = pt_mask & obs.point_mask & ~behind
        chi2_pt = jnp.sum(r_pt * r_pt, axis=-1) / obs.sigma2_pt
        w_pt = robust.cauchy_weight(chi2_pt, cauchy_c2) / obs.sigma2_pt
        w_pt = jnp.where(m_pt, w_pt, 0.0)

        # lines
        r_ln, J_ln_cam, aux = res.line_residuals(cam, R_cw, t_cw, obs.xs_w, obs.xe_w, obs.l_obs)
        xs_c, xe_c, Jd_xc_s, Jd_xc_e = aux
        bs = lie._einsum("ij,nj->ni", state.R_wb.T, obs.xs_w - state.p_w)
        be = lie._einsum("ij,nj->ni", state.R_wb.T, obs.xe_w - state.p_w)
        Js_phi = jnp.einsum("nj,njk->nk", Jd_xc_s, lie._einsum("ij,njk->nik", ext.R_cb, lie.hat(bs)), precision=_HI)
        Je_phi = jnp.einsum("nj,njk->nk", Jd_xc_e, lie._einsum("ij,njk->nik", ext.R_cb, lie.hat(be)), precision=_HI)
        Js_p = jnp.einsum("nj,jk->nk", Jd_xc_s, dxc_dp, precision=_HI)
        Je_p = jnp.einsum("nj,jk->nk", Jd_xc_e, dxc_dp, precision=_HI)
        J_ln_phi = jnp.stack([Js_phi, Je_phi], axis=-2)
        J_ln_p = jnp.stack([Js_p, Je_p], axis=-2)
        behind_ln = (xs_c[..., 2] <= 0.05) | (xe_c[..., 2] <= 0.05)
        m_ln = ln_mask & obs.line_mask & ~behind_ln
        chi2_ln = jnp.sum(r_ln * r_ln, axis=-1) / obs.sigma2_ln
        w_ln = robust.cauchy_weight(chi2_ln, cauchy_c2) / obs.sigma2_ln
        w_ln = jnp.where(m_ln, w_ln, 0.0)
        return (r_pt, J_phi, J_p, w_pt, chi2_pt, m_pt), (r_ln, J_ln_phi, J_ln_p, w_ln, chi2_ln, m_ln)

    def imu_terms(state: BodyState):
        def r_of(x):
            st = BodyState(
                R_wb=lie._mm(state.R_wb, lie.so3_exp(x[0:3])),
                p_w=state.p_w + x[3:6],
                v_w=state.v_w + x[6:9],
                bg=state.bg + x[9:12],
                ba=state.ba + x[12:15],
            )
            from pli_slam_tpu.solve import residuals as res

            r_imu = res.imu_residual(
                preint, prev.R_wb, prev.p_w, prev.v_w, st.R_wb, st.p_w, st.v_w,
                st.bg, st.ba, grav,
            )
            r_bg = st.bg - prev.bg
            r_ba = st.ba - prev.ba
            return jnp.concatenate([r_imu, r_bg, r_ba])

        r0 = r_of(jnp.zeros(15))
        J = jax.jacfwd(r_of)(jnp.zeros(15))  # [15, 15]
        return r0, J

    def gn_iter(state: BodyState, pt_mask, ln_mask):
        (r_pt, J_phi, J_p, w_pt, chi2_pt, m_pt), (r_ln, J_ln_phi, J_ln_p, w_ln, chi2_ln, m_ln) = visual_terms(state, pt_mask, ln_mask)
        # stack visual jacobian wrt [phi, p]; zero for [v, bg, ba]
        Jv_pt = jnp.concatenate([J_phi, J_p], axis=-1)  # [N,3,6]
        Jv_ln = jnp.concatenate([J_ln_phi, J_ln_p], axis=-1)  # [L,2,6]
        H6 = (
            jnp.einsum("nij,n,nik->jk", Jv_pt, w_pt, Jv_pt, precision=_HI)
            + jnp.einsum("nij,n,nik->jk", Jv_ln, w_ln, Jv_ln, precision=_HI)
        )
        g6 = (
            jnp.einsum("nij,n,ni->j", Jv_pt, w_pt, r_pt, precision=_HI)
            + jnp.einsum("nij,n,ni->j", Jv_ln, w_ln, r_ln, precision=_HI)
        )
        H = jnp.zeros((15, 15)).at[:6, :6].add(H6)
        g = jnp.zeros(15).at[:6].add(g6)

        r_i, J_i = imu_terms(state)
        info = jax.scipy.linalg.block_diag(info_imu, info_bg, info_ba)
        H = H + lie._mm(J_i.T, lie._mm(info, J_i))
        g = g + lie._einsum("ij,j->i", J_i.T, lie._einsum("ij,j->i", info, r_i))

        H = H + opt_cfg.damping_init * jnp.eye(15)
        # Jacobi-equilibrated solve: the 15x15 system mixes information
        # scales from ~1e10 (preintegrated rotation over 50 ms) down to
        # ~1e2 (visual + velocity blocks) — a raw f32 factorization at
        # that conditioning returns garbage steps exactly when the init
        # state is imperfect, which is when the solve matters most
        # (same protection as solve/ba.py's reduced-camera solve)
        dscale = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(H), 1e-12))
        H_eq = H * dscale[:, None] * dscale[None, :]
        delta = -(jnp.linalg.solve(H_eq, g * dscale) * dscale)
        bad = ~jnp.all(jnp.isfinite(delta)) | (jnp.linalg.norm(delta) > 2.0)
        delta = jnp.where(bad, jnp.zeros_like(delta), delta)
        return _state_from_delta(state, delta), chi2_pt, m_pt, chi2_ln, m_ln

    state = init
    pt_mask = jnp.ones(obs.point_mask.shape, bool)
    ln_mask = jnp.ones(obs.line_mask.shape, bool)
    rounds = getattr(opt_cfg, "pose_rounds_inertial", opt_cfg.pose_rounds)
    for _ in range(rounds - 1):
        for _ in range(opt_cfg.pose_gn_iters):
            state, chi2_pt, m_pt, chi2_ln, m_ln = gn_iter(state, pt_mask, ln_mask)
        r_pt_n = jnp.sqrt(jnp.maximum(chi2_pt, 0.0))
        pt_mask = robust.mad_inlier_mask(r_pt_n, m_pt, opt_cfg.mad_k) | (m_pt & (chi2_pt < cauchy_c2))
        r_ln_n = jnp.sqrt(jnp.maximum(chi2_ln, 0.0))
        ln_mask = robust.mad_inlier_mask(r_ln_n, m_ln, opt_cfg.mad_k) | (m_ln & (chi2_ln < cauchy_c2))
    for _ in range(opt_cfg.pose_gn_iters_refine):
        state, chi2_pt, m_pt, chi2_ln, m_ln = gn_iter(state, pt_mask, ln_mask)

    inlier_pt = m_pt & (chi2_pt < cauchy_c2)
    inlier_ln = m_ln & (chi2_ln < 7.815)
    n = jnp.sum(inlier_pt.astype(jnp.int32)) + jnp.sum(inlier_ln.astype(jnp.int32))
    state = dataclasses.replace(state, R_wb=lie.normalize_rotation(state.R_wb))
    return state, inlier_pt, inlier_ln, n


def estimate_gyro_bias(preints: list, dRs_visual: list, prior_info: float = 0.0) -> jax.Array:
    """Gyro bias from visual rotations vs preintegrated rotations.

    Solve min_bg sum || Log( (dR_preint Exp(JRg bg))^T dR_visual ) ||^2
    (+ prior_info * ||bg||^2) by one Gauss-Newton step from bg=0.
    (reference: InertialOptimization with priorG — the prior matters
    because frame-level visual rotation noise makes the bias weakly
    observable over short windows, src/LocalMapping.cc:1247 priorG=1e2.)
    """
    H = jnp.zeros((3, 3))
    g = jnp.zeros(3)
    for p, dR_vis in zip(preints, dRs_visual):
        r = lie.so3_log(lie._mm(p.dR.T, dR_vis))
        J = p.JRg
        H = H + lie._mm(J.T, J)
        g = g + lie._einsum("ij,j->i", J.T, r)
    return jnp.linalg.solve(H + (prior_info + 1e-9) * jnp.eye(3), g)


def estimate_gravity_direction(preints: list, R_wb_list: list, gravity: float = 9.81) -> jax.Array:
    """World gravity direction from summed velocity deltas.

    dirG = -sum_k R_wb_k * dV_k (reference: LocalMapping::InitializeIMU,
    src/LocalMapping.cc:1206-1234). Returns R_wg aligning world -z to
    the estimated gravity.
    """
    dirG = jnp.zeros(3)
    for p, R_wb in zip(preints, R_wb_list):
        dirG = dirG - lie._einsum("ij,j->i", R_wb, p.dV)
    dirG = dirG / jnp.maximum(jnp.linalg.norm(dirG), 1e-9)
    gI = jnp.array([0.0, 0.0, -1.0])  # target gravity direction in world
    v = jnp.cross(gI, dirG)
    cos = jnp.dot(gI, dirG)
    ang = jnp.arccos(jnp.clip(cos, -1.0, 1.0))
    axis = v / jnp.maximum(jnp.linalg.norm(v), 1e-9)
    return lie.so3_exp(axis * ang)
