"""Windowed bundle adjustment with Schur-complement reduction, fully batched.

JAX replacement for the reference's g2o-based local BA
(reference: src/Optimizer.cc — `LocalBundleAdjustment` :1864,
`BundleAdjustment` :63, Schur marginalization `Marginalize` :5125) and
— improving on the reference, whose local BA is points-only — line
landmarks participate too (SURVEY.md Phase 4 notes the reference's gap).

Structure exploited: each observation couples exactly one pose and one
landmark, so the direct Hessian is

    [ Hpp (block-diag)   Hpl ]
    [ Hlp                Hll (block-diag) ]

Landmarks are eliminated in closed form (batched 3x3 / 6x6 inverses);
the reduced camera system S = Hpp - Hpl Hll^-1 Hlp is a dense
[6W, 6W] matrix (W = pose window <= ~16) solved by Cholesky. Gauge
freedom is fixed by masking rows/cols of fixed poses.

Assembly is SCATTER-FREE: observations are argsorted by landmark id
ONCE per solve (`ObsIndex`); per-iteration segment reductions are then
a gather of each landmark's <=`wcap` observation blocks + a masked sum,
and the per-pose placement of the Hpl blocks is a tiny one-hot einsum
(no scatter-adds, which serialize on some backends). The pose-side
accumulation exploits the pose-major observation layout (see BAProblem)
as a reshape-sum. The same assembly generalizes to the distributed
version (parallel/dist_ba.py) where landmark blocks are sharded and S
is `psum`-reduced across devices.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import camera as cam_ops
from pli_slam_tpu.ops import lie, robust
from pli_slam_tpu.utils.config import OptimizerConfig

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Padded BA problem. All index arrays point into the padded stores.

    LAYOUT INVARIANT: observations are pose-major — `po_pose` must equal
    `repeat(arange(W), Op//W)` (same for `lo_pose`), and landmark ids
    must be unique within each pose's block of rows; empty slots carry
    id -1. Per-KF observation tables (worldmap.stores.KeyFrameStore)
    produce exactly this layout by construction. The assembly exploits
    it for the scatter-free pose-side reduction.
    """

    # poses (T_cw)
    R: jax.Array  # [W,3,3]
    t: jax.Array  # [W,3]
    pose_mask: jax.Array  # [W] bool — pose slot exists
    fixed_mask: jax.Array  # [W] bool — pose is fixed (gauge / boundary)
    # point landmarks
    pts: jax.Array  # [P,3]
    pt_mask: jax.Array  # [P] bool
    # line landmarks (endpoints stacked)
    lns: jax.Array  # [L,6] (xs, xe)
    ln_mask: jax.Array  # [L] bool
    # point observations
    po_pose: jax.Array  # [Op] int32
    po_pt: jax.Array  # [Op] int32
    po_uvr: jax.Array  # [Op,3]
    po_stereo: jax.Array  # [Op] bool
    po_sigma2: jax.Array  # [Op]
    po_mask: jax.Array  # [Op] bool
    # line observations
    lo_pose: jax.Array  # [Ol] int32
    lo_ln: jax.Array  # [Ol] int32
    lo_l: jax.Array  # [Ol,3] normalized image line
    lo_sigma2: jax.Array  # [Ol]
    lo_mask: jax.Array  # [Ol] bool


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BAResult:
    R: jax.Array
    t: jax.Array
    pts: jax.Array
    lns: jax.Array
    po_chi2: jax.Array  # [Op] final per-observation chi2
    lo_chi2: jax.Array  # [Ol]
    cost: jax.Array


# ---------------------------------------------------------------------------
# Scatter-free segment reduction over observations
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ObsIndex:
    """Sorted-observation gather plan for one landmark family.

    Built once per solve from the STATIC validity (landmark id >= 0 and
    problem masks); per-iteration dynamic rejections (behind-camera,
    robust weights) enter through zeroed weights instead.
    """

    perm: jax.Array  # [E] int32 — argsort of landmark ids
    gat: jax.Array  # [C, wcap] int32 — rows of the SORTED obs per landmark
    gmask: jax.Array  # [C, wcap] bool
    pose_of: jax.Array  # [C, wcap] int32 — pose index of each slot


def build_obs_index(lm_id: jax.Array, static_ok: jax.Array, pose_id: jax.Array,
                    capacity: int, wcap: int) -> ObsIndex:
    """Sort observations by landmark id; per landmark, plan a gather of
    its first `wcap` observation rows (extras are dropped — harmless
    observation subsampling for over-observed landmarks)."""
    E = lm_id.shape[0]
    key = jnp.where(static_ok & (lm_id >= 0), lm_id, capacity).astype(jnp.int32)
    perm = jnp.argsort(key)
    sorted_ids = key[perm]
    lm_range = jnp.arange(capacity, dtype=jnp.int32)
    start = jnp.searchsorted(sorted_ids, lm_range, side="left").astype(jnp.int32)
    end = jnp.searchsorted(sorted_ids, lm_range, side="right").astype(jnp.int32)
    end = jnp.minimum(end, start + wcap)
    gat = start[:, None] + jnp.arange(wcap, dtype=jnp.int32)[None, :]
    gmask = gat < end[:, None]
    gat = jnp.minimum(gat, E - 1)
    pose_sorted = pose_id[perm]
    pose_of = jnp.where(gmask, pose_sorted[gat], 0)
    return ObsIndex(perm=perm, gat=gat, gmask=gmask, pose_of=pose_of)


def segment_reduce(idx: ObsIndex, vals: jax.Array) -> jax.Array:
    """Sum per-observation rows [E, F] into per-landmark rows [C, F]."""
    v_sorted = vals[idx.perm]
    g = v_sorted[idx.gat]  # [C, wcap, F]
    return jnp.sum(jnp.where(idx.gmask[..., None], g, 0.0), axis=1)


def segment_reduce_split(idx: ObsIndex, vals: jax.Array, split: int, n_poses: int):
    """One fused gather serving both reductions: the first `split`
    columns are plain per-landmark sums, the rest are additionally
    separated by observing pose (the Hpl blocks). Gathering once matters:
    the [C, wcap] random-row gather is the latency-bound part.

    Returns (sum [C, split], per_pose [C, n_poses, F - split]).
    """
    v_sorted = vals[idx.perm]
    g = jnp.where(idx.gmask[..., None], v_sorted[idx.gat], 0.0)  # [C, wcap, F]
    plain = jnp.sum(g[..., :split], axis=1)
    onehot = (idx.pose_of[..., None] == jnp.arange(n_poses)[None, None, :])
    onehot = (onehot & idx.gmask[..., None]).astype(vals.dtype)  # [C, wcap, W]
    per_pose = jnp.einsum("cse,csf->cef", onehot, g[..., split:], precision=_HI)
    return plain, per_pose


# ---------------------------------------------------------------------------
# Per-observation linearization
# ---------------------------------------------------------------------------


def _point_obs_linearize(cam, prob: BAProblem, R, t, pts):
    """Residuals + Jacobians for every point observation. Batched over obs."""
    Ro = R[prob.po_pose]  # [Op,3,3]
    to = t[prob.po_pose]  # [Op,3]
    xw = pts[jnp.maximum(prob.po_pt, 0)]  # [Op,3]
    xc = jnp.einsum("nij,nj->ni", Ro, xw, precision=_HI) + to
    uvr = cam_ops.stereo_project(cam, xc)
    r = prob.po_uvr - uvr  # [Op,3]
    row = jnp.stack(
        [jnp.ones_like(prob.po_stereo), jnp.ones_like(prob.po_stereo), prob.po_stereo], axis=-1
    ).astype(r.dtype)
    r = r * row
    J2 = cam_ops.project_jacobian(cam, xc)  # [Op,2,3]
    z = xc[..., 2]
    inv_z2 = 1.0 / jnp.maximum(z * z, 1e-12)
    Jr = J2[..., 0, :] + jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * inv_z2], axis=-1)
    Jproj = jnp.concatenate([J2, Jr[..., None, :]], axis=-2) * row[..., None]  # [Op,3,3]
    dxc = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), xc.shape[:-1] + (3, 3)), -lie.hat(xc)], axis=-1
    )  # [Op,3,6]
    Jp = -jnp.einsum("nij,njk->nik", Jproj, dxc, precision=_HI)  # d r / d pose twist
    Jl = -jnp.einsum("nij,njk->nik", Jproj, Ro, precision=_HI)  # d r / d x_w
    ok = (
        prob.po_mask & (prob.po_pt >= 0) & (z > 0.05)
        & prob.pt_mask[jnp.maximum(prob.po_pt, 0)] & prob.pose_mask[prob.po_pose]
    )
    return r, Jp, Jl, ok


def _line_obs_linearize(cam, prob: BAProblem, R, t, lns):
    Ro = R[prob.lo_pose]
    to = t[prob.lo_pose]
    seg = lns[jnp.maximum(prob.lo_ln, 0)]  # [Ol,6]
    l_obs = prob.lo_l

    def endpoint(xw):
        xc = jnp.einsum("nij,nj->ni", Ro, xw, precision=_HI) + to
        uv = cam_ops.project(cam, xc)
        d = l_obs[:, 0] * uv[:, 0] + l_obs[:, 1] * uv[:, 1] + l_obs[:, 2]
        Jproj = cam_ops.project_jacobian(cam, xc)
        Jd_xc = jnp.einsum("ni,nij->nj", l_obs[:, :2], Jproj, precision=_HI)  # [Ol,3]
        dxc = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3), xc.shape[:-1] + (3, 3)), -lie.hat(xc)], axis=-1
        )
        Jd_pose = jnp.einsum("nj,njk->nk", Jd_xc, dxc, precision=_HI)  # [Ol,6]
        Jd_x = jnp.einsum("nj,njk->nk", Jd_xc, Ro, precision=_HI)  # [Ol,3]
        return d, Jd_pose, Jd_x, xc[:, 2]

    d0, Jp0, Jx0, z0 = endpoint(seg[:, :3])
    d1, Jp1, Jx1, z1 = endpoint(seg[:, 3:])
    r = -jnp.stack([d0, d1], axis=-1)  # residual = 0 - d (target distance 0)
    Jp = -jnp.stack([Jp0, Jp1], axis=-2)  # [Ol,2,6]
    zeros = jnp.zeros_like(Jx0)
    Jl = -jnp.stack(
        [jnp.concatenate([Jx0, zeros], -1), jnp.concatenate([zeros, Jx1], -1)], axis=-2
    )  # [Ol,2,6]
    ok = (
        prob.lo_mask & (prob.lo_ln >= 0) & (z0 > 0.05) & (z1 > 0.05)
        & prob.ln_mask[jnp.maximum(prob.lo_ln, 0)] & prob.pose_mask[prob.lo_pose]
    )
    return r, Jp, Jl, ok


def _robust_weight(r, sigma2, ok, delta):
    chi2 = jnp.sum(r * r, axis=-1) / sigma2
    w = robust.huber_weight(chi2, delta * delta) / sigma2
    return jnp.where(ok, w, 0.0), chi2


# ---------------------------------------------------------------------------
# Shared visual assembly (used by ba_iteration AND solve/vi_ba.py)
# ---------------------------------------------------------------------------


def prepare_indices(prob: BAProblem, wcap_pt: int | None = None,
                    wcap_ln: int | None = None) -> tuple[ObsIndex, ObsIndex]:
    """Build the per-solve gather plans. wcap defaults to the window size
    (a landmark is observed at most once per keyframe)."""
    W = prob.R.shape[0]
    P = prob.pts.shape[0]
    L = prob.lns.shape[0]
    static_p = prob.po_mask & (prob.po_pt >= 0)
    static_l = prob.lo_mask & (prob.lo_ln >= 0)
    idx_p = build_obs_index(prob.po_pt, static_p, prob.po_pose, P, wcap_pt or W)
    idx_l = build_obs_index(prob.lo_ln, static_l, prob.lo_pose, L, wcap_ln or W)
    return idx_p, idx_l


def assemble_visual(cam, prob: BAProblem, idx_p: ObsIndex, idx_l: ObsIndex,
                    R, t, pts, lns, cfg: OptimizerConfig, damping):
    """Linearize + reduce the visual problem.

    Returns the reduced camera system pieces shared by the 6-dof and
    15-dof (VI) solvers:
      S6 [W,W,6,6], rhs6 [W,6],
      (Hll_p_inv, gl_p, Wb_p, active_p), (Hll_l_inv, gl_l, Wb_l, active_l),
      cost, chi2_p, chi2_l
    """
    W = prob.R.shape[0]

    r_p, Jp_p, Jl_p, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
    w_p, chi2_p = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
    r_l, Jp_l, Jl_l, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
    w_l, chi2_l = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)

    # ---- pose-side accumulation (pose-major reshape-sum, no scatter) ----
    Sx = prob.po_pt.shape[0] // W
    Sl = prob.lo_ln.shape[0] // W
    blk_pp = jnp.einsum("nia,n,nib->nab", Jp_p, w_p, Jp_p, precision=_HI).reshape(W, Sx, 6, 6)
    blk_gp = jnp.einsum("nia,n,ni->na", Jp_p, w_p, r_p, precision=_HI).reshape(W, Sx, 6)
    blk_pp_l = jnp.einsum("nia,n,nib->nab", Jp_l, w_l, Jp_l, precision=_HI).reshape(W, Sl, 6, 6)
    blk_gp_l = jnp.einsum("nia,n,ni->na", Jp_l, w_l, r_l, precision=_HI).reshape(W, Sl, 6)
    Hpp = blk_pp.sum(1) + blk_pp_l.sum(1)
    gp = blk_gp.sum(1) + blk_gp_l.sum(1)

    # ---- landmark-side accumulation (one fused gather per family) -------
    pt_pack = jnp.concatenate(
        [
            jnp.einsum("nia,n,nib->nab", Jl_p, w_p, Jl_p, precision=_HI).reshape(-1, 9),
            jnp.einsum("nia,n,ni->na", Jl_p, w_p, r_p, precision=_HI),
            jnp.einsum("nia,n,nib->nab", Jp_p, w_p, Jl_p, precision=_HI).reshape(-1, 18),
        ],
        axis=-1,
    )  # [Op, 30]
    red_p, Wb_p = segment_reduce_split(idx_p, pt_pack, split=12, n_poses=W)
    Hll_p = red_p[:, :9].reshape(-1, 3, 3)
    gl_p = red_p[:, 9:]
    Wb_p = Wb_p.reshape(-1, W, 6, 3)

    ln_pack = jnp.concatenate(
        [
            jnp.einsum("nia,n,nib->nab", Jl_l, w_l, Jl_l, precision=_HI).reshape(-1, 36),
            jnp.einsum("nia,n,ni->na", Jl_l, w_l, r_l, precision=_HI),
            jnp.einsum("nia,n,nib->nab", Jp_l, w_l, Jl_l, precision=_HI).reshape(-1, 36),
        ],
        axis=-1,
    )  # [Ol, 78]
    red_l, Wb_l = segment_reduce_split(idx_l, ln_pack, split=42, n_poses=W)
    Hll_l = red_l[:, :36].reshape(-1, 6, 6)
    gl_l = red_l[:, 36:]
    Wb_l = Wb_l.reshape(-1, W, 6, 6)

    # ---- Schur elimination of landmarks --------------------------------
    eye3 = jnp.eye(3)
    eye6 = jnp.eye(6)
    active_p = prob.pt_mask & (jnp.diagonal(Hll_p, axis1=1, axis2=2).sum(-1) > 1e-10)
    active_l = prob.ln_mask & (jnp.diagonal(Hll_l, axis1=1, axis2=2).sum(-1) > 1e-10)
    Hll_p_d = Hll_p + damping * eye3  # damped landmark blocks
    # The endpoint-to-infinite-line residual never constrains endpoint
    # motion ALONG the 3D line (a structural 2-dim nullspace per line
    # landmark — one reason the reference keeps lines out of BA).
    # Stiffen exactly those directions: the gradient there is zero, so
    # this pins the null components without biasing the constrained ones.
    seg_dir = lns[:, 3:] - lns[:, :3]
    u = seg_dir / jnp.maximum(jnp.linalg.norm(seg_dir, axis=-1, keepdims=True), 1e-6)
    D = jnp.einsum("la,lb->lab", u, u)  # [L,3,3] along-line projector
    reg = jnp.diagonal(Hll_l, axis1=1, axis2=2).sum(-1) / 6.0 + 1.0  # per-line scale
    zero3 = jnp.zeros_like(D)
    Dblk = jnp.concatenate(
        [jnp.concatenate([D, zero3], -1), jnp.concatenate([zero3, D], -1)], axis=-2
    )
    Hll_l_d = Hll_l + damping * eye6 + reg[:, None, None] * Dblk
    Hll_p_inv = jnp.where(
        active_p[:, None, None],
        _inv_spd_equilibrated(Hll_p_d + (~active_p)[:, None, None] * eye3, _inv3x3),
        0.0,
    )
    Hll_l_inv = jnp.where(
        active_l[:, None, None],
        _inv_spd_equilibrated(Hll_l_d + (~active_l)[:, None, None] * eye6, _inv6x6_spd),
        0.0,
    )

    # Schur subtraction Wb Hll^-1 Wb^T as ONE flat matmul per family:
    # A = Wb viewed [C, 6W, d]; B = A @ Hll^-1 (tiny batched matmul);
    # then contract (C, d) at once — einsum "iac,ibc->ab" is a single
    # dot_general. (The previous 3-operand einsum form lowered ~30x
    # slower.)
    def schur_terms(Wb, Hinv, gl, d):
        # Wb is [C, W, 6, d]; flatten (W, 6) in that order so the
        # resulting [6W, 6W] matrix is w-major, matching the S6 layout
        A = Wb.reshape(Wb.shape[0], W * 6, d)
        B = jnp.einsum("icd,ide->ice", A, Hinv, precision=_HI)  # [C, 6W, d]
        S_sub = jnp.einsum("iac,ibc->ab", B, A, precision=_HI)  # [6W, 6W]
        r_add = jnp.einsum("iac,ic->a", B, gl, precision=_HI)  # [6W]
        return S_sub, r_add

    Ssub_p, radd_p = schur_terms(Wb_p, Hll_p_inv, gl_p, 3)
    Ssub_l, radd_l = schur_terms(Wb_l, Hll_l_inv, gl_l, 6)
    S6 = jnp.zeros((W, W, 6, 6))
    S6 = S6.at[jnp.arange(W), jnp.arange(W)].add(Hpp)
    S6 = S6 - (Ssub_p + Ssub_l).reshape(W, 6, W, 6).transpose(0, 2, 1, 3)
    rhs6 = -gp + (radd_p + radd_l).reshape(W, 6)

    cost = jnp.sum(w_p * chi2_p * prob.po_sigma2) + jnp.sum(w_l * chi2_l * prob.lo_sigma2)
    return (
        S6, rhs6,
        (Hll_p_inv, gl_p, Wb_p, active_p),
        (Hll_l_inv, gl_l, Wb_l, active_l),
        cost, chi2_p, chi2_l,
    )


def _inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate/determinant) — pure
    elementwise, no batched LU."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1.0, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _inv_spd_equilibrated(m: jax.Array, invfn) -> jax.Array:
    """Jacobi-equilibrated batched SPD inverse: rescale to unit diagonal
    before the closed-form inverse so f32 adjugate arithmetic stays
    accurate on ill-conditioned landmark blocks (raw condition numbers
    reach ~1e8; equilibration removes the scale component)."""
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(m, axis1=-2, axis2=-1), 1e-30))
    s = 1.0 / d
    m_eq = m * s[..., :, None] * s[..., None, :]
    return invfn(m_eq) * s[..., :, None] * s[..., None, :]


def _inv6x6_spd(m: jax.Array) -> jax.Array:
    """Batched 6x6 SPD inverse via 3x3 block Schur complement — all
    elementwise + tiny batched matmuls; avoids a batched LU custom
    call."""
    A = m[..., :3, :3]
    B = m[..., :3, 3:]
    Dm = m[..., 3:, 3:]
    Ai = _inv3x3(A)
    AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
    S = Dm - jnp.einsum("...ji,...jk->...ik", B, AiB)  # D - B^T A^-1 B
    Si = _inv3x3(S)
    TL = Ai + jnp.einsum("...ij,...jk,...lk->...il", AiB, Si, AiB)
    TR = -jnp.einsum("...ij,...jk->...ik", AiB, Si)
    BL = jnp.swapaxes(TR, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def back_substitute(Wb, Hll_inv, gl, delta_p):
    """Landmark update given the pose step: dl = Hll^-1 (-gl - Wb^T dp)."""
    A = Wb.reshape(Wb.shape[0], -1, Wb.shape[-1])  # [C, 6W, d]
    rhs = -gl - jnp.einsum("iac,a->ic", A, delta_p.reshape(-1), precision=_HI)
    return jnp.einsum("iab,ib->ia", Hll_inv, rhs, precision=_HI)


# ---------------------------------------------------------------------------
# 6-dof solve
# ---------------------------------------------------------------------------


def ba_iteration(cam, prob: BAProblem, idx_p: ObsIndex, idx_l: ObsIndex,
                 R, t, pts, lns, cfg: OptimizerConfig, damping,
                 axis_name: str | None = None):
    W = prob.R.shape[0]
    eye6 = jnp.eye(6)
    (S, rhs, (Hll_p_inv, gl_p, Wb_p, active_p), (Hll_l_inv, gl_l, Wb_l, active_l),
     cost, chi2_p, chi2_l) = assemble_visual(cam, prob, idx_p, idx_l, R, t, pts, lns, cfg, damping)
    S = S.at[jnp.arange(W), jnp.arange(W)].add(damping * eye6)

    if axis_name is not None:
        # Distributed Schur: each device assembled its landmark shard's
        # contribution; the reduced camera system is the psum over shards
        # (SURVEY.md §2.3 — collectives over ICI replace the g2o heap).
        # partition_observations masks every observation into exactly one
        # shard, so the psum counts each obs once on both sides of S.
        S = jax.lax.psum(S, axis_name)
        rhs = jax.lax.psum(rhs, axis_name)
        cost = jax.lax.psum(cost, axis_name)

    # --- gauge fixing: zero rows/cols of fixed or absent poses ----------
    free = (prob.pose_mask & ~prob.fixed_mask).astype(S.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S.at[jnp.arange(W), jnp.arange(W)].add((1.0 - free)[:, None, None] * eye6)
    rhs = rhs * free[:, None]

    # Jacobi-equilibrated solve: keeps the f32 factorization meaningful
    # when strong and weak pose blocks coexist in the window
    Sd = S.transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
    dscale = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(Sd), 1e-12))
    Sd_eq = Sd * dscale[:, None] * dscale[None, :]
    delta_p = (jnp.linalg.solve(Sd_eq, rhs.reshape(-1) * dscale) * dscale).reshape(W, 6)
    bad = ~jnp.all(jnp.isfinite(delta_p))
    delta_p = jnp.where(bad, 0.0, delta_p)
    # trust region: a GN step along a weakly-observed direction can be
    # arbitrarily large; clamp instead of silently accepting (the g2o
    # reference gets the same protection from LM damping adaptation)
    pn = jnp.linalg.norm(delta_p, axis=-1, keepdims=True)
    delta_p = delta_p * jnp.minimum(1.0, cfg.ba_max_pose_step / jnp.maximum(pn, 1e-12))

    # --- back-substitute landmarks --------------------------------------
    delta_pt = back_substitute(Wb_p, Hll_p_inv, gl_p, delta_p)
    delta_ln = back_substitute(Wb_l, Hll_l_inv, gl_l, delta_p)
    delta_pt = jnp.where(bad | ~jnp.all(jnp.isfinite(delta_pt), -1, keepdims=True), 0.0, delta_pt)
    delta_ln = jnp.where(bad | ~jnp.all(jnp.isfinite(delta_ln), -1, keepdims=True), 0.0, delta_ln)
    ln_n = jnp.linalg.norm(delta_pt, axis=-1, keepdims=True)
    delta_pt = delta_pt * jnp.minimum(1.0, cfg.ba_max_landmark_step / jnp.maximum(ln_n, 1e-12))
    ll_n = jnp.linalg.norm(delta_ln, axis=-1, keepdims=True)
    delta_ln = delta_ln * jnp.minimum(1.0, cfg.ba_max_landmark_step / jnp.maximum(ll_n, 1e-12))

    # --- apply updates ---------------------------------------------------
    dR, dt = lie.se3_exp(delta_p)  # batched over W
    R_new = lie.normalize_rotation(jnp.einsum("wij,wjk->wik", dR, R, precision=_HI))
    t_new = jnp.einsum("wij,wj->wi", dR, t, precision=_HI) + dt
    pts_new = pts + jnp.where(active_p[:, None], delta_pt, 0.0)
    lns_new = lns + jnp.where(active_l[:, None], delta_ln, 0.0)
    return R_new, t_new, pts_new, lns_new, cost, chi2_p, chi2_l


def solve_ba(cam, prob: BAProblem, cfg: OptimizerConfig, iters: int | None = None, axis_name: str | None = None) -> BAResult:
    """Two-stage LM solve mirroring the reference's local-BA protocol
    (src/Optimizer.cc:2157,2231): optimize, reclassify outlier
    observations by chi2, optimize again with them removed. The returned
    po_chi2/lo_chi2 let the caller erase outliers from the map the way
    the reference erases MapPoint observations after local BA.

    With `axis_name`, runs as the per-shard body of a `shard_map` over a
    landmark-sharded problem (poses replicated) — see parallel/dist_ba.py.
    """
    iters = cfg.local_ba_iters if iters is None else iters
    iters1 = max(iters // 3, 1)
    res1 = _solve_ba_stage(cam, prob, cfg, iters1, axis_name)
    # outlier reclassification (chi2 thresholds as g2o deltas squared)
    keep_pt = res1.po_chi2 < cfg.prune_chi2_pt
    keep_ln = res1.lo_chi2 < cfg.prune_chi2_ln
    prob2 = dataclasses.replace(
        prob,
        R=res1.R, t=res1.t, pts=res1.pts, lns=res1.lns,
        po_mask=prob.po_mask & keep_pt,
        lo_mask=prob.lo_mask & keep_ln,
    )
    res2 = _solve_ba_stage(cam, prob2, cfg, iters - iters1, axis_name)
    # report chi2 of EVERY original observation (pruned ones included) at
    # the final state so the caller can erase them from the obs tables
    return res2


def solve_ba_alternating(cam, prob: BAProblem, cfg: OptimizerConfig,
                         iters: int | None = None, wcap: int = 16,
                         axis_name: str | None = None) -> BAResult:
    """Memory-bounded whole-map BA by exact block-coordinate descent
    (resection-intersection): alternate a landmark-only GN step (poses
    fixed — the system is block-diagonal per landmark) with a pose-only
    GN step (landmarks fixed — block-diagonal per pose). No Hpl blocks
    are ever materialized, so memory is O(P·wcap) instead of the Schur
    solve's O(P·W) — this is what global BA over hundreds of keyframes
    uses (reference RunGlobalBundleAdjustment optimizes the whole graph
    in a background thread; src/LoopClosing.cc:2243).

    Converges slower per iteration than the joint Schur solve but every
    step is exact coordinate descent, and after a pose-graph correction
    the problem starts near the optimum.
    """
    iters = cfg.gba_iters if iters is None else iters
    W = prob.R.shape[0]
    idx_p, idx_l = prepare_indices(prob, wcap_pt=wcap, wcap_ln=wcap)
    damping = jnp.asarray(1e-3, jnp.float32)
    eye3 = jnp.eye(3)
    eye6 = jnp.eye(6)
    free = (prob.pose_mask & ~prob.fixed_mask).astype(jnp.float32)

    def body(_, carry):
        R, t, pts, lns = carry
        # ---- landmark step (poses fixed) --------------------------------
        r_p, _, Jl_p, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
        w_p, _ = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
        pack_p = jnp.concatenate(
            [
                jnp.einsum("nia,n,nib->nab", Jl_p, w_p, Jl_p, precision=_HI).reshape(-1, 9),
                jnp.einsum("nia,n,ni->na", Jl_p, w_p, r_p, precision=_HI),
            ],
            axis=-1,
        )
        red_p = segment_reduce(idx_p, pack_p)
        Hll_p = red_p[:, :9].reshape(-1, 3, 3)
        gl_p = red_p[:, 9:]
        act_p = prob.pt_mask & (jnp.diagonal(Hll_p, axis1=1, axis2=2).sum(-1) > 1e-10)
        Hinv = _inv_spd_equilibrated(
            Hll_p + damping * eye3 + (~act_p)[:, None, None] * eye3, _inv3x3
        )
        d_pt = -jnp.einsum("iab,ib->ia", Hinv, gl_p, precision=_HI)
        nrm = jnp.linalg.norm(d_pt, axis=-1, keepdims=True)
        d_pt = d_pt * jnp.minimum(1.0, cfg.ba_max_landmark_step / jnp.maximum(nrm, 1e-12))
        pts = pts + jnp.where(act_p[:, None] & jnp.all(jnp.isfinite(d_pt), -1, keepdims=True), d_pt, 0.0)

        r_l, _, Jl_l, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
        w_l, _ = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
        pack_l = jnp.concatenate(
            [
                jnp.einsum("nia,n,nib->nab", Jl_l, w_l, Jl_l, precision=_HI).reshape(-1, 36),
                jnp.einsum("nia,n,ni->na", Jl_l, w_l, r_l, precision=_HI),
            ],
            axis=-1,
        )
        red_l = segment_reduce(idx_l, pack_l)
        Hll_l = red_l[:, :36].reshape(-1, 6, 6)
        gl_l = red_l[:, 36:]
        act_l = prob.ln_mask & (jnp.diagonal(Hll_l, axis1=1, axis2=2).sum(-1) > 1e-10)
        seg_dir = lns[:, 3:] - lns[:, :3]
        u = seg_dir / jnp.maximum(jnp.linalg.norm(seg_dir, axis=-1, keepdims=True), 1e-6)
        Dp = jnp.einsum("la,lb->lab", u, u)
        z3 = jnp.zeros_like(Dp)
        Dblk = jnp.concatenate(
            [jnp.concatenate([Dp, z3], -1), jnp.concatenate([z3, Dp], -1)], axis=-2
        )
        regl = jnp.diagonal(Hll_l, axis1=1, axis2=2).sum(-1) / 6.0 + 1.0
        Hinv_l = _inv_spd_equilibrated(
            Hll_l + damping * eye6 + regl[:, None, None] * Dblk + (~act_l)[:, None, None] * eye6,
            _inv6x6_spd,
        )
        d_ln = -jnp.einsum("iab,ib->ia", Hinv_l, gl_l, precision=_HI)
        nrm = jnp.linalg.norm(d_ln, axis=-1, keepdims=True)
        d_ln = d_ln * jnp.minimum(1.0, cfg.ba_max_landmark_step / jnp.maximum(nrm, 1e-12))
        lns = lns + jnp.where(act_l[:, None] & jnp.all(jnp.isfinite(d_ln), -1, keepdims=True), d_ln, 0.0)

        # ---- pose step (landmarks fixed; block-diagonal, exact) ----------
        r_p, Jp_p, _, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
        w_p, _ = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
        r_l, Jp_l, _, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
        w_l, _ = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
        Sx = prob.po_pt.shape[0] // W
        Sl = prob.lo_ln.shape[0] // W
        Hpp = (
            jnp.einsum("nia,n,nib->nab", Jp_p, w_p, Jp_p, precision=_HI).reshape(W, Sx, 6, 6).sum(1)
            + jnp.einsum("nia,n,nib->nab", Jp_l, w_l, Jp_l, precision=_HI).reshape(W, Sl, 6, 6).sum(1)
        )
        gp = (
            jnp.einsum("nia,n,ni->na", Jp_p, w_p, r_p, precision=_HI).reshape(W, Sx, 6).sum(1)
            + jnp.einsum("nia,n,ni->na", Jp_l, w_l, r_l, precision=_HI).reshape(W, Sl, 6).sum(1)
        )
        if axis_name is not None:
            # landmark-sharded distributed GBA: the landmark step above is
            # embarrassingly parallel (each shard owns its landmarks); the
            # pose step reduces per-pose blocks over shards — [W,6,6]+[W,6]
            # per iteration is the only collective traffic
            Hpp = jax.lax.psum(Hpp, axis_name)
            gp = jax.lax.psum(gp, axis_name)
        act_w = jnp.diagonal(Hpp, axis1=1, axis2=2).sum(-1) > 1e-10
        Hpp_inv = _inv_spd_equilibrated(
            Hpp + damping * eye6 + (~act_w)[:, None, None] * eye6, _inv6x6_spd
        )
        dp = -jnp.einsum("wab,wb->wa", Hpp_inv, gp, precision=_HI)
        nrm = jnp.linalg.norm(dp, axis=-1, keepdims=True)
        dp = dp * jnp.minimum(1.0, cfg.ba_max_pose_step / jnp.maximum(nrm, 1e-12))
        dp = dp * free[:, None] * act_w[:, None]
        dp = jnp.where(jnp.all(jnp.isfinite(dp)), dp, 0.0)
        dR, dt = lie.se3_exp(dp)
        R = lie.normalize_rotation(jnp.einsum("wij,wjk->wik", dR, R, precision=_HI))
        t = jnp.einsum("wij,wj->wi", dR, t, precision=_HI) + dt
        return R, t, pts, lns

    R, t, pts, lns = jax.lax.fori_loop(
        0, iters, body, (prob.R, prob.t, prob.pts, prob.lns)
    )
    # final residual evaluation for chi2 reporting
    r_p, _, _, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
    w_p, chi2_p = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
    r_l, _, _, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
    w_l, chi2_l = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
    cost = jnp.sum(w_p * chi2_p * prob.po_sigma2) + jnp.sum(w_l * chi2_l * prob.lo_sigma2)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    return BAResult(R=R, t=t, pts=pts, lns=lns, po_chi2=chi2_p, lo_chi2=chi2_l, cost=cost)


def evaluate_cost(cam, prob: BAProblem, R, t, pts, lns, cfg: OptimizerConfig,
                  axis_name: str | None = None):
    """Residual-only evaluation (no Jacobians/assembly/solve): returns
    (cost, chi2_p, chi2_l). ~7x cheaper than a full ba_iteration — used
    for the delayed-rejection tail checks."""
    r_p, _, _, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
    w_p, chi2_p = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
    r_l, _, _, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
    w_l, chi2_l = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
    cost = jnp.sum(w_p * chi2_p * prob.po_sigma2) + jnp.sum(w_l * chi2_l * prob.lo_sigma2)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    return cost, chi2_p, chi2_l


def _solve_ba_stage(cam, prob: BAProblem, cfg: OptimizerConfig, iters: int, axis_name: str | None = None) -> BAResult:
    idx_p, idx_l = prepare_indices(prob)

    # Levenberg-Marquardt with DELAYED rejection: ba_iteration evaluates
    # the cost at its INPUT state, so comparing successive costs tells us
    # whether the previous step helped — without a second assembly. On a
    # cost increase the state reverts and damping rises (the g2o LM
    # schedule, reference Thirdparty/g2o OptimizationAlgorithmLevenberg).
    state0 = (prob.R, prob.t, prob.pts, prob.lns)

    def body(_, carry):
        cur, prev, cost_prev, lam = carry
        R, t, pts, lns = cur
        Rn, tn, ptsn, lnsn, cost, _, _ = ba_iteration(
            cam, prob, idx_p, idx_l, R, t, pts, lns, cfg, lam, axis_name
        )
        worse = cost > cost_prev
        stepped = (Rn, tn, ptsn, lnsn)

        def pick(a, b):
            return jax.tree_util.tree_map(lambda x, y: jnp.where(worse, x, y), a, b)

        new_cur = pick(prev, stepped)  # revert on worse, else take the step
        new_prev = pick(prev, cur)
        new_cost = jnp.where(worse, cost_prev, cost)
        # only relax damping on STRICT improvement — a re-step from a
        # reverted state reports cost == cost_prev and must keep lambda,
        # otherwise reject/re-step ping-pongs and never climbs
        improved = cost < cost_prev
        new_lam = jnp.where(
            worse, lam * 10.0,
            jnp.where(improved, jnp.maximum(lam * 0.5, cfg.damping_init), lam),
        )
        return new_cur, new_prev, new_cost, new_lam

    carry0 = (state0, state0, jnp.asarray(jnp.inf, jnp.float32),
              jnp.asarray(cfg.damping_init, jnp.float32))
    cur, prev, cost_prev, lam = jax.lax.fori_loop(0, iters, body, carry0)
    # the last accepted step was never cost-checked (delayed rejection
    # lags one iteration): evaluate it and fall back to the last state
    # whose cost is known-good if it made things worse. Residual-only
    # evaluations — a full assembly+solve here doubled the per-stage cost.
    cost_cur, chi2_p_c, chi2_l_c = evaluate_cost(cam, prob, *cur, cfg, axis_name)
    cost_prev2, chi2_p_p, chi2_l_p = evaluate_cost(cam, prob, *prev, cfg, axis_name)
    worse = cost_cur > cost_prev
    R, t, pts, lns = jax.tree_util.tree_map(
        lambda a, b: jnp.where(worse, a, b), prev, cur
    )
    cost = jnp.where(worse, cost_prev2, cost_cur)
    chi2_p = jnp.where(worse, chi2_p_p, chi2_p_c)
    chi2_l = jnp.where(worse, chi2_l_p, chi2_l_c)
    return BAResult(R=R, t=t, pts=pts, lns=lns, po_chi2=chi2_p, lo_chi2=chi2_l, cost=cost)
