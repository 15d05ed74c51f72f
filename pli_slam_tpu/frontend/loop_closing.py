"""Loop closing: BoW detection -> geometric verification -> graph correction.

JAX replacement for the reference's LoopClosing worker
(reference: src/LoopClosing.cc — `NewDetectCommonRegions` :246,
`DetectCommonRegionsFromBoW` :476, `CorrectLoop` :857, essential-graph
optimization dispatch :1062-1067). The free-running thread becomes a
per-keyframe host call into three jitted programs:

1. detect: dense BoW query (worldmap/vocab.py) with a temporal-
   consistency counter on the host (>= `consistency_kfs` consecutive
   hits near the same past keyframe, reference LoopClosing.cc:306);
2. verify: landmark-to-landmark descriptor matching between the two
   keyframes' observation tables + batched-hypothesis Sim3/SE3 RANSAC
   (solve/sim3.py) replacing Sim3Solver::iterate;
3. correct: essential-graph optimization over the keyframe chain with
   the verified loop edge (solve/pgo.py), then landmark re-anchoring —
   every landmark is transformed by its reference keyframe's pose
   correction, INCLUDING line endpoints (the reference forgets lines in
   CorrectLoop — SURVEY.md flags it at LoopClosing.cc:912-991).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.ops import lie, matching
from pli_slam_tpu.solve import pgo, sim3
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu.worldmap import stores as st
_HI = jax.lax.Precision.HIGHEST


def match_kf_landmarks(
    kstore: st.KeyFrameStore, pstore: st.PointStore, kf_a, kf_b, max_dist=60.0
):
    """3D-3D correspondences between two keyframes' observed landmarks,
    matched through the landmarks' own distinctive descriptors in the
    point store (the reference matches MapPoint::GetDescriptor() in
    SearchByBoW for loop verification — no per-KF descriptor copy needed).

    Returns (x [S,3] world pts of a's landmarks, y [S,3] of b's matches,
    mask [S]).
    """
    ia = kstore.obs_pt[kf_a]
    ib = kstore.obs_pt[kf_b]
    va = (ia >= 0) & pstore.valid[jnp.maximum(ia, 0)]
    vb = (ib >= 0) & pstore.valid[jnp.maximum(ib, 0)]
    da = pstore.desc[jnp.maximum(ia, 0)]
    db = pstore.desc[jnp.maximum(ib, 0)]
    dist = matching.hamming_matrix(da, db)
    idx, best, ok = matching.match_nn(dist, va, vb, max_dist=max_dist, ratio=0.9)
    ok = matching.mutual_consistency(idx, ok, dist, va, vb)
    xa = pstore.x[jnp.maximum(ia, 0)]
    xb = pstore.x[jnp.maximum(ib[idx], 0)]
    ok = ok & va & vb[idx]
    return xa, xb, ok


def match_cross_map(
    ks_a: st.KeyFrameStore, ps_a: st.PointStore, kf_a,
    ks_b: st.KeyFrameStore, ps_b: st.PointStore, kf_b, max_dist=60.0,
):
    """3D-3D correspondences between keyframes of two DIFFERENT maps
    (Atlas merge verification — reference MergeLocal's SearchByBoW stage,
    src/LoopClosing.cc:1096). Same structure as match_kf_landmarks but
    each side indexes its own stores.

    Returns (x [S,3] map-a world pts, y [S,3] map-b pts, idx_b [S] map-b
    landmark ids, mask [S]); row i also carries map-a landmark id via
    ks_a.obs_pt[kf_a].
    """
    ia = ks_a.obs_pt[kf_a]
    ib = ks_b.obs_pt[kf_b]
    va = (ia >= 0) & ps_a.valid[jnp.maximum(ia, 0)]
    vb = (ib >= 0) & ps_b.valid[jnp.maximum(ib, 0)]
    da = ps_a.desc[jnp.maximum(ia, 0)]
    db = ps_b.desc[jnp.maximum(ib, 0)]
    dist = matching.hamming_matrix(da, db)
    idx, best, ok = matching.match_nn(dist, va, vb, max_dist=max_dist, ratio=0.9)
    ok = matching.mutual_consistency(idx, ok, dist, va, vb)
    xa = ps_a.x[jnp.maximum(ia, 0)]
    xb = ps_b.x[jnp.maximum(ib[idx], 0)]
    ok = ok & va & vb[idx]
    return xa, xb, jnp.where(ok, ib[idx], -1), ok


def scene_scaled_thresh(x, mask, frac: float = 0.06, floor: float = 1e-3):
    """Scale-aware RANSAC inlier threshold: a fraction of the matched
    landmark cloud's median spread, so verification behaves identically
    on a metric EuRoC-scale map and a mono map normalized to unit median
    depth (a fixed threshold in absolute meters — round-3 Weak #7 — is
    generous at one scale and absurd at the other)."""
    c = jnp.sum(jnp.where(mask[:, None], x, 0.0), axis=0) / jnp.maximum(mask.sum(), 1)
    d = jnp.linalg.norm(x - c, axis=-1)
    spread = jnp.nanmedian(jnp.where(mask, d, jnp.nan))
    spread = jnp.where(jnp.isfinite(spread), spread, 1.0)
    return jnp.maximum(frac * spread, floor)


def projection_support(
    cam,
    kstore: st.KeyFrameStore,
    pstore: st.PointStore,
    kf_obs,  # KF whose observations vote (current / previous KF)
    kf_src,  # candidate loop KF whose landmarks are projected
    R_rel, t_rel, s_rel,  # verified Sim3: x_loop = s R x_cur + t
    radius: float = 10.0,
    max_dist: float = 60.0,
):
    """Count loop-region landmarks that, mapped into the current region
    by the INVERSE of the verified Sim3 and projected into `kf_obs`'s
    camera, land on one of that keyframe's observed landmarks (window +
    descriptor gate).

    This is the reference's projection re-verification: a candidate only
    stands if its map re-projects consistently into the current
    keyframes (DetectAndReffineSim3FromLastKF / the nNumProjMatches
    gates, src/LoopClosing.cc:429,476) — and it is deliberately STRICTER
    than the 3D-3D RANSAC gate: the RANSAC only explains the matched
    subset, the projection gate demands the candidate's wider map fit.
    """
    from pli_slam_tpu.ops import camera as cam_ops

    ia = kstore.obs_pt[kf_src]
    va = (ia >= 0) & pstore.valid[jnp.maximum(ia, 0)]
    X_loop = pstore.x[jnp.maximum(ia, 0)]
    Ri, ti, si = lie.sim3_inverse(R_rel, t_rel, jnp.asarray(s_rel))
    X_cur = si * lie._einsum("ij,nj->ni", Ri, X_loop) + ti
    xc = lie._einsum("ij,nj->ni", kstore.R[kf_obs], X_cur) + kstore.t[kf_obs]
    uv = cam_ops.project(cam, xc)
    va = va & (xc[:, 2] > 0.1) & cam_ops.in_image(cam, uv, margin=-radius)

    ib = kstore.obs_pt[kf_obs]
    vb = (ib >= 0) & pstore.valid[jnp.maximum(ib, 0)]
    uv_obs = kstore.obs_uvr[kf_obs][:, :2]
    da = pstore.desc[jnp.maximum(ia, 0)]
    db = pstore.desc[jnp.maximum(ib, 0)]
    dist = matching.hamming_matrix(da, db)
    gate = matching.window_gate(uv, uv_obs, radius) & vb[None, :]
    idx, best, ok = matching.match_nn(dist, va, vb, gate, max_dist=max_dist)
    return jnp.sum(ok.astype(jnp.int32))


def apply_loop_correction(
    kstore: st.KeyFrameStore,
    pstore: st.PointStore,
    lstore: st.LineStore,
    n_kf: int,
    kf_cur: int,
    kf_loop: int,
    R_rel, t_rel,  # verified relative transform: maps current-region world
    cfg: SlamConfig,
    inertial: bool = False,
    s_rel=None,  # verified scale (mono loop with drift); None/1 = rigid
):
    """Essential-graph correction + landmark re-anchoring.

    The loop edge constrains T_cur relative to T_loop with the verified
    measurement. Landmarks move with their last-observing keyframe.

    With `s_rel` (mono): the verified map is a full Sim3 and the pose
    graph runs in 7-DoF sim3 mode so accumulated scale drift distributes
    over the trajectory (reference OptimizeEssentialGraph with
    bFixScale=false, src/Optimizer.cc:2437; Sim3Solver scale dispatch
    src/LoopClosing.cc:448). Poses are SE3-ified afterwards (t /= s,
    reference CorrectLoop src/LoopClosing.cc:954).
    """
    K = kstore.R.shape[0]
    valid = kstore.valid
    with_scale = s_rel is not None
    s_rel = jnp.asarray(1.0) if s_rel is None else jnp.asarray(s_rel)
    # essential graph: sequential spanning-tree edges + covisibility edges
    # (reference OptimizeEssentialGraph input set, src/Optimizer.cc:2437)
    ci, cj, cR, ct, cs, cmask = pgo.chain_edges(kstore.R, kstore.t, jnp.ones(K), valid)
    vi, vj, vR, vt, vs, vmask = pgo.covis_edges(
        kstore.R, kstore.t, jnp.ones(K), valid, kstore.covis
    )
    ci = jnp.concatenate([ci, vi])
    cj = jnp.concatenate([cj, vj])
    cR = jnp.concatenate([cR, vR])
    ct = jnp.concatenate([ct, vt])
    cs = jnp.concatenate([cs, vs])
    cmask = jnp.concatenate([cmask, vmask])
    # loop edge: measured relative Sim3 loop->cur. The verified transform
    # maps world points of the current region onto the loop region:
    # x_loop = s R x_cur + t. Constraint on poses: S_cur_corrected =
    # T_cur ∘ S^-1 (points move by S), so measured S_cur_loop =
    # T_cur ∘ S^-1 ∘ T_loop^-1 (all composed as Sim3, camera poses s=1).
    R_s_inv, t_s_inv, s_s_inv = lie.sim3_inverse(R_rel, t_rel, s_rel)
    Rc, tc, sc = lie.sim3_compose(
        kstore.R[kf_cur], kstore.t[kf_cur], jnp.asarray(1.0), R_s_inv, t_s_inv, s_s_inv
    )
    Rl_inv, tl_inv = lie.se3_inverse(kstore.R[kf_loop], kstore.t[kf_loop])
    Rm, tm, sm = lie.sim3_compose(Rc, tc, sc, Rl_inv, tl_inv, jnp.asarray(1.0))

    e_i = jnp.concatenate([ci, jnp.asarray([kf_loop], jnp.int32)])
    e_j = jnp.concatenate([cj, jnp.asarray([kf_cur], jnp.int32)])
    e_R = jnp.concatenate([cR, Rm[None]])
    e_t = jnp.concatenate([ct, tm[None]])
    e_s = jnp.concatenate([cs, sm[None]])
    e_w = jnp.concatenate([jnp.ones(ci.shape[0]), jnp.asarray([5.0])])
    e_mask = jnp.concatenate([cmask, jnp.ones(1, bool)])

    graph = pgo.PoseGraph(
        R=kstore.R, t=kstore.t, s=jnp.ones(K),
        node_mask=valid,
        fixed_mask=jnp.zeros(K, bool).at[kf_loop].set(True) | ~valid,
        e_i=e_i, e_j=e_j, e_R=e_R, e_t=e_t, e_s=e_s, e_weight=e_w, e_mask=e_mask,
    )
    # inertial maps are gravity-aligned: only yaw + translation may move
    # (reference dispatch at LoopClosing.cc:1062 — OptimizeEssentialGraph4DoF
    # when IMU is initialized, 6-DoF otherwise; 7-DoF sim3 for mono)
    mode = "4dof" if inertial else ("sim3" if with_scale else "se3")
    out = pgo.optimize(graph, iters=cfg.opt.pgo_iters, mode=mode)

    # landmark re-anchoring: X' = S_new^-1(k) T_cw_old(k) X, k = last_kf
    # (old poses are SE3; new poses are Sim3 with s=1 except sim3 mode)
    R_old, t_old = kstore.R, kstore.t
    R_new, t_new, s_new = out.R, out.t, out.s
    Rw_new = jnp.swapaxes(R_new, -1, -2)

    def correct_points(x, ref_kf, valid_lm):
        Ro = R_old[ref_kf]
        to = t_old[ref_kf]
        x_c = jnp.einsum("kij,kj->ki", Ro, x, precision=_HI) + to
        # inverse Sim3 of the new pose: x = (1/s) R^T (x_c - t)
        x_n = jnp.einsum(
            "kij,kj->ki", Rw_new[ref_kf], x_c - t_new[ref_kf], precision=_HI
        ) / s_new[ref_kf][:, None]
        return jnp.where(valid_lm[:, None], x_n, x)

    ref_pt = jnp.clip(pstore.last_kf, 0, K - 1)
    pstore = dataclasses.replace(
        pstore, x=correct_points(pstore.x, ref_pt, pstore.valid)
    )
    ref_ln = jnp.clip(lstore.last_kf, 0, K - 1)
    lstore = dataclasses.replace(
        lstore,
        seg=jnp.concatenate(
            [
                correct_points(lstore.seg[:, :3], ref_ln, lstore.valid),
                correct_points(lstore.seg[:, 3:], ref_ln, lstore.valid),
            ],
            axis=-1,
        ),
    )
    # SE3-ify: [sR | t] ~ [R | t/s] (reference CorrectLoop :954)
    kstore = dataclasses.replace(kstore, R=R_new, t=t_new / s_new[:, None])
    return kstore, pstore, lstore


class LoopCloser:
    """Host-side loop closing state machine.

    Detection (BoW index + query) runs INSIDE the tracker's fused
    per-frame program — the per-KF candidate arrives in the stats vector
    for free. This class holds only the host-side rare-path logic: the
    temporal-consistency counter (reference LoopClosing.cc:306) and, on
    a confirmed hit, geometric verification + correction + global BA.
    """

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self._consistent_with = -1
        self._consistency = 0
        self.n_loops_closed = 0
        self._last_closed_kf = -10 ** 9
        self._match = jax.jit(match_kf_landmarks)
        # pure mono accumulates scale drift: estimate Sim3 scale and
        # correct it through the 7-DoF pose graph (reference bFixScale =
        # stereo-or-IMU, src/LoopClosing.cc:448); every other sensor is
        # metric and the loop is rigid
        self.with_scale = cfg.sensor == "mono"
        self._ransac = jax.jit(
            lambda x, y, m, key: sim3.ransac_sim3(
                x, y, m, key, n_hypotheses=cfg.loop.sim3_hypotheses,
                inlier_thresh=scene_scaled_thresh(x, m),
                with_scale=self.with_scale,
            )
        )
        self._proj_support = jax.jit(projection_support, static_argnames=("radius", "max_dist"))
        # the correction (essential-graph PGO + landmark re-anchoring)
        # MUST be jitted: run eagerly, its ~20 GN iterations decompose
        # into thousands of per-op dispatches on every loop-closure frame
        self._correct = jax.jit(
            apply_loop_correction,
            static_argnames=("n_kf", "cfg", "inertial"),
        )

    def on_keyframe(self, tracker, kf_slot: int, candidates) -> bool:
        """Consume the fused step's loop candidates for keyframe kf_slot
        (list of (slot, bow_score), best first — the reference verifies
        the 3 best BoW candidates, DetectNBestCandidates(3) ->
        DetectCommonRegionsFromBoW, src/LoopClosing.cc:395-476). Returns
        True if a loop was verified and closed (tracker stores updated in
        place)."""
        cfg = self.cfg
        if kf_slot - self._last_closed_kf < cfg.loop.min_kf_gap:
            return False
        candidates = [(s, sc) for s, sc in candidates if s >= 0 and sc >= 0.15]
        if not candidates:
            self._consistency = 0
            self._consistent_with = -1
            return False
        # temporal consistency: SOME candidate must persist near the same
        # past keyframe across consecutive KFs
        best = -1
        for s, sc in candidates:
            if self._consistent_with >= 0 and abs(s - self._consistent_with) <= 3:
                best = s
                break
        if best >= 0:
            self._consistency += 1
            self._consistent_with = best
        else:
            self._consistency = 1
            self._consistent_with = candidates[0][0]
        if self._consistency < cfg.loop.consistency_kfs:
            return False

        # geometric verification of each surviving candidate, best first:
        # 3D-3D RANSAC, then the stricter projection re-check — the
        # candidate's wider map must re-project onto the current AND
        # previous keyframes' observations (reference
        # DetectAndReffineSim3FromLastKF, src/LoopClosing.cc:429; a
        # perceptually-aliased candidate whose RANSAC only explains the
        # matched subset dies here)
        verified = None
        for s, sc in candidates:
            x, y, m = self._match(tracker.kstore, tracker.pstore, kf_slot, s)
            key = jax.random.PRNGKey(kf_slot * 7 + s)
            R_rel, t_rel, s_rel, inl, n_in = self._ransac(x, y, m, key)
            if int(n_in) < cfg.loop.sim3_min_inliers:
                continue
            n_cur = int(self._proj_support(
                tracker.cam, tracker.kstore, tracker.pstore,
                kf_slot, s, R_rel, t_rel, s_rel,
                radius=cfg.loop.proj_radius_px,
            ))
            n_prev = int(self._proj_support(
                tracker.cam, tracker.kstore, tracker.pstore,
                max(kf_slot - 1, 0), s, R_rel, t_rel, s_rel,
                radius=cfg.loop.proj_radius_px,
            )) if kf_slot >= 1 else n_cur
            if n_cur >= cfg.loop.proj_min_inliers and n_prev >= cfg.loop.proj_min_inliers // 2:
                verified = (s, R_rel, t_rel, s_rel)
                break
        if verified is None:
            return False
        best, R_rel, t_rel, s_rel = verified

        inertial = bool(getattr(tracker, "imu_ready", False))
        # current-pose carry: the correction moves every keyframe; the
        # live tracker pose (1-2 frames past kf_slot in streaming mode)
        # must ride the SAME rigid delta as its reference keyframe, not
        # be teleported onto the stale keyframe pose
        R_kf0 = tracker.kstore.R[kf_slot]
        t_kf0 = tracker.kstore.t[kf_slot]
        tracker.kstore, tracker.pstore, tracker.lstore = self._correct(
            tracker.kstore, tracker.pstore, tracker.lstore,
            int(tracker.n_kf), jnp.asarray(kf_slot, jnp.int32),
            jnp.asarray(best, jnp.int32), R_rel, t_rel, cfg,
            inertial=inertial,
            s_rel=s_rel if self.with_scale else None,
        )
        # global BA refines the whole corrected map (reference: the
        # transient RunGlobalBundleAdjustment thread, LoopClosing.cc:1087,
        # :2243-2391). Default: AMORTIZED — the PGO-corrected map is
        # usable now and bounded refinement chunks run one per subsequent
        # frame (tracker.run_deferred_ba), so the loop-closure frame does
        # not blow the real-time budget with a full-map solve.
        if cfg.loop.run_gba:
            if cfg.loop.gba_amortize and hasattr(tracker, "_queue_gba"):
                tracker._queue_gba(inertial)
            elif inertial:
                # inertial maps refine velocities/biases jointly after the
                # pose-graph correction (reference dispatches FullInertialBA
                # from RunGlobalBundleAdjustment, src/LoopClosing.cc:2250)
                tracker._full_inertial_ba()
            else:
                from pli_slam_tpu.frontend import tracker as trk

                gba = getattr(tracker, "_gba_j", None) or partial(
                    trk.global_ba, tracker.cam, cfg
                )
                tracker.kstore, tracker.pstore, tracker.lstore = gba(
                    tracker.kstore, tracker.pstore, tracker.lstore
                )
        # tracking continues from the corrected pose: apply the keyframe's
        # correction delta T_kf_new ∘ T_kf_old^-1 to the live frame pose
        R_kf1 = tracker.kstore.R[kf_slot]
        t_kf1 = tracker.kstore.t[kf_slot]
        R_d = lie._mm(R_kf1, R_kf0.T)
        t_d = t_kf1 - lie._einsum("ij,j->i", R_d, t_kf0)
        tracker.t = lie._einsum("ij,j->i", R_d, tracker.t) + t_d
        tracker.R = lie._mm(R_d, tracker.R)
        tracker._reset_motion()
        if hasattr(tracker, "_map_event_cooldown"):
            tracker._map_event_cooldown = 5  # widened matching while re-locking
        self.n_loops_closed += 1
        self._last_closed_kf = kf_slot
        self._consistency = 0
        self._consistent_with = -1
        return True
