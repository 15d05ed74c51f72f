"""Tracking: per-frame pose estimation against the landmark stores.

JAX replacement for the reference's Tracking thread state machine
(reference: src/Tracking.cc — `Track()` :1356,
`TrackWithMotionModelWithLine` :3024, `TrackLocalMap` :3269,
`SearchLocalPointsAndLines` :3767, `NeedNewKeyFrame` :3407,
`CreateNewKeyFrame` :3573, `StereoInitialization` :1928).

Design inversion (SURVEY.md §7.1): instead of grid-bucket projection
searches, the frame is matched against a covisibility local map (or, on
keyframes, the whole point store) in one gated int8 matmul; frustum +
window gates replace the grid buckets.

Two match/solve rounds mirror the reference's motion-model stage then
track-local-map stage; both run inside one jitted `track_step`. The
branchy outer state machine (OK / RECENTLY_LOST / LOST, keyframe
decision) stays on the host, as planned in SURVEY.md §7.3 item 3.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.frontend.frame import FrameData, make_build_frame
from pli_slam_tpu.ops import camera as cam_ops
from pli_slam_tpu.ops import lie, matching
from pli_slam_tpu.ops.camera import Camera
from pli_slam_tpu.solve import gn
from pli_slam_tpu.solve import ba as ba_mod
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu.worldmap import stores as st

_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Jitted device programs
# ---------------------------------------------------------------------------


def _match_points_against_store(cam, cfg, frame: FrameData, R, t, pstore: st.PointStore, radius, local_ids=None):
    """Gated dense match: frame features vs the point store.

    One s8 x s8 -> s32 descriptor product, the window/frustum gate and a
    row-wise (best, second, argmin) reduction, left to XLA to fuse.

    `local_ids` ([C] int32, -1 padded): match against this LOCAL-MAP
    subset instead of every store slot — the reference matches the local
    map (covisibility neighborhood of the reference KF), not the whole
    Atlas (Tracking::SearchLocalPoints, src/Tracking.cc:3767); at
    production capacity that is 4096 candidate rows instead of 16384,
    ~4x less matching work per round. Returns idx in GLOBAL store slots
    either way; the third output is (row_ids, frustum_rows) for the
    visible-counter update.
    """
    if local_ids is None:
        x = pstore.x
        desc = pstore.desc
        valid = pstore.valid
        row_ids = None
    else:
        safe = jnp.maximum(local_ids, 0)
        x = pstore.x[safe]
        desc = pstore.desc[safe]
        valid = pstore.valid[safe] & (local_ids >= 0)
        row_ids = local_ids
    xc = lie._einsum("ij,pj->pi", R, x) + t
    uv_proj = cam_ops.project(cam, xc)
    frustum = valid & (xc[:, 2] > 0.1) & cam_ops.in_image(cam, uv_proj, margin=-radius)
    gate = matching.window_gate(frame.feats.uv, uv_proj, radius) & frustum[None, :]
    dist = matching.hamming_matrix(frame.feats.desc, desc)
    idx, best, ok = matching.match_nn(
        dist, frame.feats.valid, valid, gate, max_dist=cfg.match.orb_th_high, ratio=cfg.match.nn_ratio
    )
    ok = matching.dedup_matches(idx, best, ok, x.shape[0])
    if local_ids is not None:
        idx = jnp.where(ok, local_ids[jnp.maximum(idx, 0)], -1)
    return idx, ok, (row_ids, frustum)


def _match_lines_against_store(cam, cfg, frame: FrameData, R, t, lstore: st.LineStore, radius):
    """Match frame line segments vs line store by projected-midpoint window + angle."""
    xs_c = lie._einsum("ij,pj->pi", R, lstore.seg[:, :3]) + t
    xe_c = lie._einsum("ij,pj->pi", R, lstore.seg[:, 3:]) + t
    uv_s = cam_ops.project(cam, xs_c)
    uv_e = cam_ops.project(cam, xe_c)
    mid_proj = 0.5 * (uv_s + uv_e)
    infront = (xs_c[:, 2] > 0.1) & (xe_c[:, 2] > 0.1)
    frustum = lstore.valid & infront & cam_ops.in_image(cam, mid_proj, margin=-2 * radius)
    ang_proj = jnp.arctan2(uv_e[:, 1] - uv_s[:, 1], uv_e[:, 0] - uv_s[:, 0])
    da = jnp.abs(frame.lines.angle[:, None] - ang_proj[None, :])
    da = jnp.minimum(da, 2 * jnp.pi - da)
    da = jnp.minimum(da, jnp.pi - da)
    gate = (
        matching.window_gate(frame.lines.midpoint(), mid_proj, 2.0 * radius)
        & (da <= jnp.deg2rad(12.0))
        & frustum[None, :]
    )
    dist = matching.hamming_matrix(frame.lines.desc, lstore.desc)
    idx, best, ok = matching.match_nn(
        dist, frame.lines.valid, lstore.valid, gate, max_dist=90.0, ratio=0.95
    )
    ok = matching.dedup_matches(idx, best, ok, lstore.seg.shape[0])
    return idx, ok, frustum


def _pose_obs_from_matches(cfg, frame: FrameData, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok):
    uvr = jnp.concatenate([frame.feats.uv, frame.u_right[:, None]], axis=-1)
    safe_pt = jnp.maximum(pt_idx, 0)
    safe_ln = jnp.maximum(ln_idx, 0)
    return gn.PoseObservations(
        x_w=pstore.x[safe_pt],
        uvr=uvr,
        stereo_mask=frame.stereo_ok,
        point_mask=pt_ok & frame.feats.valid,
        sigma2_pt=frame.sigma2,
        xs_w=lstore.seg[safe_ln, :3],
        xe_w=lstore.seg[safe_ln, 3:],
        l_obs=frame.lines.line_coeffs(),
        line_mask=ln_ok & frame.lines.valid,
        sigma2_ln=jnp.full_like(frame.lines.angle, cfg.lines.sigma_px ** 2),
    )


def track_step(cam, cfg: SlamConfig, frame: FrameData, R0, t0, pstore: st.PointStore, lstore: st.LineStore, wide=False, local_pt_ids=None):
    """Two-round match+solve. Returns refined pose, per-slot associations,
    inlier masks, and stores with updated visible/found counters.

    `wide` (traced bool): triple the round-1 search window. Used when no
    motion model exists (right after init / reloc / loss) — the pose
    prediction is then a zero-velocity hold and the true inter-frame
    displacement can far exceed the nominal window (the reference's
    no-velocity path, TrackReferenceKeyFrameWithLine, matches by BoW
    with NO projection window at all, src/Tracking.cc:2708)."""
    r1 = jnp.where(wide, 3.0 * cfg.match.search_radius_px, cfg.match.search_radius_px)
    pt_idx, pt_ok, _ = _match_points_against_store(cam, cfg, frame, R0, t0, pstore, r1, local_pt_ids)
    ln_idx, ln_ok, _ = _match_lines_against_store(cam, cfg, frame, R0, t0, lstore, r1)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    res1 = gn.solve_pose(cam, obs, R0, t0, cfg.opt)

    # round 2: re-match with the refined pose, tighter window (the
    # reference's TrackLocalMap with th=1-2); based on the nominal
    # radius — round 1 already absorbed the large displacement
    r2 = max(cfg.match.search_radius_px * 0.4, 4.0)
    pt_idx, pt_ok, pt_frust = _match_points_against_store(cam, cfg, frame, res1.R_cw, res1.t_cw, pstore, r2, local_pt_ids)
    ln_idx, ln_ok, ln_frust = _match_lines_against_store(cam, cfg, frame, res1.R_cw, res1.t_cw, lstore, r2)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    res2 = gn.solve_pose(cam, obs, res1.R_cw, res1.t_cw, cfg.opt)

    pt_in = pt_ok & res2.inlier_pt
    ln_in = ln_ok & res2.inlier_ln
    # bookkeeping counters (reference IncreaseVisible/IncreaseFound)
    frust_ids, frust_rows = pt_frust
    if frust_ids is None:
        visible = pstore.visible + frust_rows.astype(jnp.int32)
    else:
        visible = pstore.visible.at[jnp.maximum(frust_ids, 0)].add(
            (frust_rows & (frust_ids >= 0)).astype(jnp.int32)
        )
    pstore = dataclasses.replace(
        pstore,
        visible=visible,
        found=pstore.found.at[jnp.maximum(pt_idx, 0)].add(pt_in.astype(jnp.int32)),
    )
    lstore = dataclasses.replace(
        lstore,
        visible=lstore.visible + ln_frust.astype(jnp.int32),
        found=lstore.found.at[jnp.maximum(ln_idx, 0)].add(ln_in.astype(jnp.int32)),
    )
    n_in = jnp.sum(pt_in.astype(jnp.int32)) + jnp.sum(ln_in.astype(jnp.int32))
    return res2.R_cw, res2.t_cw, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore


def _local_map_ids(cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore, kf_slot):
    """Local-map point ids [C] (-1 padded): the landmarks observed by
    keyframe `kf_slot` and its top covisible neighbors (reference
    Tracking::UpdateLocalKeyFrames + UpdateLocalPoints,
    src/Tracking.cc:3942-3988). Refreshed at every keyframe; per-frame
    tracking then matches against this subset instead of the full store."""
    K = kstore.covis.shape[0]
    C = min(cfg.map.local_map_points, cfg.map.max_points)
    J = min(cfg.map.local_map_kfs, K)
    w = jnp.where(
        kstore.valid & (jnp.arange(K) != kf_slot), kstore.covis[kf_slot], -1
    )
    nb_w, nb = jax.lax.top_k(w, max(J - 1, 1))
    rows = jnp.concatenate([jnp.asarray(kf_slot, jnp.int32)[None], nb.astype(jnp.int32)])
    row_ok = jnp.concatenate([jnp.ones(1, bool), nb_w > 0])
    obs = kstore.obs_pt[rows]  # [J, S]
    P = pstore.x.shape[0]
    ids = jnp.where(row_ok[:, None] & (obs >= 0), obs, P).reshape(-1)
    uniq = jnp.unique(ids, size=C, fill_value=P)
    return jnp.where(uniq < P, uniq, -1).astype(jnp.int32)


def _empty_local_map(cfg: SlamConfig):
    C = min(cfg.map.local_map_points, cfg.map.max_points)
    return jnp.full(C, -1, jnp.int32)


N_TRI_VIEWS = 3  # recent-KF views searched for triangulation


def _empty_kf_views(cfg: SlamConfig):
    """Empty recent-KF view ring (slot -1: contributes nothing).

    Entries are (uv, desc, valid, kf_slot). Poses are NOT stored — they
    are read live from the keyframe store at triangulation time, so BA /
    loop refinements of past keyframes are always reflected (a pose
    snapshot goes stale after the next windowed BA and triangulates
    against wrong geometry)."""
    nfe = cfg.orb.n_features
    V = N_TRI_VIEWS
    return (
        jnp.zeros((V, nfe, 2)), jnp.zeros((V, nfe, 256), jnp.int8),
        jnp.zeros((V, nfe), bool), jnp.full(V, -1, jnp.int32),
    )


def far_point_depths(cam, cfg: SlamConfig, frame: FrameData, R, t, kf_views, kstore):
    """Depth channel for features beyond reliable stereo range, confirmed
    by epipolar triangulation against RECENT KEYFRAME VIEWS (reference:
    LocalMapping::CreateNewMapPoints src/LocalMapping.cc:343 searches
    10-20 covisible keyframes + ORBmatcher::SearchForTriangulation —
    far points need a second view, and low-parallax motion needs a view
    with enough baseline, which the single previous KF rarely has).

    `kf_views` = (uv [V,N,2], desc [V,N,256], valid [V,N], slot [V]) — a
    ring of the last V keyframes' views; poses are read LIVE from
    `kstore` at the stored slots. Each view is matched and triangulated
    independently (vmap); per feature the NEWEST confirming view wins
    (ring is newest-first) and older views only fill low-parallax gaps —
    best-parallax selection was tried and regressed accuracy (see the
    inline note below). Returns [N] triangulated depth in the CURRENT
    camera (-1 where unconfirmed).
    """
    from pli_slam_tpu.solve import triangulate as tri

    kf_uv, kf_desc, kf_valid, kf_slot = kf_views
    R_kf = kstore.R[jnp.maximum(kf_slot, 0)]
    t_kf = kstore.t[jnp.maximum(kf_slot, 0)]
    kf_valid = kf_valid & (kf_slot >= 0)[:, None]

    def one_view(uv_v, desc_v, valid_v, R_v, t_v):
        dist = matching.hamming_matrix(frame.feats.desc, desc_v)
        idx, best, ok = matching.match_nn(
            dist, frame.feats.valid, valid_v, max_dist=cfg.match.orb_th_low, ratio=0.8
        )
        ok = matching.mutual_consistency(idx, ok, dist, frame.feats.valid, valid_v)
        uv1 = uv_v[jnp.maximum(idx, 0)]
        ray1 = cam_ops.unproject(cam, uv1)
        ray2 = cam_ops.unproject(cam, frame.feats.uv)
        # DLT beats midpoint at far geometry (midpoint biases toward the
        # cameras at low parallax — measurably worse on the far-scene
        # test); the 4x4 eigh cost is per-KF only
        X = tri.triangulate_dlt(R_v, t_v, R, t, ray1, ray2)
        good = tri.triangulation_checks(
            cam, R_v, t_v, R, t, X, uv1, frame.feats.uv, frame.sigma2, frame.sigma2
        )
        z = lie.se3_apply(R, t, X)[:, 2]
        # parallax conditioning: smaller ray-angle cosine = wider baseline
        Rw1, tw1 = lie.se3_inverse(R_v, t_v)
        Rw2, tw2 = lie.se3_inverse(R, t)
        r1 = X - tw1
        r2 = X - tw2
        cos_par = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
        )
        confirmed = ok & good & (z > 0.05)
        return jnp.where(confirmed, z, -1.0), jnp.where(confirmed, cos_par, 2.0)

    zs, cps = jax.vmap(one_view)(kf_uv, kf_desc, kf_valid, R_kf, t_kf)  # [V,N]
    # newest confirming view wins (ring is newest-first): identical to the
    # single-last-KF channel whenever that view confirms; older views only
    # FILL GAPS (low-parallax motion where the last KF's baseline is too
    # short). Best-parallax selection was tried and regressed accuracy:
    # wide-baseline matches from old views alias more often.
    confirmed = cps < 1.5
    pick = jnp.argmax(confirmed, axis=0)  # first True in ring order
    z_best = jnp.take_along_axis(zs, pick[None], axis=0)[0]
    any_ok = jnp.any(confirmed, axis=0)
    return jnp.where(any_ok, z_best, -1.0)


def insert_keyframe(
    cam,
    cfg: SlamConfig,
    frame: FrameData,
    R,
    t,
    stamp,
    pt_idx,
    pt_in,
    ln_idx,
    ln_in,
    kf_slot,
    pstore: st.PointStore,
    lstore: st.LineStore,
    kstore: st.KeyFrameStore,
    tri_depth=None,
):
    """Create a keyframe: allocate new landmarks from stereo, write the
    observation tables, update landmark bookkeeping, cull bad landmarks.

    (reference: Tracking::CreateNewKeyFrame :3573 + StereoInitialization
    landmark creation + LocalMapping::MapPointCulling :301)

    `tri_depth` [N] (-1 invalid): triangulated depths from
    far_point_depths — the creation channel for features beyond the
    close-stereo cap, mirroring the reference's two-view far points.
    """
    R_wc = R.T
    t_wc = -lie._einsum("ij,j->i", R.T, t)

    # ---- new point landmarks from unmatched features with depth ---------
    # Close points create directly from stereo depth (reference gates at
    # mThDepth ~ 40*baseline; we keep a looser 120*baseline cap). Farther
    # features need triangulated confirmation from a second view.
    max_depth = jnp.where(cam.bf > 0, 120.0 * cam.bf / cam.fx, jnp.inf)
    depth_ok = (frame.depth > 0) & (frame.depth < max_depth)
    if tri_depth is not None:
        far_ok = (tri_depth > 0) & ~depth_ok
        # far stereo depths agreeing with triangulation use the (metric)
        # stereo value; otherwise the triangulated depth itself
        agree = (frame.depth > 0) & (
            jnp.abs(frame.depth - tri_depth) < 0.25 * jnp.maximum(tri_depth, 1e-3)
        )
        frame = dataclasses.replace(
            frame,
            depth=jnp.where(
                depth_ok, frame.depth,
                jnp.where(far_ok, jnp.where(agree, frame.depth, tri_depth), -1.0),
            ),
        )
        depth_ok = frame.depth > 0
    want_new = frame.feats.valid & depth_ok & ~(pt_in & (pt_idx >= 0))
    x_c = cam_ops.unproject(cam, frame.feats.uv) * frame.depth[:, None]
    x_w = lie._einsum("ij,nj->ni", R_wc, x_c) + t_wc

    # ---- fuse-before-create (reference ORBmatcher::Fuse semantics) ------
    # A feature whose tracking match failed would otherwise spawn a
    # duplicate of an existing landmark; duplicates then defeat the
    # ratio test and collapse tracking. Re-associate candidates to the
    # store by proximity (depth-proportional radius) + descriptor. The
    # 3D ball test ||x_w - p|| <= 0.05 z decomposes into a projected 2D
    # window (~0.05 fx px, one [N,P] matmul) and a 1D depth band, so no
    # [N,P,3] difference tensor is materialized on every keyframe.
    xc_store = lie._einsum("ij,pj->pi", R, pstore.x) + t  # [P,3] current cam
    z_store = xc_store[:, 2]
    uv_store = cam_ops.project(cam, xc_store)
    gate2d = matching.window_gate(frame.feats.uv, uv_store, 0.05 * cam.fx)
    zgate = jnp.abs(z_store[None, :] - x_c[:, 2:3]) <= 0.05 * jnp.maximum(x_c[:, 2:3], 1e-3)
    fuse_gate = gate2d & zgate & (z_store > 0.05)[None, :] & pstore.valid[None, :]
    fuse_dist = matching.hamming_matrix(frame.feats.desc, pstore.desc)
    fuse_idx, fuse_best, fuse_ok = matching.match_nn(
        fuse_dist, want_new, pstore.valid, fuse_gate, max_dist=64.0
    )
    fuse_ok = matching.dedup_matches(fuse_idx, fuse_best, fuse_ok, pstore.x.shape[0])
    want_new = want_new & ~fuse_ok
    # per-KF creation budget, closest-first (reference CreateNewKeyFrame
    # creates all close stereo points but caps the sorted-by-depth tail
    # at ~100, src/Tracking.cc:3573): without a cap a long run fills the
    # entire point store (~380 new landmarks/KF observed) and matching
    # quality collapses. KF0 (bootstrap) keeps the full budget.
    cap = min(cfg.tracking.kf_max_new_points, want_new.shape[0])
    if cap < want_new.shape[0]:
        create_score = jnp.where(want_new, 1.0 / jnp.maximum(frame.depth, 1e-3), -1.0)
        kth = jax.lax.top_k(create_score, cap)[0][-1]
        keep = (create_score >= jnp.maximum(kth, 1e-9)) & (create_score > 0)
        want_new = want_new & jnp.where(kf_slot > 0, keep, True)
    slots, ok_new = st.alloc_slots(~pstore.valid, want_new)
    safe_slots = jnp.maximum(slots, 0)
    pstore = dataclasses.replace(
        pstore,
        x=pstore.x.at[safe_slots].set(jnp.where(ok_new[:, None], x_w, pstore.x[safe_slots])),
        desc=pstore.desc.at[safe_slots].set(
            jnp.where(ok_new[:, None], frame.feats.desc, pstore.desc[safe_slots])
        ),
        valid=pstore.valid.at[safe_slots].set(ok_new | pstore.valid[safe_slots]),
        n_obs=pstore.n_obs.at[safe_slots].set(
            jnp.where(ok_new, 1, pstore.n_obs[safe_slots])
        ),
        visible=pstore.visible.at[safe_slots].set(
            jnp.where(ok_new, 1, pstore.visible[safe_slots])
        ),
        found=pstore.found.at[safe_slots].set(jnp.where(ok_new, 1, pstore.found[safe_slots])),
        first_kf=pstore.first_kf.at[safe_slots].set(
            jnp.where(ok_new, kf_slot, pstore.first_kf[safe_slots])
        ),
        last_kf=pstore.last_kf.at[safe_slots].set(
            jnp.where(ok_new, kf_slot, pstore.last_kf[safe_slots])
        ),
    )
    lm_id = jnp.where(
        ok_new, slots,
        jnp.where(fuse_ok, fuse_idx, jnp.where(pt_in, pt_idx, -1)),
    ).astype(jnp.int32)

    # seed the descriptor bank of freshly created landmarks (slot 0)
    B = st.DESC_BANK
    bank0 = jnp.zeros((frame.feats.desc.shape[0], B, 256), jnp.int8
                      ).at[:, 0].set(frame.feats.desc)
    pstore = dataclasses.replace(
        pstore,
        desc_bank=pstore.desc_bank.at[safe_slots].set(
            jnp.where(ok_new[:, None, None], bank0, pstore.desc_bank[safe_slots])
        ),
    )

    # distinctive-descriptor maintenance (reference
    # MapPoint::ComputeDistinctiveDescriptors, src/MapPoint.cc:300): each
    # re-observation enters a small ring bank of stored views; the
    # landmark's matching descriptor is the bank's min-sum-Hamming MEDOID
    # — a stable representative over viewpoints instead of the last view
    # (which random-walks with viewpoint and degrades long-gap revisits),
    # at O(B^2) per landmark instead of the reference's O(obs^2) rebuild.
    reobs = (pt_in & (pt_idx >= 0)) | fuse_ok
    safe_idx = jnp.maximum(jnp.where(fuse_ok, fuse_idx, pt_idx), 0)
    ring = pstore.n_obs[safe_idx] % B  # pre-increment write slot
    bank = pstore.desc_bank[safe_idx]  # [S,B,256]
    bank = jnp.where(
        (reobs[:, None] & (jnp.arange(B)[None, :] == ring[:, None]))[:, :, None],
        frame.feats.desc[:, None, :], bank,
    )
    n_after = pstore.n_obs[safe_idx] + 1
    slot_valid = jnp.arange(B)[None, :] < jnp.minimum(n_after, B)[:, None]  # [S,B]
    dots = jnp.einsum(
        "sbc,sdc->sbd", bank.astype(jnp.int32), bank.astype(jnp.int32)
    )
    dist = (256 - dots) // 2
    sums = jnp.sum(jnp.where(slot_valid[:, None, :], dist, 0), axis=-1)  # [S,B]
    sums = jnp.where(slot_valid, sums, 10 ** 9)
    medoid = jnp.argmin(sums, axis=-1)  # [S]
    desc_medoid = jnp.take_along_axis(bank, medoid[:, None, None], axis=1)[:, 0]
    pstore = dataclasses.replace(
        pstore,
        desc_bank=pstore.desc_bank.at[safe_idx].set(
            jnp.where(reobs[:, None, None], bank, pstore.desc_bank[safe_idx])
        ),
        desc=pstore.desc.at[safe_idx].set(
            jnp.where(reobs[:, None], desc_medoid, pstore.desc[safe_idx])
        ),
        n_obs=pstore.n_obs.at[safe_idx].add(reobs.astype(jnp.int32)),
        last_kf=pstore.last_kf.at[safe_idx].set(
            jnp.where(reobs, kf_slot, pstore.last_kf[safe_idx])
        ),
    )

    # ---- new line landmarks from stereo line disparities ---------------
    ln_depth_ok = frame.line_ok & jnp.all(frame.line_disp > 0.5, axis=-1)
    want_new_ln = frame.lines.valid & ln_depth_ok & ~(ln_in & (ln_idx >= 0))
    lslots, lok_new = st.alloc_slots(~lstore.valid, want_new_ln)
    xs_c = cam_ops.back_project_stereo(cam, frame.lines.p0, frame.line_disp[:, 0])
    xe_c = cam_ops.back_project_stereo(cam, frame.lines.p1, frame.line_disp[:, 1])
    seg_w = jnp.concatenate(
        [
            lie._einsum("ij,nj->ni", R_wc, xs_c) + t_wc,
            lie._einsum("ij,nj->ni", R_wc, xe_c) + t_wc,
        ],
        axis=-1,
    )
    safe_l = jnp.maximum(lslots, 0)
    lstore = dataclasses.replace(
        lstore,
        seg=lstore.seg.at[safe_l].set(jnp.where(lok_new[:, None], seg_w, lstore.seg[safe_l])),
        desc=lstore.desc.at[safe_l].set(
            jnp.where(lok_new[:, None], frame.lines.desc, lstore.desc[safe_l])
        ),
        valid=lstore.valid.at[safe_l].set(lok_new | lstore.valid[safe_l]),
        n_obs=lstore.n_obs.at[safe_l].set(jnp.where(lok_new, 1, lstore.n_obs[safe_l])),
        visible=lstore.visible.at[safe_l].set(jnp.where(lok_new, 1, lstore.visible[safe_l])),
        found=lstore.found.at[safe_l].set(jnp.where(lok_new, 1, lstore.found[safe_l])),
        first_kf=lstore.first_kf.at[safe_l].set(
            jnp.where(lok_new, kf_slot, lstore.first_kf[safe_l])
        ),
        last_kf=lstore.last_kf.at[safe_l].set(
            jnp.where(lok_new, kf_slot, lstore.last_kf[safe_l])
        ),
    )
    lml_id = jnp.where(lok_new, lslots, jnp.where(ln_in, ln_idx, -1)).astype(jnp.int32)
    reobs_l = ln_in & (ln_idx >= 0)
    # last_kf drives loop-correction re-anchoring (apply_loop_correction);
    # without it every line re-anchors through KF0, the PGO's fixed gauge,
    # i.e. lines would not move at loop closure (the very bug the reference
    # has for lines, src/LoopClosing.cc:912-991 — we fix it for real here).
    lstore = dataclasses.replace(
        lstore,
        n_obs=lstore.n_obs.at[jnp.maximum(ln_idx, 0)].add(reobs_l.astype(jnp.int32)),
        last_kf=lstore.last_kf.at[jnp.maximum(ln_idx, 0)].set(
            jnp.where(reobs_l, kf_slot, lstore.last_kf[jnp.maximum(ln_idx, 0)])
        ),
    )

    # ---- covisibility graph update (reference KeyFrame::UpdateConnections
    # src/KeyFrame.cc:539): count shared landmarks against every earlier
    # keyframe via the landmark->KF incidence bitsets, then record this
    # keyframe's bit on each observed landmark. Line observations count
    # too — the reference's line increment is commented out
    # (src/KeyFrame.cc:573-590), which mis-picks the BA window in
    # line-rich/point-poor scenes; fixed here.
    K = kstore.covis.shape[0]
    KW = pstore.obs_bits.shape[1]
    shifts = jnp.arange(32, dtype=jnp.uint32)

    def _incidence_counts(bits_words, has):
        unpacked = ((bits_words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)).astype(jnp.int32)
        unpacked = unpacked.reshape(bits_words.shape[0], -1)[:, :K]  # [S, K]
        return jnp.sum(jnp.where(has[:, None], unpacked, 0), axis=0)

    has_lm = lm_id >= 0
    safe_lm = jnp.maximum(lm_id, 0)
    words = pstore.obs_bits[safe_lm]  # [S, KW]
    has_lml = lml_id >= 0
    safe_lml = jnp.maximum(lml_id, 0)
    words_l = lstore.obs_bits[safe_lml]  # [S_l, KW]
    # freshly created landmarks are excluded from the count: they cannot
    # have been observed by an earlier KF, and their slot may carry stale
    # bits from a culled previous occupant
    covis_row = (
        _incidence_counts(words, has_lm & ~ok_new)
        + _incidence_counts(words_l, has_lml & ~lok_new)
    ).at[kf_slot].set(0)
    kstore = dataclasses.replace(
        kstore,
        covis=kstore.covis.at[kf_slot].set(covis_row).at[:, kf_slot].set(covis_row),
    )
    word_idx = kf_slot // 32
    bit_val = (jnp.uint32(1) << (kf_slot % 32).astype(jnp.uint32))
    col = jnp.arange(KW)[None, :] == word_idx

    cleared = jnp.where(ok_new[:, None], jnp.uint32(0), words)  # fresh slot: wipe stale bits
    stamped = jnp.where(col, cleared | bit_val, cleared)
    pstore = dataclasses.replace(
        pstore,
        obs_bits=pstore.obs_bits.at[safe_lm].set(
            jnp.where(has_lm[:, None], stamped, words)
        ),
    )
    cleared_l = jnp.where(lok_new[:, None], jnp.uint32(0), words_l)
    stamped_l = jnp.where(col, cleared_l | bit_val, cleared_l)
    lstore = dataclasses.replace(
        lstore,
        obs_bits=lstore.obs_bits.at[safe_lml].set(
            jnp.where(has_lml[:, None], stamped_l, words_l)
        ),
    )

    # ---- write the keyframe row -----------------------------------------
    uvr = jnp.concatenate([frame.feats.uv, frame.u_right[:, None]], axis=-1)
    kstore = dataclasses.replace(
        kstore,
        R=kstore.R.at[kf_slot].set(R),
        t=kstore.t.at[kf_slot].set(t),
        stamp=kstore.stamp.at[kf_slot].set(stamp),
        valid=kstore.valid.at[kf_slot].set(True),
        obs_pt=kstore.obs_pt.at[kf_slot].set(lm_id),
        obs_uvr=kstore.obs_uvr.at[kf_slot].set(uvr),
        obs_sigma2=kstore.obs_sigma2.at[kf_slot].set(frame.sigma2),
        obs_stereo=kstore.obs_stereo.at[kf_slot].set(frame.stereo_ok),
        obs_ln=kstore.obs_ln.at[kf_slot].set(lml_id),
        obs_l=kstore.obs_l.at[kf_slot].set(frame.lines.line_coeffs()),
        obs_ln_sigma2=kstore.obs_ln_sigma2.at[kf_slot].set(
            jnp.full_like(frame.lines.angle, cfg.lines.sigma_px ** 2)
        ),
    )

    # ---- landmark culling (reference MapPointCulling semantics) ---------
    # cull only YOUNG low-quality landmarks (the reference restricts
    # MapPointCulling to points created within the last 2-3 KFs)
    ratio = pstore.found.astype(jnp.float32) / jnp.maximum(pstore.visible.astype(jnp.float32), 1.0)
    young = (kf_slot - pstore.first_kf) <= 3
    bad = pstore.valid & young & (pstore.visible > 8) & (ratio < cfg.map.cull_found_ratio)
    pstore = dataclasses.replace(pstore, valid=pstore.valid & ~bad)
    ratio_l = lstore.found.astype(jnp.float32) / jnp.maximum(lstore.visible.astype(jnp.float32), 1.0)
    young_l = (kf_slot - lstore.first_kf) <= 3
    bad_l = lstore.valid & young_l & (lstore.visible > 8) & (ratio_l < cfg.map.cull_found_ratio)
    lstore = dataclasses.replace(lstore, valid=lstore.valid & ~bad_l)

    n_new = jnp.sum(ok_new.astype(jnp.int32))
    return pstore, lstore, kstore, n_new


def _compact_ids(obs_flat, obs_mask, capacity_sentinel, cap):
    """Unique observed landmark ids, fixed-size `cap`.

    Returns (uniq [cap] — observed ids sorted, padded with the sentinel;
    remapped obs ids [O] into 0..cap-1 or -1; surviving obs mask [O]).
    Overflow beyond `cap` drops the LARGEST ids' observations (graceful:
    they simply don't participate in this solve)."""
    ids = jnp.where(obs_mask, obs_flat, capacity_sentinel)
    uniq = jnp.unique(ids, size=cap, fill_value=capacity_sentinel)
    pos = jnp.clip(jnp.searchsorted(uniq, obs_flat), 0, cap - 1)
    hit = uniq[pos] == obs_flat
    mask = obs_mask & hit
    return uniq, jnp.where(mask, pos.astype(jnp.int32), -1), mask


def window_problem(
    kstore: st.KeyFrameStore, pstore: st.PointStore, lstore: st.LineStore,
    window: jax.Array, fixed: jax.Array,
    pt_cap: int | None = None, ln_cap: int | None = None,
):
    """Assemble a pose-major BAProblem over `window` (int32 [W] KF slots).

    With `pt_cap`/`ln_cap`, the landmark arrays are COMPACTED to the ids
    actually observed in the window (fixed-size unique + remap): the
    Schur elimination then runs over ~the window's landmarks instead of
    the full padded stores — a ~4x cut of the local BA's dominant cost
    at production capacities (16384-slot point store vs <=4096 observed).
    Returns (prob, ids_pt, ids_ln); ids are None without compaction,
    else the store row each compact row came from (sentinel = store
    capacity for padding), for scattering results back.
    """
    W = window.shape[0]
    S = kstore.obs_pt.shape[1]
    Sl = kstore.obs_ln.shape[1]
    win_valid = kstore.valid[window]

    # mask rows that duplicate an earlier window entry (window padding) —
    # their observations would otherwise be double-counted
    dup = jnp.any((window[:, None] == window[None, :]) & (jnp.arange(W)[None, :] < jnp.arange(W)[:, None]), axis=1)
    row_ok = win_valid & ~dup
    po_pose = jnp.repeat(jnp.arange(W, dtype=jnp.int32), S)
    po_pt = kstore.obs_pt[window].reshape(-1)
    po_mask = (po_pt >= 0) & jnp.repeat(row_ok, S)
    lo_ln = kstore.obs_ln[window].reshape(-1)
    lo_mask = (lo_ln >= 0) & jnp.repeat(row_ok, Sl)

    P = pstore.x.shape[0]
    L = lstore.seg.shape[0]
    ids_pt = ids_ln = None
    if pt_cap is not None and pt_cap < P:
        ids_pt, po_pt, po_mask = _compact_ids(po_pt, po_mask, P, pt_cap)
        safe = jnp.minimum(ids_pt, P - 1)
        pts = pstore.x[safe]
        pt_mask = (ids_pt < P) & pstore.valid[safe]
    else:
        pts, pt_mask = pstore.x, pstore.valid
    if ln_cap is not None and ln_cap < L:
        ids_ln, lo_ln, lo_mask = _compact_ids(lo_ln, lo_mask, L, ln_cap)
        safe_l = jnp.minimum(ids_ln, L - 1)
        lns = lstore.seg[safe_l]
        ln_mask = (ids_ln < L) & lstore.valid[safe_l]
    else:
        lns, ln_mask = lstore.seg, lstore.valid

    prob = ba_mod.BAProblem(
        R=kstore.R[window],
        t=kstore.t[window],
        pose_mask=win_valid,
        fixed_mask=fixed | ~win_valid,
        pts=pts,
        pt_mask=pt_mask,
        lns=lns,
        ln_mask=ln_mask,
        po_pose=po_pose,
        po_pt=po_pt,
        po_uvr=kstore.obs_uvr[window].reshape(-1, 3),
        po_stereo=kstore.obs_stereo[window].reshape(-1),
        po_sigma2=kstore.obs_sigma2[window].reshape(-1),
        po_mask=po_mask,
        lo_pose=jnp.repeat(jnp.arange(W, dtype=jnp.int32), Sl),
        lo_ln=lo_ln,
        lo_l=kstore.obs_l[window].reshape(-1, 3),
        lo_sigma2=kstore.obs_ln_sigma2[window].reshape(-1),
        lo_mask=lo_mask,
    )
    return prob, ids_pt, ids_ln


def _scatter_landmarks(pstore, lstore, ids_pt, ids_ln, pts_new, lns_new):
    """Write compacted-solve landmark results back into the stores."""
    P = pstore.x.shape[0]
    L = lstore.seg.shape[0]
    if ids_pt is None:
        pstore = dataclasses.replace(pstore, x=pts_new)
    else:
        safe = jnp.minimum(ids_pt, P - 1)
        okm = ids_pt < P
        pstore = dataclasses.replace(
            pstore,
            x=pstore.x.at[safe].set(jnp.where(okm[:, None], pts_new, pstore.x[safe])),
        )
    if ids_ln is None:
        lstore = dataclasses.replace(lstore, seg=lns_new)
    else:
        safe_l = jnp.minimum(ids_ln, L - 1)
        okl = ids_ln < L
        lstore = dataclasses.replace(
            lstore,
            seg=lstore.seg.at[safe_l].set(jnp.where(okl[:, None], lns_new, lstore.seg[safe_l])),
        )
    return pstore, lstore


def local_ba(cam, cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore, lstore: st.LineStore, window: jax.Array, fixed: jax.Array, iters: int | None = None):
    """Windowed BA over `window` (int32 [W] KF slots). Updates stores.

    (reference: LocalMapping -> Optimizer::LocalBundleAdjustment :1864;
    improved: line landmarks are optimized too)
    """
    W = window.shape[0]
    S = kstore.obs_pt.shape[1]
    Sl = kstore.obs_ln.shape[1]
    prob, ids_pt, ids_ln = window_problem(
        kstore, pstore, lstore, window, fixed,
        pt_cap=cfg.opt.ba_pt_cap, ln_cap=cfg.opt.ba_ln_cap,
    )
    result = ba_mod.solve_ba(cam, prob, cfg.opt, iters=cfg.opt.local_ba_iters if iters is None else iters)
    # erase outlier observations from the map (the reference deletes the
    # MapPoint<->KeyFrame observation after local BA, Optimizer.cc:2323;
    # without this, bad associations accumulate and bias every later BA).
    # Only observations that PARTICIPATED in the solve are judged —
    # compaction-dropped or padding rows keep their association.
    keep_pt = ((result.po_chi2 < cfg.opt.prune_chi2_pt) | ~prob.po_mask).reshape(W, S)
    keep_ln = ((result.lo_chi2 < cfg.opt.prune_chi2_ln) | ~prob.lo_mask).reshape(W, Sl)
    obs_pt_win = jnp.where(keep_pt, kstore.obs_pt[window], -1)
    obs_ln_win = jnp.where(keep_ln, kstore.obs_ln[window], -1)
    kstore = dataclasses.replace(
        kstore,
        R=kstore.R.at[window].set(result.R),
        t=kstore.t.at[window].set(result.t),
        obs_pt=kstore.obs_pt.at[window].set(obs_pt_win),
        obs_ln=kstore.obs_ln.at[window].set(obs_ln_win),
    )
    pstore, lstore = _scatter_landmarks(
        pstore, lstore, ids_pt, ids_ln, result.pts, result.lns
    )
    return kstore, pstore, lstore


def local_inertial_ba(
    cam, cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore,
    lstore: st.LineStore, window: jax.Array, fixed: jax.Array,
    preint_chain, imu_mask: jax.Array, gravity_w: jax.Array, ext=None,
):
    """Visual-inertial windowed BA over a temporal keyframe window.

    (reference: Optimizer::LocalInertialBA, src/Optimizer.cc:4547 —
    temporal window chained by mPrevKF EdgeInertial factors; here the
    chain factors are the composed per-keyframe preintegrations and the
    whole 15-dof-per-pose Schur solve is one device program.)
    """
    from pli_slam_tpu.solve import vi_ba as vib

    W = window.shape[0]
    win_valid = kstore.valid[window]
    dup = jnp.any(
        (window[:, None] == window[None, :])
        & (jnp.arange(W)[None, :] < jnp.arange(W)[:, None]),
        axis=1,
    )
    row_ok = win_valid & ~dup
    base, ids_pt, ids_ln = window_problem(
        kstore, pstore, lstore, window, fixed,
        pt_cap=cfg.opt.ba_pt_cap, ln_cap=cfg.opt.ba_ln_cap,
    )
    if ext is None:
        from pli_slam_tpu.solve import inertial as inr

        ext = inr.Extrinsics.identity()
    prob = vib.VIBAProblem(
        base=base,
        v=kstore.v_w[window],
        bg=kstore.bg[window],
        ba=kstore.ba[window],
        preint=preint_chain,
        imu_mask=imu_mask & row_ok[1:] & row_ok[:-1],
        gravity_w=gravity_w,
        R_cb=ext.R_cb,
        t_cb=ext.t_cb,
    )
    R, t, v, bg, ba_, pts, lns = vib.solve_vi_ba(cam, prob, cfg.opt, cfg.imu)
    kstore = dataclasses.replace(
        kstore,
        R=kstore.R.at[window].set(R),
        t=kstore.t.at[window].set(t),
        v_w=kstore.v_w.at[window].set(v),
        bg=kstore.bg.at[window].set(bg),
        ba=kstore.ba.at[window].set(ba_),
    )
    pstore, lstore = _scatter_landmarks(pstore, lstore, ids_pt, ids_ln, pts, lns)
    return kstore, pstore, lstore


def global_ba(cam, cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore, lstore: st.LineStore, iters: int | None = None):
    """Full-map bundle adjustment over every valid keyframe.

    (reference: Optimizer::GlobalBundleAdjustemnt -> BundleAdjustment,
    src/Optimizer.cc:56/:63, launched from
    LoopClosing::RunGlobalBundleAdjustment :2243 after a loop closure;
    budget 10 iterations :2250.)

    Small maps use the joint Schur solve; large maps switch to the
    memory-bounded alternating solver — the Schur path's Hpl blocks are
    O(P·K) and exhaust HBM past a few dozen keyframes.
    """
    K = kstore.R.shape[0]
    iters = cfg.opt.gba_iters if iters is None else iters
    window = jnp.arange(K, dtype=jnp.int32)
    fixed = jnp.zeros(K, bool).at[0].set(True)
    if K <= 4 * cfg.opt.local_ba_window:
        return local_ba(cam, cfg, kstore, pstore, lstore, window, fixed, iters=iters)
    prob, _, _ = window_problem(kstore, pstore, lstore, window, fixed)
    result = ba_mod.solve_ba_alternating(cam, prob, cfg.opt, iters=iters)
    S = kstore.obs_pt.shape[1]
    Sl = kstore.obs_ln.shape[1]
    keep_pt = (result.po_chi2 < cfg.opt.prune_chi2_pt).reshape(K, S)
    keep_ln = (result.lo_chi2 < cfg.opt.prune_chi2_ln).reshape(K, Sl)
    kstore = dataclasses.replace(
        kstore,
        R=result.R,
        t=result.t,
        obs_pt=jnp.where(keep_pt, kstore.obs_pt, -1),
        obs_ln=jnp.where(keep_ln, kstore.obs_ln, -1),
    )
    pstore = dataclasses.replace(pstore, x=result.pts)
    lstore = dataclasses.replace(lstore, seg=result.lns)
    return kstore, pstore, lstore


def track_step_inertial(
    cam, cfg: SlamConfig, frame: FrameData, preint, prev_state, init_state,
    gravity_w, ext, pstore: st.PointStore, lstore: st.LineStore, local_pt_ids=None,
    wide=False,
):
    """Inertial analog of track_step: the 15-dof state is solved with the
    preintegration factor in the loop (reference: TrackLocalMap's
    PoseInertialOptimizationLastFrame path, src/Tracking.cc:3308).
    `ext` is the body-camera Extrinsics (reference IMU::Calib Tbc)."""
    from pli_slam_tpu.solve import inertial as inr

    R0, t0 = inr.camera_pose(init_state, ext)
    # `wide` (traced): widen the first search round after map-changing
    # events (IMU init / FIBA / loop correction) — the refined map can
    # sit tens of px from the prediction for a few frames, and at
    # f=435 the nominal 15 px window is only ~2 deg
    r1 = jnp.where(wide, 3.0 * cfg.match.search_radius_px, cfg.match.search_radius_px)
    pt_idx, pt_ok, _ = _match_points_against_store(cam, cfg, frame, R0, t0, pstore, r1, local_pt_ids)
    ln_idx, ln_ok, _ = _match_lines_against_store(cam, cfg, frame, R0, t0, lstore, r1)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    st1, _, _, _ = inr.solve_pose_inertial(
        cam, ext, obs, preint, prev_state, init_state, cfg.opt, cfg.imu, gravity_w=gravity_w
    )

    R1, t1 = inr.camera_pose(st1, ext)
    r2 = max(cfg.match.search_radius_px * 0.4, 4.0)
    pt_idx, pt_ok, pt_frust = _match_points_against_store(cam, cfg, frame, R1, t1, pstore, r2, local_pt_ids)
    ln_idx, ln_ok, ln_frust = _match_lines_against_store(cam, cfg, frame, R1, t1, lstore, r2)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    st2, in_pt, in_ln, n_in = inr.solve_pose_inertial(
        cam, ext, obs, preint, prev_state, st1, cfg.opt, cfg.imu, gravity_w=gravity_w
    )
    pt_in = pt_ok & in_pt
    ln_in = ln_ok & in_ln
    frust_ids, frust_rows = pt_frust
    if frust_ids is None:
        visible = pstore.visible + frust_rows.astype(jnp.int32)
    else:
        visible = pstore.visible.at[jnp.maximum(frust_ids, 0)].add(
            (frust_rows & (frust_ids >= 0)).astype(jnp.int32)
        )
    pstore = dataclasses.replace(
        pstore,
        visible=visible,
        found=pstore.found.at[jnp.maximum(pt_idx, 0)].add(pt_in.astype(jnp.int32)),
    )
    lstore = dataclasses.replace(
        lstore,
        visible=lstore.visible + ln_frust.astype(jnp.int32),
        found=lstore.found.at[jnp.maximum(ln_idx, 0)].add(ln_in.astype(jnp.int32)),
    )
    R2, t2 = inr.camera_pose(st2, ext)
    n = jnp.sum(pt_in.astype(jnp.int32)) + jnp.sum(ln_in.astype(jnp.int32))
    return st2, R2, t2, pt_idx, pt_in, ln_idx, ln_in, n, pstore, lstore


def _mono_reconstruct(cam, cfg: SlamConfig, prev_frame: FrameData, frame: FrameData, key):
    """Two-view monocular initialization between the stored first frame
    and the current one (reference: MonocularInitialization,
    src/Tracking.cc:2144 -> Pinhole::ReconstructWithTwoViews ->
    TwoViewReconstruction::Reconstruct :39).

    Returns (success, R, t (T_c2c1, median-depth-normalized), depth1 [N]
    per-prev-feature triangulated depth in view 1, n_inliers).
    """
    from pli_slam_tpu.solve import twoview

    dist = matching.hamming_matrix(prev_frame.feats.desc, frame.feats.desc)
    idx, best, ok = matching.match_nn(
        dist, prev_frame.feats.valid, frame.feats.valid,
        max_dist=cfg.match.orb_th_low, ratio=0.9,
    )
    ok = matching.mutual_consistency(idx, ok, dist, prev_frame.feats.valid, frame.feats.valid)
    uv1 = prev_frame.feats.uv
    uv2 = frame.feats.uv[jnp.maximum(idx, 0)]
    rec = twoview.reconstruct_two_views(cam, uv1, uv2, ok, key)
    X = rec["points"]  # view-1 frame
    inl = rec["inliers"]
    # median-depth normalization (reference ReconstructF scales the map
    # so the median scene depth is 1)
    z = X[:, 2]
    z_valid = jnp.where(inl & (z > 0), z, jnp.nan)
    med = jnp.nanmedian(z_valid)
    med = jnp.where(jnp.isfinite(med) & (med > 1e-6), med, 1.0)
    scale = 1.0 / med
    depth1 = jnp.where(inl & (z > 0), z * scale, -1.0)
    return rec["success"], rec["R"], rec["t"] * scale, depth1, rec["n_inliers"]


def _mono_triangulated_depths(
    cam, cfg: SlamConfig, frame: FrameData, R, t,
    kf_uv, kf_desc, kf_valid, R_kf, t_kf,
):
    """Synthesize a depth channel for a mono frame by triangulating its
    unmatched features against the last keyframe's view (reference:
    LocalMapping::CreateNewMapPoints epipolar triangulation,
    src/LocalMapping.cc:343 — here one batched DLT + gate program).
    Returns an updated per-feature depth [N] (current-camera z), -1
    where triangulation failed.
    """
    from pli_slam_tpu.solve import triangulate as tri

    dist = matching.hamming_matrix(frame.feats.desc, kf_desc)
    idx, best, ok = matching.match_nn(
        dist, frame.feats.valid, kf_valid, max_dist=cfg.match.orb_th_low, ratio=0.8
    )
    ok = matching.mutual_consistency(idx, ok, dist, frame.feats.valid, kf_valid)
    uv1 = kf_uv[jnp.maximum(idx, 0)]
    ray1 = cam_ops.unproject(cam, uv1)
    ray2 = cam_ops.unproject(cam, frame.feats.uv)
    X = tri.triangulate_dlt(R_kf, t_kf, R, t, ray1, ray2)
    good = tri.triangulation_checks(
        cam, R_kf, t_kf, R, t, X, uv1, frame.feats.uv,
        frame.sigma2, frame.sigma2,
    )
    z = lie.se3_apply(R, t, X)[:, 2]
    depth = jnp.where(ok & good & (z > 0.05), z, frame.depth)
    return depth


# ---------------------------------------------------------------------------
# Fused per-frame step (single dispatch, device-side keyframe branch)
# ---------------------------------------------------------------------------
#
# Host<->device syncs and dispatches cost time on every frame whatever
# the compute, so the fused step runs build-frame -> predict -> 2-round
# track -> KF decision -> (insert + BA + cull + BoW index/query) as ONE
# program (a design choice not yet measured on the card); the host reads
# back a single small stats vector. The branchy rare paths
# (relocalization, new map, loop verification) stay on the host, exactly
# as planned in SURVEY.md §7.3 item 3 — but the 99% path never leaves
# the device.

# stats vector layout (f32[16])
ST_OK = 0  # tracking ok (inliers >= floor)
ST_NIN = 1  # inlier count
ST_NKF = 2  # keyframe count after this frame
ST_KF_CREATED = 3  # 1 if a KF was inserted this frame
ST_NNEW = 4  # new landmarks created
ST_NPTS = 5  # valid points in store
ST_NLNS = 6  # valid lines in store
ST_FSKF = 7  # frames since last KF (after this frame)
ST_LASTKFIN = 8  # reference inlier count of the last KF
ST_LOOP_SLOT = 9  # 3 best loop candidate KF slots (-1 none), 9..11
ST_LOOP_SCORE = 12  # their combined BoW scores, 12..14
ST_KF_SLOT = 15  # slot of the created KF (-1)
N_LOOP_CANDS = 3  # reference DetectNBestCandidates(3), LoopClosing.cc:395
N_STATS = 16


def _device_cull_keyframes(cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore, n_kf):
    """Invalidate redundant keyframes (reference KeyFrameCulling :895):
    >= kf_cull_redundancy of a KF's landmarks observed >= cull_min_obs+1
    times elsewhere. KF 0 and the active window are protected."""
    K = kstore.valid.shape[0]
    ids = jnp.arange(K)
    in_scope = (ids >= 1) & (ids < n_kf - cfg.opt.local_ba_window)
    has = kstore.obs_pt >= 0  # [K, S]
    n_obs = pstore.n_obs[jnp.maximum(kstore.obs_pt, 0)]
    red = jnp.sum(((n_obs >= cfg.map.cull_min_obs + 1) & has).astype(jnp.int32), axis=1)
    tot = jnp.maximum(jnp.sum(has.astype(jnp.int32), axis=1), 1)
    cull = in_scope & kstore.valid & (red >= cfg.map.kf_cull_redundancy * tot)
    return dataclasses.replace(kstore, valid=kstore.valid & ~cull)


def _window_and_fixed(cfg: SlamConfig, n_kf):
    """Temporal BA window over the last W keyframes (device ints).

    Used by the inertial path — the reference's LocalInertialBA windows
    temporally through the mPrevKF chain (src/Optimizer.cc:4552)."""
    W = cfg.opt.local_ba_window
    lo = jnp.maximum(n_kf - W, 0)
    window = jnp.clip(lo + jnp.arange(W, dtype=jnp.int32), 0, jnp.maximum(n_kf - 1, 0))
    n_fixed = jnp.maximum(cfg.opt.local_ba_fixed, W - (n_kf - lo))
    fixed = jnp.arange(W) < jnp.maximum(n_fixed, 1)
    dup = jnp.concatenate([jnp.zeros(1, bool), window[1:] <= window[:-1]])
    return window, fixed | dup


def _covis_window(cfg: SlamConfig, kstore: st.KeyFrameStore, kf_slot, n_kf):
    """Covisibility BA window: the new keyframe + its W-1 most covisible
    keyframes (reference LocalBundleAdjustment collects the covisible
    neighborhood, src/Optimizer.cc:1874-1928). The temporal predecessor
    is always included so the window never disconnects; the two OLDEST
    window members are held fixed (gauge, the stand-in for the
    reference's fixed out-of-window observers)."""
    W = cfg.opt.local_ba_window
    K = kstore.covis.shape[0]
    ids = jnp.arange(K, dtype=jnp.int32)
    row = kstore.covis[kf_slot]
    eligible = kstore.valid & (ids < n_kf) & (ids != kf_slot)
    score = jnp.where(eligible, row.astype(jnp.float32), -1.0)
    prev_slot = jnp.maximum(kf_slot - 1, 0)
    score = score.at[prev_slot].add(jnp.where(kf_slot > 0, 1e6, 0.0))
    top_s, top_i = jax.lax.top_k(score, W - 1)
    neighbors = jnp.where(top_s > 0, top_i.astype(jnp.int32), kf_slot)  # pad = dup of self
    window = jnp.concatenate([jnp.asarray([kf_slot], jnp.int32), neighbors])
    # fix the two oldest distinct members (self never fixed: it sorts last
    # because padding duplicates equal kf_slot, the newest slot)
    order = jnp.argsort(window)
    fixed = jnp.zeros(W, bool).at[order[0]].set(True)
    fixed = fixed.at[order[1]].set(window[order[1]] != kf_slot)
    return window, fixed


def make_step_visual(cam, cfg: SlamConfig, voc_pt, voc_ln, build):
    """Build the fused per-frame program for a non-inertial sensor.

    `build` maps the raw image args to a FrameData (stereo/rgbd/mono
    variants). Returns a jitted step:
      step(img_args, stamp, R, t, R_prev, t_prev, vel_xi, has_vel,
           n_kf, frames_since_kf, last_kf_inliers, allow_mapping,
           pstore, lstore, kstore, bow_db)
      -> (R, t, R_prev, t_prev, vel_xi, has_vel,
          pstore, lstore, kstore, bow_db, pt_idx, pt_in, ln_idx, ln_in, stats)
    """

    def kf_branch(args):
        (frame, stamp, R, t, pt_idx, pt_in, ln_idx, ln_in,
         n_kf, n_in, pstore, lstore, kstore, bow_db, kf_view, local_pt) = args
        # far-point creation channel: triangulate against the recent
        # keyframes' views (reference CreateNewMapPoints searches the
        # covisible neighborhood); views from before KF0 carry all-False
        # validity masks, so they contribute nothing
        tri_depth = jnp.where(
            n_kf > 0,
            far_point_depths(cam, cfg, frame, R, t, kf_view, kstore),
            jnp.full_like(frame.depth, -1.0),
        ) if float(cam.bf) > 0 else None
        pstore, lstore, kstore, n_new = insert_keyframe(
            cam, cfg, frame, R, t, stamp, pt_idx, pt_in, ln_idx, ln_in,
            n_kf, pstore, lstore, kstore, tri_depth,
        )
        n_kf2 = n_kf + 1

        def run_ba(ops):
            ks, ps, ls = ops
            window, fixed = _covis_window(cfg, ks, n_kf, n_kf2)
            return local_ba(cam, cfg, ks, ps, ls, window, fixed)

        kstore, pstore, lstore = jax.lax.cond(
            n_kf2 >= 3, run_ba, lambda ops: ops, (kstore, pstore, lstore)
        )
        kstore = _device_cull_keyframes(cfg, kstore, pstore, n_kf2)
        # continue tracking from the refined keyframe pose
        R2 = kstore.R[n_kf]
        t2 = kstore.t[n_kf]

        # BoW index + loop-candidate query (reference LoopClosing's
        # DetectNBestCandidates, folded into the KF branch so loop
        # detection costs no extra dispatch)
        bow_p = voc_pt.bow(frame.feats.desc, frame.feats.valid & (kstore.obs_pt[n_kf] >= 0))
        bow_l = voc_ln.bow(frame.lines.desc, frame.lines.valid)
        bow_db = bow_db.add(n_kf, bow_p, bow_l)
        K = bow_db.valid.shape[0]
        # exclude the covisible group (reference excludes connected KFs,
        # src/KeyFrameDatabase.cc:806) plus a temporal guard band
        excl = (jnp.arange(K) >= jnp.maximum(n_kf2 - cfg.loop.min_kf_gap, 0)) | (
            kstore.covis[n_kf] > 10
        )
        slots, scores = vocab_query(
            bow_db, bow_p, bow_l, excl, n_best=N_LOOP_CANDS, covis=kstore.covis
        )
        can_loop = n_kf >= cfg.loop.min_kf_gap
        loop_slots = jnp.where(can_loop, slots, -1)
        loop_scores = jnp.where(can_loop, scores, -1.0)
        # view ring shift: newest view enters slot 0, oldest falls off
        new_view = (frame.feats.uv, frame.feats.desc, frame.feats.valid,
                    jnp.asarray(n_kf, jnp.int32))
        kf_view2 = tuple(
            jnp.concatenate([nv[None], old[:-1]], axis=0)
            for nv, old in zip(new_view, kf_view)
        )
        # refresh the local tracking map from the new keyframe's
        # covisibility neighborhood (post-BA, post-cull store)
        local_pt2 = _local_map_ids(cfg, kstore, pstore, n_kf)
        return (R2, t2, pstore, lstore, kstore, bow_db,
                n_kf2, n_new, loop_slots, loop_scores, kf_view2, local_pt2)

    def no_kf_branch(args):
        (frame, stamp, R, t, pt_idx, pt_in, ln_idx, ln_in,
         n_kf, n_in, pstore, lstore, kstore, bow_db, kf_view, local_pt) = args
        return (R, t, pstore, lstore, kstore, bow_db,
                n_kf, jnp.int32(0),
                jnp.full(N_LOOP_CANDS, -1, jnp.int32),
                jnp.full(N_LOOP_CANDS, -1.0, jnp.float32), kf_view, local_pt)

    def step(img_args, stamp, R, t, R_prev, t_prev, vel_xi, has_vel,
             n_kf, frames_since_kf, last_kf_inliers, allow_mapping,
             pstore, lstore, kstore, bow_db, kf_view, local_pt):
        frame = build(*img_args)
        # motion-model pose prediction (reference mVelocity seeding)
        dR, dt = lie.se3_exp(vel_xi)
        use_mm = has_vel & bool(cfg.tracking.motion_model)
        R0 = jnp.where(use_mm, lie._mm(dR, R), R)
        t0 = jnp.where(use_mm, lie._einsum("ij,j->i", dR, t) + dt, t)
        (R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore) = track_step(
            cam, cfg, frame, R0, t0, pstore, lstore, wide=~use_mm,
            local_pt_ids=local_pt,
        )
        ok = n_in >= cfg.tracking.min_inliers_track
        R_new = jnp.where(ok, R1, R0)
        t_new = jnp.where(ok, t1, t0)
        # motion model update only on success (reference Tracking.cc:1794)
        # velocity twist: NEW pose composed with the inverse of the
        # PREVIOUS frame's pose (R, t) — the incoming (R_prev, t_prev) is
        # one frame older still
        R_rel = lie._mm(R_new, R.T)
        t_rel = t_new - lie._einsum("ij,j->i", R_rel, t)
        vel_new = lie.se3_log(R_rel, t_rel)
        vel_xi = jnp.where(ok, vel_new, vel_xi)
        has_vel = ok | has_vel

        fs = frames_since_kf + 1
        need_kf = (
            ok & allow_mapping
            & (n_in >= cfg.tracking.kf_min_inliers)
            & (fs > max(cfg.tracking.kf_min_interval, 1))
            & ((fs >= cfg.tracking.kf_max_interval)
               | (n_in < cfg.tracking.kf_ref_ratio * jnp.maximum(last_kf_inliers, 1)))
            & (n_kf < cfg.map.max_keyframes)
        )
        args = (frame, stamp, R_new, t_new, pt_idx, pt_in, ln_idx, ln_in,
                n_kf, n_in, pstore, lstore, kstore, bow_db, kf_view, local_pt)
        (R_new, t_new, pstore, lstore, kstore, bow_db,
         n_kf2, n_new, loop_slot, loop_score, kf_view, local_pt) = jax.lax.cond(
            need_kf, kf_branch, no_kf_branch, args
        )
        fs2 = jnp.where(need_kf, 0, fs)
        last_in2 = jnp.where(need_kf, n_in + n_new, last_kf_inliers)

        stats = jnp.zeros(N_STATS, jnp.float32)
        stats = stats.at[ST_OK].set(ok.astype(jnp.float32))
        stats = stats.at[ST_NIN].set(n_in.astype(jnp.float32))
        stats = stats.at[ST_NKF].set(n_kf2.astype(jnp.float32))
        stats = stats.at[ST_KF_CREATED].set(need_kf.astype(jnp.float32))
        stats = stats.at[ST_NNEW].set(n_new.astype(jnp.float32))
        stats = stats.at[ST_NPTS].set(jnp.sum(pstore.valid.astype(jnp.float32)))
        stats = stats.at[ST_NLNS].set(jnp.sum(lstore.valid.astype(jnp.float32)))
        stats = stats.at[ST_FSKF].set(fs2.astype(jnp.float32))
        stats = stats.at[ST_LASTKFIN].set(last_in2.astype(jnp.float32))
        stats = jax.lax.dynamic_update_slice(
            stats, loop_slot.astype(jnp.float32), (ST_LOOP_SLOT,)
        )
        stats = jax.lax.dynamic_update_slice(stats, loop_score, (ST_LOOP_SCORE,))
        stats = stats.at[ST_KF_SLOT].set(jnp.where(need_kf, n_kf2 - 1, -1).astype(jnp.float32))
        # counters are returned as device scalars so consecutive steps can
        # chain WITHOUT the host reading stats in between (lag-1 streaming)
        counters = (jnp.asarray(n_kf2, jnp.int32), jnp.asarray(fs2, jnp.int32),
                    jnp.asarray(last_in2, jnp.int32))
        # trajectory record: pose RELATIVE to the newest keyframe, computed
        # in-step (host-side recomputation would cost several tiny
        # dispatches per frame)
        ref = jnp.maximum(n_kf2 - 1, 0).astype(jnp.int32)
        R_ref = kstore.R[ref]
        t_ref = kstore.t[ref]
        R_cr = lie._mm(R_new, R_ref.T)
        t_cr = t_new - lie._einsum("ij,j->i", R_cr, t_ref)
        rel = (ref, R_cr, t_cr)
        return (R_new, t_new, R, t, vel_xi, has_vel,
                pstore, lstore, kstore, bow_db, kf_view, local_pt,
                pt_idx, pt_in, ln_idx, ln_in, counters, stats, rel)

    return jax.jit(step)


def make_step_vi(cam, cfg: SlamConfig, voc_pt, voc_ln, build):
    """Fused stereo-inertial per-frame program (post-IMU-init).

    The inertial analog of make_step_visual: ONE dispatch runs
    build -> preintegrate -> IMU predict -> inertial track -> (KF branch:
    insert + preint-chain write + temporal-window visual-inertial BA +
    BoW/loop query + view ring + local-map refresh). The reference
    spreads this across Tracking::PreintegrateIMU/PredictStateIMU
    (src/Tracking.cc:1085/:1197), PoseInertialOptimizationLastFrame
    (src/Optimizer.cc:7820) and LocalMapping's LocalInertialBA
    (src/Optimizer.cc:4547) on three threads.

    step(img_args, (g, a, dts, m), stamp, R, t, v_w, bg, ba, gravity_w,
         preint_acc, ext, n_kf, frames_since_kf, last_kf_inliers,
         allow_mapping, pstore, lstore, kstore, bow_db, kf_view,
         local_pt, pints)
    """
    from pli_slam_tpu.ops import imu as imu_ops
    from pli_slam_tpu.solve import inertial as inr

    def kf_branch(args):
        (frame, stamp, R, t, v_w, bg, ba, pt_idx, pt_in, ln_idx, ln_in,
         n_kf, n_in, pstore, lstore, kstore, bow_db, kf_view, local_pt,
         pints, preint_acc, gravity_w, ext) = args
        tri_depth = jnp.where(
            n_kf > 0,
            far_point_depths(cam, cfg, frame, R, t, kf_view, kstore),
            jnp.full_like(frame.depth, -1.0),
        ) if float(cam.bf) > 0 else None
        pstore, lstore, kstore, n_new = insert_keyframe(
            cam, cfg, frame, R, t, stamp, pt_idx, pt_in, ln_idx, ln_in,
            n_kf, pstore, lstore, kstore, tri_depth,
        )
        n_kf2 = n_kf + 1
        # inertial state on the new KF row + the chain factor KF(k-1)->k
        kstore = dataclasses.replace(
            kstore,
            v_w=kstore.v_w.at[n_kf].set(v_w),
            bg=kstore.bg.at[n_kf].set(bg),
            ba=kstore.ba.at[n_kf].set(ba),
        )
        pints = pints.set(
            n_kf, preint_acc, valid=(n_kf > 0) & (preint_acc.dt > 1e-6)
        )

        # temporal-window VI BA (reference LocalInertialBA's mPrevKF
        # chain window, src/Optimizer.cc:4552-4578)
        W = cfg.opt.local_ba_window
        lo = jnp.maximum(n_kf2 - W, 0)
        window = jnp.clip(lo + jnp.arange(W, dtype=jnp.int32), 0, jnp.maximum(n_kf2 - 1, 0))
        dup = jnp.concatenate([jnp.zeros(1, bool), window[1:] <= window[:-1]])
        # first local_ba_fixed poses pinned (host-path parity: a 1-pose
        # gauge lets the window's bias/velocity states wander)
        fixed = (jnp.arange(W) < max(cfg.opt.local_ba_fixed, 1)) | dup
        stacked = pints.gather(window[1:])
        imu_mask = pints.valid[window[1:]] & (window[1:] == window[:-1] + 1)

        def run_ba(ops):
            ks, ps, ls = ops
            return local_inertial_ba(
                cam, cfg, ks, ps, ls, window, fixed, stacked, imu_mask,
                gravity_w, ext,
            )

        kstore, pstore, lstore = jax.lax.cond(
            n_kf2 >= 3, run_ba, lambda ops: ops, (kstore, pstore, lstore)
        )
        # continue from the refined keyframe state (NO keyframe culling
        # here: culling would break the preintegration chain adjacency —
        # the reference's inertial KeyFrameCulling rewires mPrevKF and
        # merges preintegrations, src/LocalMapping.cc:895)
        R2 = kstore.R[n_kf]
        t2 = kstore.t[n_kf]
        v2 = kstore.v_w[n_kf]
        bg2 = kstore.bg[n_kf]
        ba2 = kstore.ba[n_kf]

        bow_p = voc_pt.bow(frame.feats.desc, frame.feats.valid & (kstore.obs_pt[n_kf] >= 0))
        bow_l = voc_ln.bow(frame.lines.desc, frame.lines.valid)
        bow_db = bow_db.add(n_kf, bow_p, bow_l)
        K = bow_db.valid.shape[0]
        excl = (jnp.arange(K) >= jnp.maximum(n_kf2 - cfg.loop.min_kf_gap, 0)) | (
            kstore.covis[n_kf] > 10
        )
        slots, scores = vocab_query(
            bow_db, bow_p, bow_l, excl, n_best=N_LOOP_CANDS, covis=kstore.covis
        )
        can_loop = n_kf >= cfg.loop.min_kf_gap
        loop_slots = jnp.where(can_loop, slots, -1)
        loop_scores = jnp.where(can_loop, scores, -1.0)
        new_view = (frame.feats.uv, frame.feats.desc, frame.feats.valid,
                    jnp.asarray(n_kf, jnp.int32))
        kf_view2 = tuple(
            jnp.concatenate([nv[None], old[:-1]], axis=0)
            for nv, old in zip(new_view, kf_view)
        )
        local_pt2 = _local_map_ids(cfg, kstore, pstore, n_kf)
        # reset the accumulator, linearized at the refined biases
        acc2 = imu_ops.identity_with_bias(bg2, ba2)
        return (R2, t2, v2, bg2, ba2, pstore, lstore, kstore, bow_db,
                n_kf2, n_new, loop_slots, loop_scores, kf_view2, local_pt2,
                pints, acc2)

    def no_kf_branch(args):
        (frame, stamp, R, t, v_w, bg, ba, pt_idx, pt_in, ln_idx, ln_in,
         n_kf, n_in, pstore, lstore, kstore, bow_db, kf_view, local_pt,
         pints, preint_acc, gravity_w, ext) = args
        return (R, t, v_w, bg, ba, pstore, lstore, kstore, bow_db,
                n_kf, jnp.int32(0),
                jnp.full(N_LOOP_CANDS, -1, jnp.int32),
                jnp.full(N_LOOP_CANDS, -1.0, jnp.float32), kf_view, local_pt,
                pints, preint_acc)

    def step(img_args, imu_args, stamp, R, t, v_w, bg, ba, gravity_w,
             preint_acc, ext, n_kf, frames_since_kf, last_kf_inliers,
             allow_mapping, wide, pstore, lstore, kstore, bow_db, kf_view,
             local_pt, pints):
        frame = build(*img_args)
        # imu_args: packed [T, 8] = g | a | dt | mask (one host upload)
        g_b = imu_args[:, 0:3]
        a_b = imu_args[:, 3:6]
        dt_b = imu_args[:, 6]
        m_b = imu_args[:, 7] > 0.5
        # this frame's preintegration (reference PreintegrateIMU) + the
        # per-KF accumulator (mpImuPreintegratedFromLastKF)
        p = imu_ops.preintegrate(g_b, a_b, dt_b, m_b, bg, ba, cfg.imu)
        acc = imu_ops.compose(preint_acc, p)
        prev_state = inr.body_state_from_camera(R, t, v_w, bg, ba, ext)
        Rp, vp, pp = imu_ops.predict_state(
            prev_state.R_wb, prev_state.v_w, prev_state.p_w, p, bg, ba, gravity_w
        )
        init_state = inr.BodyState(R_wb=Rp, p_w=pp, v_w=vp, bg=bg, ba=ba)
        (st2, R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in,
         pstore, lstore) = track_step_inertial(
            cam, cfg, frame, p, prev_state, init_state, gravity_w, ext,
            pstore, lstore, local_pt, wide=wide,
        )
        ok = n_in >= cfg.tracking.min_inliers_track
        # on failure hold the IMU dead-reckoned state (reference
        # PredictStateIMU during RECENTLY_LOST, src/Tracking.cc:1567)
        R_pred, t_pred = inr.camera_pose(init_state, ext)
        R_new = jnp.where(ok, R1, R_pred)
        t_new = jnp.where(ok, t1, t_pred)
        # velocity sanity clamp on the dead-reckoned fallback (bias +
        # gravity error integrates without bound during loss)
        vp_n = jnp.linalg.norm(vp)
        vp_safe = vp * jnp.minimum(1.0, 5.0 / jnp.maximum(vp_n, 1e-9))
        v_new = jnp.where(ok, st2.v_w, vp_safe)
        bg_new = jnp.where(ok, st2.bg, bg)
        ba_new = jnp.where(ok, st2.ba, ba)

        fs = frames_since_kf + 1
        need_kf = (
            ok & allow_mapping
            & (n_in >= cfg.tracking.kf_min_inliers)
            & (fs > max(cfg.tracking.kf_min_interval, 1))
            & ((fs >= cfg.tracking.kf_max_interval)
               | (n_in < cfg.tracking.kf_ref_ratio * jnp.maximum(last_kf_inliers, 1)))
            & (n_kf < cfg.map.max_keyframes)
        )
        args = (frame, stamp, R_new, t_new, v_new, bg_new, ba_new,
                pt_idx, pt_in, ln_idx, ln_in, n_kf, n_in,
                pstore, lstore, kstore, bow_db, kf_view, local_pt,
                pints, acc, gravity_w, ext)
        (R_new, t_new, v_new, bg_new, ba_new, pstore, lstore, kstore,
         bow_db, n_kf2, n_new, loop_slot, loop_score, kf_view, local_pt,
         pints, acc) = jax.lax.cond(need_kf, kf_branch, no_kf_branch, args)
        fs2 = jnp.where(need_kf, 0, fs)
        last_in2 = jnp.where(need_kf, n_in + n_new, last_kf_inliers)

        stats = jnp.zeros(N_STATS, jnp.float32)
        stats = stats.at[ST_OK].set(ok.astype(jnp.float32))
        stats = stats.at[ST_NIN].set(n_in.astype(jnp.float32))
        stats = stats.at[ST_NKF].set(n_kf2.astype(jnp.float32))
        stats = stats.at[ST_KF_CREATED].set(need_kf.astype(jnp.float32))
        stats = stats.at[ST_NNEW].set(n_new.astype(jnp.float32))
        stats = stats.at[ST_NPTS].set(jnp.sum(pstore.valid.astype(jnp.float32)))
        stats = stats.at[ST_NLNS].set(jnp.sum(lstore.valid.astype(jnp.float32)))
        stats = stats.at[ST_FSKF].set(fs2.astype(jnp.float32))
        stats = stats.at[ST_LASTKFIN].set(last_in2.astype(jnp.float32))
        stats = jax.lax.dynamic_update_slice(
            stats, loop_slot.astype(jnp.float32), (ST_LOOP_SLOT,)
        )
        stats = jax.lax.dynamic_update_slice(stats, loop_score, (ST_LOOP_SCORE,))
        stats = stats.at[ST_KF_SLOT].set(jnp.where(need_kf, n_kf2 - 1, -1).astype(jnp.float32))
        counters = (jnp.asarray(n_kf2, jnp.int32), jnp.asarray(fs2, jnp.int32),
                    jnp.asarray(last_in2, jnp.int32))
        ref = jnp.maximum(n_kf2 - 1, 0).astype(jnp.int32)
        R_ref = kstore.R[ref]
        t_ref = kstore.t[ref]
        R_cr = lie._mm(R_new, R_ref.T)
        t_cr = t_new - lie._einsum("ij,j->i", R_cr, t_ref)
        rel = (ref, R_cr, t_cr)
        return (R_new, t_new, R, t, v_new, bg_new, ba_new, acc,
                pstore, lstore, kstore, bow_db, kf_view, local_pt, pints,
                pt_idx, pt_in, ln_idx, ln_in, counters, stats, rel)

    return jax.jit(step)


@jax.jit
def _compose_trajectory(refs, R_cr, t_cr, R_abs, t_abs, kR, kt, kvalid):
    """Compose relative per-frame poses with the CURRENT keyframe poses
    (one program: BA/loop refinements reach every recorded frame)."""
    R_r = kR[refs]
    t_r = kt[refs]
    ok = kvalid[refs]
    R_cw = jnp.einsum("nij,njk->nik", R_cr, R_r, precision=_HI)
    t_cw = jnp.einsum("nij,nj->ni", R_cr, t_r, precision=_HI) + t_cr
    R_cw = jnp.where(ok[:, None, None], R_cw, R_abs)
    t_cw = jnp.where(ok[:, None], t_cw, t_abs)
    return R_cw, t_cw


def vocab_query(db, bow_pt, bow_ln, exclude_mask, n_best=3, covis=None):
    from pli_slam_tpu.worldmap import vocab as vocab_mod

    return vocab_mod.query(db, bow_pt, bow_ln, exclude_mask, n_best=n_best, covis=covis)


# ---------------------------------------------------------------------------
# Host-side tracker
# ---------------------------------------------------------------------------


class TrackingState:
    NOT_INITIALIZED = "NOT_INITIALIZED"
    OK = "OK"
    RECENTLY_LOST = "RECENTLY_LOST"
    LOST = "LOST"


class Tracker:
    """Host orchestration of the jitted device programs.

    The reference runs Tracking/LocalMapping as separate threads over
    shared memory; here each frame runs: build -> track (device), and on
    keyframe insertion: insert + windowed BA (device), sequentially and
    deterministically.
    """

    def __init__(self, cam: Camera, cfg: SlamConfig, rectifier=None,
                 cam_right: Camera | None = None, T_rl=None,
                 vocab_pt=None, vocab_ln=None):
        """`rectifier`: optional ops.rectify.StereoRectifier applied to raw
        stereo pairs inside the frame program (the reference's
        cv::initUndistortRectifyMap + remap ingest, src/Tracking.cc:144).

        KB8 fisheye stereo needs the rig extrinsics `T_rl` (4x4,
        left-camera -> right-camera) and optionally `cam_right` (defaults
        to the left intrinsics): fisheye pairs cannot be rectified to
        scanlines, so L/R association runs as epipolar-gated two-view
        matching + triangulation (frame.build_frame_fisheye_stereo,
        reference KannalaBrandt8::matchAndtriangulate,
        src/CameraModels/KannalaBrandt8.cpp:240)."""
        from pli_slam_tpu.frontend.frame import build_frame as _bf
        from pli_slam_tpu.frontend.frame import build_frame_fisheye_stereo as _bff
        from pli_slam_tpu.frontend.frame import build_frame_rgbd as _bfr
        from pli_slam_tpu.worldmap import vocab as vocab_mod

        # KB8 fisheye: features are undistorted to the ideal pinhole frame
        # (reference UndistortKeyPoints, src/Frame.cc:872); everything
        # downstream — matching, GN solve, BA, triangulation — runs on
        # the pinhole model with the same fx/fy/cx/cy.
        cam_raw = cam
        fisheye_stereo = None
        if cam.model == cam_ops.KANNALA_BRANDT8:
            if cfg.sensor.startswith("stereo"):
                if T_rl is None:
                    raise ValueError(
                        "KB8 fisheye stereo needs the rig extrinsics T_rl "
                        "(4x4 left->right camera transform)"
                    )
                T_rl = np.asarray(T_rl, np.float32)
                fisheye_stereo = (
                    cam_right if cam_right is not None else cam_raw,
                    jnp.asarray(T_rl[:3, :3]), jnp.asarray(T_rl[:3, 3]),
                )
            elif not cfg.sensor.startswith("mono"):
                raise ValueError("KB8 fisheye supports mono/mono_imu/stereo/stereo_imu")
            cam = dataclasses.replace(cam, model=cam_ops.PINHOLE)
        self.cam_raw = cam_raw
        self.cam = cam
        self.cfg = cfg
        self.rectifier = rectifier
        if fisheye_stereo is not None:
            cam_r_raw, R_rl, t_rl = fisheye_stereo
            _bf = lambda cam_, cfg_, img_l, img_r: _bff(  # noqa: E731
                cam_raw, cam_r_raw, cfg_, R_rl, t_rl, img_l, img_r
            )
            self.build_frame = jax.jit(partial(_bf, cam, cfg))
        elif rectifier is not None:
            _bf_raw = _bf

            def _bf(cam_, cfg_, img_l, img_r):
                l, r = rectifier(img_l, img_r)
                return _bf_raw(cam_, cfg_, l, r)

            self.build_frame = jax.jit(partial(_bf, cam, cfg))
        else:
            self.build_frame = make_build_frame(cam, cfg)
        self.is_mono = cfg.sensor.startswith("mono")
        self.is_rgbd = cfg.sensor.startswith("rgbd")
        if self.is_rgbd:
            from pli_slam_tpu.frontend.frame import make_build_frame_rgbd

            self.build_frame_rgbd = make_build_frame_rgbd(cam, cfg)
        if self.is_mono:
            from pli_slam_tpu.frontend.frame import make_build_frame_mono

            self.build_frame_mono = make_build_frame_mono(cam_raw, cfg)
            self._mono_init_frame = None  # (FrameData, stamp) awaiting 2nd view
            self._mono_reconstruct = jax.jit(
                partial(_mono_reconstruct, cam, cfg), static_argnames=()
            )
            self._mono_depths = jax.jit(partial(_mono_triangulated_depths, cam, cfg))
        self._kf_views = []  # (uv, desc, valid, kf_slot) of recent KFs (mono triangulation anchors)
        self._track = jax.jit(partial(track_step, cam, cfg))
        self._insert = jax.jit(partial(insert_keyframe, cam, cfg))
        self._ba = jax.jit(partial(local_ba, cam, cfg))
        self._gba_j = jax.jit(partial(global_ba, cam, cfg), static_argnames=("iters",))
        # amortized post-loop global BA: queued refinement chunks, one
        # executed per subsequent frame (reference: the transient GBA
        # thread racing LocalMapping, src/LoopClosing.cc:1087)
        self._deferred_ba: list[tuple] = []

        # vocabularies + BoW database (device state; reference's dual
        # ORBvoc/LSDvoc + KeyFrameDatabase). A TrainedVocabulary (learned
        # k-majority centroids + IDF, worldmap/vocab.py) can be injected
        # by assigning tracker.voc_pt/voc_ln BEFORE the first frame —
        # scripts/train_vocab.py produces one; the LSH default needs no
        # training data.
        self.voc_pt = vocab_pt if vocab_pt is not None else vocab_mod.Vocabulary(seed=17)
        self.voc_ln = vocab_ln if vocab_ln is not None else vocab_mod.Vocabulary(seed=23)
        self.bow_db = vocab_mod.BowDatabase.empty(cfg.map.max_keyframes, self.voc_pt.n_words)
        # fused one-dispatch step program (stereo / rgbd visual path)
        build_raw = partial(_bfr, cam, cfg) if self.is_rgbd else partial(_bf, cam, cfg)
        self._step = make_step_visual(cam, cfg, self.voc_pt, self.voc_ln, build_raw)
        # BoW index+query for the host-orchestrated paths (mono/inertial)
        def _bow_kf(bow_db, kstore, desc, fvalid, ldesc, lvalid, kf_slot, n_kf):
            bow_p = self.voc_pt.bow(desc, fvalid & (kstore.obs_pt[kf_slot] >= 0))
            bow_l = self.voc_ln.bow(ldesc, lvalid)
            bow_db = bow_db.add(kf_slot, bow_p, bow_l)
            K = bow_db.valid.shape[0]
            excl = jnp.arange(K) >= jnp.maximum(n_kf - cfg.loop.min_kf_gap, 0)
            slots, scores = vocab_query(
                bow_db, bow_p, bow_l, excl, n_best=N_LOOP_CANDS, covis=kstore.covis
            )
            can = kf_slot >= cfg.loop.min_kf_gap
            return bow_db, jnp.where(can, slots, -1), jnp.where(can, scores, -1.0)

        self._bow_kf = jax.jit(_bow_kf)

        def _bow_query_frame(bow_db, desc, fvalid, ldesc, lvalid, n_best):
            bow_p = self.voc_pt.bow(desc, fvalid)
            bow_l = self.voc_ln.bow(ldesc, lvalid)
            K = bow_db.valid.shape[0]
            return vocab_query(bow_db, bow_p, bow_l, jnp.zeros(K, bool), n_best=n_best)

        self._bow_query_frame = jax.jit(_bow_query_frame, static_argnames=("n_best",))

        m = cfg.map
        self.pstore = st.PointStore.empty(m.max_points)
        self.lstore = st.LineStore.empty(m.max_lines)
        self.kstore = st.KeyFrameStore.empty(
            m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines
        )
        self.state = TrackingState.NOT_INITIALIZED
        from pli_slam_tpu.worldmap.atlas import Atlas

        self.atlas = Atlas(cfg)
        self.loop_closer = None
        if cfg.loop.enabled:
            from pli_slam_tpu.frontend.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(cfg)
        self.n_kf = 0
        # ring of recent-KF views carried on device for the fused step's
        # far-point triangulation channel (uv, desc, valid, R, t — each
        # with a leading [N_TRI_VIEWS] axis; newest first)
        self._kf_view_dev = _empty_kf_views(cfg)
        # local tracking map (point ids; -1 = empty slot), refreshed at
        # every keyframe from the covisibility neighborhood
        self._local_pt = _empty_local_map(cfg)
        self._local_ids_j = jax.jit(partial(_local_map_ids, cfg))
        self._merge_streak = 0
        self._merge_map_idx = -1
        self._merge_kf = -1
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.R_prev = jnp.eye(3)
        self.t_prev = jnp.zeros(3)
        self.vel_xi = jnp.zeros(6)  # motion model twist (T_cw_k ∘ T_wc_{k-1})
        self.has_vel = False
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self._lost_frames = 0
        # timestamp-jump guard state (reference Tracking.cc:1382-1418)
        self._prev_stamp: float | None = None
        # streaming mode: read stats with one frame of lag so the sync
        # latency overlaps device compute (set by real-time drivers)
        self.streaming = False
        self._pending_stats = None
        # trajectory entries are (stamp, R_cw_dev, t_cw_dev) until
        # materialized — appending costs no host<->device sync
        self._traj_pending: list[tuple[float, jax.Array, jax.Array]] = []
        self._traj_done: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.stats: list[dict] = []

        # -- inertial state (sensor *_imu) --------------------------------
        self.use_imu = cfg.sensor.endswith("_imu")
        from pli_slam_tpu.solve import inertial as _inr

        # body-camera extrinsics T_cb from the configured Tbc (reference
        # IMU::Calib, src/Tracking.cc:761); identity when unset
        self.ext = _inr.Extrinsics.from_Tbc(cfg.imu.Tbc)
        self.imu_ready = False
        self.gravity_w = None  # world gravity vector after init
        self.v_w = jnp.zeros(3)
        self.bg = jnp.zeros(3)
        self.ba = jnp.zeros(3)
        self.last_preint = None
        self._first_imu_stamp = None
        self._last_imu_raw = None  # boundary sample carried between frame batches
        self._viba_stage: int | None = None  # 0 after init, 1 after VIBA1, 2 done
        self._imu_init_stamp = 0.0
        # structured per-attempt IMU-init debug records (reference
        # System::SaveDebugData, src/System.cc:708-761): scale, gravity
        # angle from vertical, biases, wall time, accept/reject reason
        self.imu_init_log: list[dict] = []
        # per-keyframe preintegration chain lives in self._pints (slot k spans KF k-1 -> k)
        # (reference mpImuPreintegratedFromLastKF, src/Tracking.cc:3599)
        self._preint_since_kf = None
        from pli_slam_tpu.ops import imu as _imu_ops

        # device-resident per-KF preintegration chain (slot k spans
        # KF k-1 -> KF k); replaces the round-4 host-side dict so the
        # fused stereo-inertial step can write factors and gather VI-BA
        # windows without host syncs
        self._pints = _imu_ops.PreintStore.empty(m.max_keyframes)
        if self.use_imu:
            from pli_slam_tpu.ops import imu as imu_ops

            Timu = cfg.imu.max_samples_per_frame

            def _preint(gyro, acc, dts, mask, bg, ba):
                return imu_ops.preintegrate(gyro, acc, dts, mask, bg, ba, cfg.imu)

            self._preintegrate = jax.jit(_preint)
            self._compose_preint = jax.jit(imu_ops.compose)
            self._track_inertial = jax.jit(partial(track_step_inertial, cam, cfg))
            self._vi_ba = jax.jit(partial(local_inertial_ba, cam, cfg))
            self._imu_pad = Timu
            # fused one-dispatch stereo-inertial step (post-IMU-init);
            # the pre-init phase and rare paths stay host-orchestrated
            self._vi_fused_active = False
            self._preint_acc = None
            # frames of widened matching after a map-changing event
            # (IMU init / FIBA / loop correction / deferred chunk)
            self._map_event_cooldown = 0
            if not self.is_mono:
                self._step_vi = make_step_vi(
                    cam, cfg, self.voc_pt, self.voc_ln, build_raw
                )

    # -- pose helpers ------------------------------------------------------
    def _predict_pose(self):
        if not self.has_vel or not self.cfg.tracking.motion_model:
            return self.R, self.t
        dR, dt = lie.se3_exp(self.vel_xi)
        R0 = lie._mm(dR, self.R)
        t0 = lie._einsum("ij,j->i", dR, self.t) + dt
        return R0, t0

    def _update_motion_model(self):
        # velocity twist: current T_cw composed with previous T_wc
        R_rel = lie._mm(self.R, self.R_prev.T)
        t_rel = self.t - lie._einsum("ij,j->i", R_rel, self.t_prev)
        self.vel_xi = lie.se3_log(R_rel, t_rel)
        self.has_vel = True

    def _reset_motion(self):
        self.has_vel = False

    # -- trajectory (device-lazy: no sync on append) -----------------------
    #
    # Frame poses are recorded RELATIVE to the latest keyframe (T_cr with
    # r = newest KF slot at record time) and composed with the keyframe's
    # CURRENT pose at readout — so windowed BA, loop corrections, global
    # BA, and IMU-init rescaling all retroactively refine the saved
    # trajectory, exactly like the reference's save path (it stores Tcr
    # per frame, src/Tracking.cc:1904-1924, and composes with optimized
    # KF poses in System::SaveTrajectoryEuRoC, src/System.cc:502).
    def finalize(self):
        """End-of-run: drain any amortized post-loop GBA chunks so saved
        poses reflect the fully refined map (the reference joins its GBA
        thread on Shutdown, src/System.cc:379)."""
        if self._deferred_ba:
            self.run_deferred_ba(max_chunks=len(self._deferred_ba))

    @property
    def trajectory(self) -> list[tuple[float, np.ndarray, np.ndarray]]:
        if self._traj_pending:
            pend, self._traj_pending = self._traj_pending, []
            # fixed-size chunks => ONE compiled composition variant for
            # any trajectory length (an eager composition pays per-op
            # first-call compiles inside the bench's timed region;
            # varying batch shapes would recompile mid-run the same way)
            CH = 32
            for i0 in range(0, len(pend), CH):
                sub = pend[i0:i0 + CH]
                pad = CH - len(sub)
                refs = jnp.stack([e[1] for e in sub] + [jnp.asarray(0)] * pad)
                R_cr = jnp.stack([e[2] for e in sub] + [jnp.eye(3)] * pad)
                t_cr = jnp.stack([e[3] for e in sub] + [jnp.zeros(3)] * pad)
                R_abs = jnp.stack([e[4] for e in sub] + [jnp.eye(3)] * pad)
                t_abs = jnp.stack([e[5] for e in sub] + [jnp.zeros(3)] * pad)
                R_cw, t_cw = _compose_trajectory(
                    refs, R_cr, t_cr, R_abs, t_abs,
                    self.kstore.R, self.kstore.t, self.kstore.valid,
                )
                Rs = np.asarray(R_cw)[: len(sub)]
                ts = np.asarray(t_cw)[: len(sub)]
                for (stamp, *_), R_, t_ in zip(sub, Rs, ts):
                    self._traj_done.append((stamp, R_.T, -R_.T @ t_))
        return self._traj_done

    def _flush_trajectory(self):
        """Materialize pending relative poses against the CURRENT keyframe
        store — must run before any operation that invalidates KF slot
        identity (map reset / new-map switch / Atlas merge remap)."""
        _ = self.trajectory

    # -- IMU plumbing ------------------------------------------------------
    def _ingest_imu(self, imu: dict, stamp: float):
        """Preintegrate this frame's IMU batch with the current biases."""
        g, a, dts, mask = self._imu_batch_arrays(imu)
        self.last_preint = self._preintegrate(g, a, dts, mask, self.bg, self.ba)
        # accumulate the per-keyframe chain factor (reference keeps a second
        # accumulator mpImuPreintegratedFromLastKF, src/Tracking.cc:1142)
        if self._preint_since_kf is None:
            self._preint_since_kf = self.last_preint
        else:
            self._preint_since_kf = self._compose_preint(
                self._preint_since_kf, self.last_preint
            )

    def _kf_chain(self, window: np.ndarray):
        """Stacked preintegration chain + mask for consecutive window slots
        (factor i spans window[i] -> window[i+1]; only adjacent-slot pairs
        with a recorded accumulator are valid). Gathers from the
        device-resident PreintStore."""
        window = np.asarray(window)
        nxt = window[1:]
        stacked = self._pints.gather(jnp.asarray(nxt, jnp.int32))
        adjacent = nxt == window[:-1] + 1
        imu_mask = np.asarray(self._pints.valid)[nxt] & adjacent
        return stacked, imu_mask

    # padded FIBA window capacities (bounds jit recompiles to 3 variants)
    _FIBA_CAPS = (8, 16, 32)

    def _full_inertial_ba(self):
        """Whole-map visual-inertial BA (reference Optimizer::FullInertialBA,
        src/Optimizer.cc:369, dispatched from InitializeIMU
        LocalMapping.cc:1291 and RunGlobalBundleAdjustment
        LoopClosing.cc:2250).

        Maps up to the largest padded capacity solve in ONE VI window;
        larger maps run a chunked alternating sweep: overlapping windows
        of the max capacity march oldest -> newest (each chunk's first
        keyframe fixed = the previous chunk's refined anchor), twice, so
        EVERY keyframe's pose/velocity/bias is refined — including the
        far side of a loop (round-3 verdict Weak #5: the capped version
        silently turned "full" into "local")."""
        # keep the CURRENT frame pose continuous across the solve: record
        # it relative to the newest keyframe and recompose against that
        # keyframe's refined pose afterwards. Teleporting self.R/t to the
        # keyframe pose (the round-4 behavior) rewinds the tracker 2-3
        # frames — at ~1.5 m/s that is tens of pixels of prediction error
        # and the next frame's matching collapses (the flagship-bench
        # tracking loss at IMU init). The reference keeps the frame pose
        # and only updates its reference-KF transform (UpdateFrameIMU,
        # src/Tracking.cc:4550).
        k = self.n_kf - 1
        R_ref0 = self.kstore.R[k]
        t_ref0 = self.kstore.t[k]
        R_cr = lie._mm(self.R, R_ref0.T)
        t_cr = self.t - lie._einsum("ij,j->i", R_cr, t_ref0)
        for window, fixed in self._fiba_schedule():
            self._run_fiba_window(window, fixed)
        self.v_w = self.kstore.v_w[k]
        self.bg = self.kstore.bg[k]
        self.ba = self.kstore.ba[k]
        self.R = lie._mm(R_cr, self.kstore.R[k])
        self.t = lie._einsum("ij,j->i", R_cr, self.kstore.t[k]) + t_cr
        self._map_event_cooldown = 5

    def _fiba_schedule(self):
        """The FIBA window sweep as an explicit list of (window, fixed)
        chunks, so it can run synchronously (_full_inertial_ba) or be
        amortized one chunk per frame after a loop closure (_queue_gba)."""
        n = self.n_kf
        if n < 3 or self.gravity_w is None:
            return []
        W = next((c for c in self._FIBA_CAPS if c >= n), self._FIBA_CAPS[-1])
        if n <= W:
            starts = [max(n - W, 0)]
            passes = 1
        else:
            step = W - 1  # one-KF overlap carries the anchor forward
            starts = list(range(0, n - W, step)) + [n - W]
            passes = 2
        out = []
        for _ in range(passes):
            for lo in starts:
                window = np.clip(np.arange(lo, lo + W), 0, n - 1)
                fixed = np.zeros(W, bool)
                fixed[0] = True
                for i in range(1, W):
                    if window[i] <= window[i - 1]:
                        fixed[i] = True
                out.append((window, fixed))
        return out

    def _run_fiba_window(self, window, fixed):
        # keyframes culled since the schedule was drawn stay pinned
        fixed = fixed | ~np.asarray(self.kstore.valid)[window]
        stacked, imu_mask = self._kf_chain(window)
        self.kstore, self.pstore, self.lstore = self._vi_ba(
            self.kstore, self.pstore, self.lstore,
            jnp.asarray(window, jnp.int32), jnp.asarray(fixed),
            stacked, jnp.asarray(imu_mask), self.gravity_w, self.ext,
        )

    def _queue_gba(self, inertial: bool):
        """Schedule the post-loop global BA as per-frame chunks instead
        of blocking the loop-closure frame (the reference
        runs GBA in a transient thread, src/LoopClosing.cc:1087; here the
        PGO-corrected map is live immediately and refinement chunks run
        one per subsequent frame on the same device queue — each chunk
        operates on the CURRENT map, so no spanning-tree reconciliation
        pass is needed afterwards)."""
        self._deferred_ba = []  # a new loop supersedes any pending schedule
        if inertial:
            for window, fixed in self._fiba_schedule():
                self._deferred_ba.append(("fiba", (window, fixed)))
        else:
            chunk = max(self.cfg.opt.gba_chunk_iters, 1)
            total = self.cfg.opt.gba_iters
            for _ in range(-(-total // chunk)):
                self._deferred_ba.append(("gba", chunk))

    def run_deferred_ba(self, max_chunks: int = 1):
        """Execute up to `max_chunks` queued global-BA chunks.

        The CURRENT frame pose rides along: it is recorded relative to
        the newest keyframe before each chunk and recomposed against
        that keyframe's refined pose after — a chunk that moves the
        recent keyframes without carrying the live pose strands the
        tracker off its own map (the VIBA-gate tracking collapse)."""
        n_run = 0
        while self._deferred_ba and n_run < max_chunks:
            kind, arg = self._deferred_ba.pop(0)
            k = self.n_kf - 1
            R_ref0 = self.kstore.R[k]
            t_ref0 = self.kstore.t[k]
            R_cr = lie._mm(self.R, R_ref0.T)
            t_cr = self.t - lie._einsum("ij,j->i", R_cr, t_ref0)
            if kind == "gba":
                self.kstore, self.pstore, self.lstore = self._gba_j(
                    self.kstore, self.pstore, self.lstore, iters=arg
                )
            else:
                self._run_fiba_window(*arg)
                if not self._deferred_ba:  # final chunk: refresh live state
                    self.v_w = self.kstore.v_w[k]
                    self.bg = self.kstore.bg[k]
                    self.ba = self.kstore.ba[k]
            self.R = lie._mm(R_cr, self.kstore.R[k])
            self.t = lie._einsum("ij,j->i", R_cr, self.kstore.t[k]) + t_cr
            self._map_event_cooldown = max(self._map_event_cooldown, 2)
            n_run += 1

    def _apply_scale(self, s: float):
        """Rescale the whole map by `s` (mono-inertial metric scale;
        reference Map::ApplyScaledRotation src/Map.cc:657 — which forgets
        MapLines; lines are transformed here)."""
        self.pstore = dataclasses.replace(self.pstore, x=self.pstore.x * s)
        self.lstore = dataclasses.replace(self.lstore, seg=self.lstore.seg * s)
        self.kstore = dataclasses.replace(
            self.kstore, t=self.kstore.t * s, v_w=self.kstore.v_w * s
        )
        self.t = self.t * s
        self.t_prev = self.t_prev * s
        self.v_w = self.v_w * s
        # pending entries are (stamp, ref, R_cr, t_cr, R_abs, t_abs);
        # uniform scaling multiplies every translation (t_cr = t_cw - R_cr t_r
        # is linear in the scaled translations)
        self._traj_pending = [
            (st, ref, R_cr, t_cr * s, R_abs, t_abs * s)
            for st, ref, R_cr, t_cr, R_abs, t_abs in self._traj_pending
        ]
        self._traj_done = [
            (st, R_wc, p * s) for st, R_wc, p in self._traj_done
        ]

    def _try_imu_init(self):
        """3-stage IMU initialization over the keyframe chain (reference:
        LocalMapping::InitializeIMU, src/LocalMapping.cc:1154-1335):
        1. gyro bias from visual-vs-preintegrated keyframe rotations;
        2. joint MAP over gravity direction, (mono) scale, biases and
           per-KF velocities with the poses fixed
           (solve/imu_init.inertial_optimization = the reference's
           Optimizer::InertialOptimization, src/Optimizer.cc:5241);
        3. FullInertialBA over the whole map (src/Optimizer.cc:369).
        VIBA1/VIBA2 refinement is re-dispatched from _process_frame at
        +5 s / +15 s (reference LocalMapping.cc:151-196).
        """
        import time as _time

        from pli_slam_tpu.solve import imu_init as ii
        from pli_slam_tpu.solve import inertial as inr

        _t0 = _time.perf_counter()

        def _log(accepted, reason, **kw):
            rec = {
                "n_kf": int(self.n_kf), "accepted": bool(accepted),
                "reason": reason,
                "wall_ms": (_time.perf_counter() - _t0) * 1e3,
            }
            rec.update(kw)
            self.imu_init_log.append(rec)

        n = self.n_kf
        # the reference refuses to initialize with fewer than 10 keyframes
        # (LocalMapping::InitializeIMU nMinKF, src/LocalMapping.cc:1160-1173)
        # — a thin keyframe set under-constrains the inertial-only MAP and
        # yields wrong velocities/biases that then poison inertial tracking
        if n < self.cfg.imu.init_min_kfs:
            return _log(False, "too_few_keyframes")
        window = np.arange(n)
        stacked, imu_mask = self._kf_chain(window)
        if imu_mask.sum() < 3:
            return _log(False, "too_few_preintegrations")
        ks = self.kstore
        R_k = ks.R[:n]
        t_k = ks.t[:n]
        # body states from camera poses through T_cb
        R_wb = jnp.einsum("kji,jm->kim", R_k, self.ext.R_cb, precision=jax.lax.Precision.HIGHEST)
        p_wb = jnp.einsum("kji,kj->ki", R_k, self.ext.t_cb[None] - t_k, precision=jax.lax.Precision.HIGHEST)

        # stage 1: gyro bias from rotation residuals (priorG analog)
        live = np.nonzero(imu_mask)[0]
        preints = [jax.tree_util.tree_map(lambda a: a[i], stacked) for i in live]
        dRs = [lie._mm(R_wb[i].T, R_wb[i + 1]) for i in live]
        bg0 = inr.estimate_gyro_bias(preints, dRs, prior_info=1.0)

        # stage 2: joint MAP over (gravity dir, scale, bg, ba, velocities)
        Rwg0 = ii.gravity_dir_seed(stacked, jnp.asarray(imu_mask), R_wb, self.cfg.imu.gravity)
        v0 = ii.velocity_seed(p_wb, ks.stamp[:n])
        fix_scale = not self.is_mono
        if not hasattr(self, "_inertial_opt_j"):
            # jitted: run eagerly this scan-based MAP decomposes into
            # hundreds of per-op dispatches on the init frame
            self._inertial_opt_j = jax.jit(
                ii.inertial_optimization,
                static_argnames=("imu_cfg", "prior_g", "prior_a",
                                 "fix_scale", "fix_bias"),
            )
        Rwg, s, bg, ba, v, _costs = self._inertial_opt_j(
            stacked, jnp.asarray(imu_mask), R_wb, p_wb, v0, Rwg0, bg0,
            jnp.zeros(3), imu_cfg=self.cfg.imu,
            prior_g=1e2, prior_a=1e6 if self.is_mono else 1e5,
            fix_scale=fix_scale,
        )
        g_w = lie._einsum(
            "ij,j->i", Rwg, jnp.asarray([0.0, 0.0, -self.cfg.imu.gravity])
        )
        if not bool(jnp.all(jnp.isfinite(g_w))):
            return _log(False, "nonfinite_gravity")
        self.gravity_w = g_w
        self.bg = bg
        self.ba = ba
        scale = float(s)
        if not fix_scale and abs(scale - 1.0) > 1e-3 and scale > 1e-3:
            self._apply_scale(scale)
            v = v * scale
        self.kstore = dataclasses.replace(
            self.kstore,
            v_w=self.kstore.v_w.at[:n].set(v),
            bg=self.kstore.bg.at[:n].set(jnp.broadcast_to(bg, (n, 3))),
            ba=self.kstore.ba.at[:n].set(jnp.broadcast_to(ba, (n, 3))),
        )
        self.v_w = v[n - 1]
        self.imu_ready = True
        # stage 3: full-map visual-inertial BA
        self._full_inertial_ba()
        # NOTE: no standalone gravity refinement here — an inertial-only
        # Rwg/velocity pass right after FIBA moves gravity without
        # reconciling the FIBA-refined per-KF biases and measurably
        # destabilizes the first fused-VI keyframes (ablated: ATE 0.14 ->
        # 0.59 on the 70-frame VI scene). Gravity is refined at the
        # VIBA1/VIBA2 gates instead, where the queued FIBA chunks that
        # follow re-optimize the whole state jointly (the reference's
        # staged InertialOptimization -> FullInertialBA pattern,
        # src/LocalMapping.cc:151-196).
        self._imu_init_stamp = float(self.kstore.stamp[n - 1])
        self._viba_stage = 0
        g_np = np.asarray(g_w)
        grav_angle = float(np.degrees(np.arccos(np.clip(
            -g_np[2] / max(np.linalg.norm(g_np), 1e-9), -1.0, 1.0
        ))))
        _log(True, "ok", scale=scale, gravity_angle_deg=grav_angle,
             bg=np.asarray(bg).tolist(), ba=np.asarray(ba).tolist(),
             cost0=float(_costs[0]), cost1=float(_costs[-1]))

    def _scale_refinement(self, fix_scale: bool = False):
        """Scale + gravity-direction refinement (reference
        LocalMapping::ScaleRefinement src/LocalMapping.cc:1337 ->
        Optimizer::InertialOptimization(Map*,Rwg,scale) overload,
        src/Optimizer.cc:5755): re-estimate (scale, Rwg) over the
        keyframe chain with biases pinned by effectively-infinite priors,
        and rescale the map when the correction exceeds the reference's
        0.2% threshold (LocalMapping.cc:195).

        `fix_scale=True` is the STEREO variant used at the VIBA1/VIBA2
        gates: it refines only the gravity direction + velocities.
        Without it, residual init gravity misalignment (a few degrees)
        gets absorbed into per-KF accelerometer biases by the windowed
        VI-BA (~9.81*sin(err) m/s^2 of spurious ba) — the reference
        avoids this by refining Rwg inside its staged VIBA
        (LocalMapping.cc:151-196 -> InertialOptimization)."""
        from pli_slam_tpu.solve import imu_init as ii

        n = self.n_kf
        if n < 4 or self.gravity_w is None:
            return
        window = np.arange(n)
        stacked, imu_mask = self._kf_chain(window)
        if imu_mask.sum() < 3:
            return
        ks = self.kstore
        R_k, t_k = ks.R[:n], ks.t[:n]
        R_wb = jnp.einsum("kji,jm->kim", R_k, self.ext.R_cb, precision=jax.lax.Precision.HIGHEST)
        p_wb = jnp.einsum("kji,kj->ki", R_k, self.ext.t_cb[None] - t_k, precision=jax.lax.Precision.HIGHEST)
        # current gravity dir as the seed rotation
        g0 = jnp.asarray([0.0, 0.0, -self.cfg.imu.gravity])
        gw = self.gravity_w / jnp.linalg.norm(self.gravity_w)
        gz = g0 / jnp.linalg.norm(g0)
        v_axis = jnp.cross(gz, gw)
        s_ang = jnp.linalg.norm(v_axis)
        Rwg0 = jnp.where(
            s_ang > 1e-6,
            lie.so3_exp(v_axis / jnp.maximum(s_ang, 1e-9) * jnp.arcsin(jnp.clip(s_ang, -1, 1))),
            jnp.eye(3),
        )
        Rwg, s, _bg, _ba, v, _costs = ii.inertial_optimization(
            stacked, jnp.asarray(imu_mask), R_wb, p_wb, ks.v_w[:n], Rwg0,
            self.bg, self.ba, self.cfg.imu,
            fix_scale=fix_scale, fix_bias=True,  # (scale/)Rwg/velocities only
        )
        scale = float(s)
        if not np.isfinite(scale) or scale <= 1e-3:
            return
        g_w = lie._einsum("ij,j->i", Rwg, g0)
        if not bool(jnp.all(jnp.isfinite(g_w))):
            return
        self.gravity_w = g_w
        if not fix_scale and abs(scale - 1.0) > 0.002:
            self._apply_scale(scale)
            v = v * scale
        self.kstore = dataclasses.replace(
            self.kstore, v_w=self.kstore.v_w.at[:n].set(v)
        )
        self.v_w = v[n - 1]

    def _body_state(self):
        from pli_slam_tpu.solve import inertial as inr

        return inr.body_state_from_camera(
            self.R, self.t, self.v_w, self.bg, self.ba, self.ext
        )

    # -- Atlas: new map on persistent loss ---------------------------------
    def _switch_to_new_map(self):
        import dataclasses as _dc

        from pli_slam_tpu.worldmap.atlas import MapBundle

        self._flush_trajectory()  # pending poses reference old-map KF slots

        # park the map WITH its BoW database so later place recognition
        # can re-find it and merge back (reference MergeLocal,
        # src/LoopClosing.cc:1096; round-2 verdict Missing #1)
        self.atlas.maps[self.atlas.active_idx] = MapBundle(
            pstore=self.pstore, lstore=self.lstore, kstore=self.kstore,
            n_kf=self.n_kf, bow_db=self.bow_db,
        )
        fresh = self.atlas.create_new_map()
        self.pstore = fresh.pstore
        self.lstore = fresh.lstore
        self.kstore = fresh.kstore
        self.n_kf = 0
        self.state = TrackingState.NOT_INITIALIZED
        self._reset_motion()
        self._lost_frames = 0
        self.frames_since_kf = 0
        self._pending_stats = None
        self._preint_since_kf = None
        self._pints = type(self._pints).empty(self.cfg.map.max_keyframes)
        self._kf_views = []
        self._kf_view_dev = _empty_kf_views(self.cfg)
        self._local_pt = _empty_local_map(self.cfg)
        self._deferred_ba = []  # pending chunks reference old-map slots
        # IMU must re-initialize on the fresh map (reference: the new map
        # starts NOT_INITIALIZED inertial-wise, Tracking::CreateMapInAtlas)
        self.imu_ready = False
        self.gravity_w = None
        self._viba_stage = None
        self.v_w = jnp.zeros(3)
        self._vi_fused_active = False
        self._preint_acc = None
        if self.is_mono:
            self._mono_init_frame = None
        from pli_slam_tpu.worldmap import vocab as vocab_mod

        self.bow_db = vocab_mod.BowDatabase.empty(
            self.cfg.map.max_keyframes, self.voc_pt.n_words
        )
        if self.loop_closer is not None:
            from pli_slam_tpu.frontend.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self.cfg)

    # -- Atlas: merge the active map back into a parked map ---------------
    def _try_merge(self, kf_slot: int) -> bool:
        """Query parked maps' BoW databases with the new keyframe; on a
        temporally-consistent hit, verify geometrically (3D-3D SE3 RANSAC
        over cross-map landmark matches) and weld the active map into the
        parked one (reference LoopClosing::NewDetectCommonRegions merge
        branch -> MergeLocal/MergeLocal2, src/LoopClosing.cc:246,1096).
        """
        if self.atlas.n_maps() <= 1 or self.n_kf < 2:
            return False
        from pli_slam_tpu.frontend.loop_closing import match_cross_map
        from pli_slam_tpu.solve import sim3 as sim3_mod
        from pli_slam_tpu.worldmap import vocab as vocab_mod

        if not hasattr(self, "_bow_of_kf_j"):
            voc_pt, voc_ln = self.voc_pt, self.voc_ln

            def _bow_of_kf(ks, ps, ls, k):
                ids = ks.obs_pt[k]
                m = (ids >= 0) & ps.valid[jnp.maximum(ids, 0)]
                bow_p = voc_pt.bow(ps.desc[jnp.maximum(ids, 0)], m)
                lids = ks.obs_ln[k]
                lm = (lids >= 0) & ls.valid[jnp.maximum(lids, 0)]
                bow_l = voc_ln.bow(ls.desc[jnp.maximum(lids, 0)], lm)
                return bow_p, bow_l

            self._bow_of_kf_j = jax.jit(_bow_of_kf)
            self._query_db_j = jax.jit(
                lambda db, bp, bl: vocab_mod.query(
                    db, bp, bl, jnp.zeros(db.valid.shape[0], bool), n_best=1
                )
            )
            self._match_cross_j = jax.jit(match_cross_map)
            from pli_slam_tpu.frontend.loop_closing import scene_scaled_thresh

            self._ransac_merge_j = jax.jit(
                lambda x, y, m, key: sim3_mod.ransac_sim3(
                    x, y, m, key,
                    n_hypotheses=self.cfg.loop.sim3_hypotheses,
                    inlier_thresh=scene_scaled_thresh(x, m),
                    with_scale=False,
                )
            )

        bow_p, bow_l = self._bow_of_kf_j(self.kstore, self.pstore, self.lstore, kf_slot)
        # dispatch every parked map's query WITHOUT syncing, then read all
        # results in one stacked transfer (a per-map host sync inside
        # this loop taxes exactly the KF frames that are already the
        # slowest)
        cand_maps = []
        lazy = []
        for mi, bundle in enumerate(self.atlas.maps):
            if mi == self.atlas.active_idx or bundle.bow_db is None:
                continue
            slots, scores = self._query_db_j(bundle.bow_db, bow_p, bow_l)
            cand_maps.append(mi)
            lazy.append((slots[0], scores[0]))
        best = (-1, -1, -1.0)
        if lazy:
            packed = np.asarray(jnp.stack(
                [jnp.stack([s.astype(jnp.float32), sc]) for s, sc in lazy]
            ))  # one host<->device sync for ALL parked maps
            for mi, (slot_f, score) in zip(cand_maps, packed):
                if float(score) > best[2]:
                    best = (mi, int(slot_f), float(score))
        mi, k_dst, score = best
        if mi < 0 or k_dst < 0 or score < 0.12:
            self._merge_streak = 0
            return False
        if self._merge_map_idx == mi and abs(k_dst - self._merge_kf) <= 3:
            self._merge_streak += 1
        else:
            self._merge_streak = 1
        self._merge_map_idx, self._merge_kf = mi, k_dst
        if self._merge_streak < 2:
            return False

        dst = self.atlas.maps[mi]
        xa, xb, idx_b, m = self._match_cross_j(
            self.kstore, self.pstore, kf_slot, dst.kstore, dst.pstore, k_dst
        )
        key = jax.random.PRNGKey(1000 + kf_slot)
        R_rel, t_rel, s_rel, inl, n_in = self._ransac_merge_j(xa, xb, m, key)
        if int(n_in) < self.cfg.loop.sim3_min_inliers:
            return False

        # weld: active INTO the parked map; verified inlier matches fuse
        from pli_slam_tpu.worldmap.atlas import MapBundle

        self._flush_trajectory()  # KF slots are about to be remapped

        fuse_src = jnp.where(inl, self.kstore.obs_pt[kf_slot], -1)
        fuse_dst = jnp.where(inl, idx_b, -1)
        self.atlas.maps[self.atlas.active_idx] = MapBundle(
            pstore=self.pstore, lstore=self.lstore, kstore=self.kstore,
            n_kf=self.n_kf, bow_db=self.bow_db,
        )
        merged = self.atlas.merge_active_into(mi, R_rel, t_rel, fuse_src, fuse_dst)
        kf_slots = self.atlas.last_kf_slots  # src slot -> merged slot
        self.pstore = merged.pstore
        self.lstore = merged.lstore
        self.kstore = merged.kstore
        self.n_kf = merged.n_kf
        # current pose into the merged world: T_cw' = T_cw ∘ T_rel^-1
        Rr_inv, tr_inv = lie.se3_inverse(R_rel, t_rel)
        self.t = lie._einsum("ij,j->i", self.R, tr_inv) + self.t
        self.R = lie._mm(self.R, Rr_inv)
        self._reset_motion()
        # inertial-aware merge (reference MergeLocal2 + MergeInertialBA,
        # src/LoopClosing.cc:1761, src/Optimizer.cc:6858): the active
        # side's per-KF preintegration chain survives the weld — remap it
        # through kf_slots (a factor spans new k-1 -> k only if both
        # endpoints stayed adjacent), and rotate gravity/velocity state
        # into the merged (target-map) world frame.
        self._pints = self._pints.remap(kf_slots)
        if self.gravity_w is not None:
            self.gravity_w = lie._einsum("ij,j->i", R_rel, self.gravity_w)
            self.v_w = lie._einsum("ij,j->i", R_rel, self.v_w)
        self._preint_since_kf = None
        self._kf_views = []
        # remap the DEVICE view ring's kf_slot entries through the merge
        # slot map: its stored slots refer to pre-merge keyframe indices,
        # and far_point_depths reads poses live via kstore.R[kf_slot] —
        # stale slots would triangulate against the parked map's poses
        # and let wrong-depth far landmarks pass gating
        uvv, descv, validv, slotv = self._kf_view_dev
        slot_map = jnp.asarray(
            np.concatenate([kf_slots.astype(np.int32), [-1]]), jnp.int32
        )
        new_slot = slot_map[jnp.clip(slotv, -1, len(kf_slots) - 1)]
        self._kf_view_dev = (
            uvv, descv, validv & (new_slot >= 0)[:, None], new_slot
        )
        self._deferred_ba = []  # pending chunks reference pre-merge slots
        self.rebuild_bow()
        merged.bow_db = None
        if self.loop_closer is not None:
            from pli_slam_tpu.frontend.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self.cfg)
        self._merge_streak = 0
        self._merge_map_idx = -1
        # welding BA across the seam: newest active-side keyframes + the
        # matched parked-side neighborhood, parked side fixed (reference
        # MergeBundleAdjustmentVisual, src/Optimizer.cc:5858). With IMU
        # initialized the weld optimizes velocities/biases too, with the
        # surviving preintegration factors across the active-side chain
        # (reference MergeInertialBA, src/Optimizer.cc:6858).
        W = self.cfg.opt.local_ba_window
        half = W // 2
        old_side = [k_dst + i - half // 2 for i in range(W - half)]
        new_side = [self.n_kf - half + i for i in range(half)]  # ascending tail
        window = np.asarray(
            [min(max(s, 0), self.n_kf - 1) for s in old_side + new_side], np.int32
        )
        fixed = np.zeros(W, bool)
        fixed[: W - half] = True  # parked side is the anchor
        for i in range(W):
            if window[i] in window[:i]:
                fixed[i] = True
        if self.imu_ready and self.gravity_w is not None:
            stacked, imu_mask = self._kf_chain(window)
            self.kstore, self.pstore, self.lstore = self._vi_ba(
                self.kstore, self.pstore, self.lstore,
                jnp.asarray(window), jnp.asarray(fixed),
                stacked, jnp.asarray(imu_mask), self.gravity_w, self.ext,
            )
        else:
            self.kstore, self.pstore, self.lstore = self._ba(
                self.kstore, self.pstore, self.lstore,
                jnp.asarray(window), jnp.asarray(fixed),
            )
        self.R = self.kstore.R[self.n_kf - 1]
        self.t = self.kstore.t[self.n_kf - 1]
        return True

    # -- relocalization (reference Tracking::Relocalization :4176) --------
    def _relocalize(self, frame) -> bool:
        """BoW candidates -> per-candidate PnP RANSAC (reference MLPnP
        loop, src/Tracking.cc:4223-4249) -> wide re-track from the PnP
        pose. PnP needs no pose seed, so it recovers kidnaps whose
        baseline exceeds any matching window. Stereo/RGB-D lifts
        hypotheses with the depth seed; mono uses the depth-free DLT
        hypothesis path (the reference's MLPnP is mono-native — it
        consumes bearing vectors only, src/MLPnPsolver.cpp).
        """
        if self.n_kf == 0:
            return False
        if not hasattr(self, "_pnp_reloc_j"):
            cam, cfg = self.cam, self.cfg
            mono = self.is_mono

            def _pnp_reloc(frame, pstore, key):
                # pose-free 2D-3D association against the WHOLE landmark
                # store (one ungated int8 matmul) — richer than the
                # reference's per-candidate SearchByBoW
                from pli_slam_tpu.solve import pnp as pnp_mod

                dist = matching.hamming_matrix(frame.feats.desc, pstore.desc)
                idx, best, okm = matching.match_nn(
                    dist, frame.feats.valid, pstore.valid,
                    max_dist=cfg.match.orb_th_low, ratio=0.8,
                )
                okm = matching.mutual_consistency(
                    idx, okm, dist, frame.feats.valid, pstore.valid
                )
                x_w = pstore.x[jnp.maximum(idx, 0)]
                if not mono:
                    okm = okm & (frame.depth > 0)
                return pnp_mod.solve_pnp(
                    cam, x_w, frame.feats.uv, frame.u_right, frame.stereo_ok,
                    frame.depth, frame.sigma2, okm, key, cfg.opt,
                    inlier_px=8.0, min_inliers=12, mono=mono,
                )

            self._pnp_reloc_j = jax.jit(_pnp_reloc)
        seeds = []
        # PnP from scratch (pose-free); candidate-pose re-tracks below
        # remain as fallback. The PnP's own RANSAC inlier floor is the
        # only gate here — every seed is then evaluated by a wide
        # re-track against min_inliers_local_map, which is the real
        # accept/reject decision (a marginal PnP pose frequently
        # re-tracks to several times its RANSAC count).
        Rp, tp, inl_p, n_p, okp = self._pnp_reloc_j(
            frame, self.pstore, jax.random.PRNGKey(7000 + len(self.stats))
        )
        if bool(okp):
            seeds.append((Rp, tp))
        slots, scores = self._bow_query_frame(
            self.bow_db, frame.feats.desc, frame.feats.valid,
            frame.lines.desc, frame.lines.valid,
            n_best=self.cfg.loop.bow_candidates,
        )
        slots = np.asarray(slots)
        scores = np.asarray(scores)
        for c in range(self.cfg.loop.bow_candidates):
            k = int(slots[c])
            if k < 0 or float(scores[c]) <= 0.05:
                continue
            seeds.append((self.kstore.R[k], self.kstore.t[k]))
        # evaluate every seed and keep the BEST re-track: in self-similar
        # scenes an aliased seed can clear a bare minimum, but the true
        # pose re-acquires far more of the local map
        best_n = 0
        best_pose = None
        for R0, t0 in seeds:
            (R, t, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore) = self._track(
                frame, R0, t0, self.pstore, self.lstore, jnp.asarray(True)
            )
            if int(n_in) > best_n:
                best_n = int(n_in)
                best_pose = (R, t)
        if best_pose is not None and best_n >= self.cfg.tracking.min_inliers_local_map:
            self.R, self.t = best_pose
            self._reset_motion()
            self.state = TrackingState.OK
            # re-anchor the local tracking map at the nearest keyframe to
            # the recovered pose (the old local map covers the pre-loss
            # region and would starve the fused matcher)
            if self.n_kf > 0:
                cw = np.asarray(self.t)
                t_k = np.asarray(self.kstore.t[: self.n_kf])
                valid_k = np.asarray(self.kstore.valid[: self.n_kf])
                d = np.linalg.norm(t_k - cw[None], axis=1)
                d[~valid_k] = np.inf
                self._refresh_local_map(int(np.argmin(d)))
            return True
        return False

    # -- keyframe culling (reference LocalMapping::KeyFrameCulling :895) ---
    def _cull_keyframes(self):
        """Invalidate redundant keyframes: >=90% of their landmarks are
        observed by >= cull_min_obs other keyframes. Recent KFs and KF 0
        are kept (gauge / active window)."""
        if self.n_kf < self.cfg.opt.local_ba_window + 2:
            return
        lo, hi = 1, self.n_kf - self.cfg.opt.local_ba_window
        if hi <= lo:
            return
        obs = self.kstore.obs_pt[lo:hi]  # [Kc, S]
        has = obs >= 0
        n_obs = self.pstore.n_obs[jnp.maximum(obs, 0)]
        redundant_frac = jnp.sum(
            (n_obs >= self.cfg.map.cull_min_obs + 1) & has, axis=1
        ) / jnp.maximum(jnp.sum(has, axis=1), 1)
        cull = (redundant_frac >= self.cfg.map.kf_cull_redundancy) & self.kstore.valid[lo:hi]
        self.kstore = dataclasses.replace(
            self.kstore, valid=self.kstore.valid.at[lo:hi].set(self.kstore.valid[lo:hi] & ~cull)
        )

    def reset_active_map(self):
        """Discard the active map and start fresh, keeping parked Atlas
        maps (reference System::ResetActiveMap -> Tracking::ResetActiveMap;
        dispatched on bad-IMU detection, src/LocalMapping.cc:111-121, and
        on timestamp anomalies, src/Tracking.cc:1382-1418)."""
        from pli_slam_tpu.worldmap import stores as st

        self._flush_trajectory()  # pending poses reference old-map KF slots
        m = self.cfg.map
        self.pstore = st.PointStore.empty(m.max_points)
        self.lstore = st.LineStore.empty(m.max_lines)
        self.kstore = st.KeyFrameStore.empty(
            m.max_keyframes, self.cfg.orb.n_features, self.cfg.lines.n_lines
        )
        self.n_kf = 0
        self.state = TrackingState.NOT_INITIALIZED
        self._reset_motion()
        self._lost_frames = 0
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self._pending_stats = None
        self._preint_since_kf = None
        self._pints = type(self._pints).empty(self.cfg.map.max_keyframes)
        self._kf_view_dev = _empty_kf_views(self.cfg)
        self._local_pt = _empty_local_map(self.cfg)
        self._deferred_ba = []
        self.imu_ready = False
        self.gravity_w = None
        self._viba_stage = None
        self.v_w = jnp.zeros(3)
        self.bg = jnp.zeros(3)
        self.ba = jnp.zeros(3)
        self._vi_fused_active = False
        self._preint_acc = None
        self._first_imu_stamp = None
        self._last_imu_raw = None
        if self.is_mono:
            self._mono_init_frame = None
        from pli_slam_tpu.worldmap import vocab as vocab_mod

        self.bow_db = vocab_mod.BowDatabase.empty(
            self.cfg.map.max_keyframes, self.voc_pt.n_words
        )
        if self.loop_closer is not None:
            from pli_slam_tpu.frontend.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self.cfg)

    def _check_timestamp(self, stamp: float) -> None:
        """Timestamp anomaly guard (reference Tracking::Track,
        src/Tracking.cc:1382-1418): a frame OLDER than its predecessor
        resets the active map; a forward jump > 1 s with an inertial
        sensor parks the map (if IMU was initialized — its preintegration
        chain is broken beyond repair) or resets it."""
        prev, self._prev_stamp = self._prev_stamp, float(stamp)
        if prev is None or self.state == TrackingState.NOT_INITIALIZED:
            return
        if stamp < prev:
            self.reset_active_map()
        elif stamp - prev > 1.0 and self.use_imu:
            if self.imu_ready:
                self._switch_to_new_map()
            else:
                self.reset_active_map()

    # -- main entries ------------------------------------------------------
    def process(self, img_l, img_r, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Stereo / stereo-inertial frame (reference System::TrackStereo)."""
        self._check_timestamp(stamp)
        img_args = (jnp.asarray(img_l), jnp.asarray(img_r))
        if self.use_imu:
            # post-IMU-init stereo-inertial frames run the fused
            # one-dispatch VI program; pre-init and rare paths (loss,
            # reloc) stay host-orchestrated
            if (
                self.imu_ready
                and self.gravity_w is not None
                and self.state == TrackingState.OK
                and not self.is_mono
            ):
                return self._process_fused_vi(img_args, stamp, allow_mapping, imu)
            if getattr(self, "_vi_fused_active", False):
                self._exit_vi_fused()
            frame = self.build_frame(*img_args)
            return self._process_frame(frame, stamp, allow_mapping, imu)
        if self.state == TrackingState.NOT_INITIALIZED:
            frame = self.build_frame(*img_args)
            return self._process_frame(frame, stamp, allow_mapping, imu)
        return self._process_fused(img_args, stamp, allow_mapping)

    def process_rgbd(self, img, depth, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """RGB-D frame (reference System::TrackRGBD, src/System.h:112)."""
        self._check_timestamp(stamp)
        img_args = (jnp.asarray(img), jnp.asarray(depth))
        if self.use_imu or self.state == TrackingState.NOT_INITIALIZED:
            frame = self.build_frame_rgbd(*img_args)
            return self._process_frame(frame, stamp, allow_mapping, imu)
        return self._process_fused(img_args, stamp, allow_mapping)

    def _process_fused(self, img_args, stamp: float, allow_mapping: bool) -> dict:
        """One-dispatch visual frame: the whole build->track->KF->BA->BoW
        pipeline runs on device; the host syncs one 12-float stats vector
        and handles only the rare paths (loss, relocalization, loop
        verification).

        With `self.streaming` set, the host reads the PREVIOUS frame's
        stats instead (which the device has already finished), so the
        sync latency overlaps the current frame's compute — this is the
        real-time replay mode (a design choice not yet measured on the
        card). Rare-path reactions
        then lag one frame, exactly like the reference's asynchronous
        LocalMapping/LoopClosing threads.
        """
        (R, t, R_prev, t_prev, vel_xi, has_vel_dev,
         self.pstore, self.lstore, self.kstore, self.bow_db, self._kf_view_dev,
         self._local_pt,
         pt_idx, pt_in, ln_idx, ln_in, counters, stats_dev, rel) = self._step(
            img_args, stamp, self.R, self.t, self.R_prev, self.t_prev,
            self.vel_xi, self.has_vel,
            self.n_kf, self.frames_since_kf, self.last_kf_inliers, allow_mapping,
            self.pstore, self.lstore, self.kstore, self.bow_db, self._kf_view_dev,
            self._local_pt,
        )
        self.R, self.t, self.R_prev, self.t_prev = R, t, R_prev, t_prev
        self.vel_xi = vel_xi
        # chain the DEVICE-computed motion-model flag: deriving it from the
        # (lag-1) stats readout made streaming mode track one frame without
        # motion-model prediction, which cascaded into a different keyframe
        # set and 3.5x worse ATE (round-2 regression root cause)
        self.has_vel = has_vel_dev
        # relative-to-KF trajectory entry, computed in-step (no extra dispatch)
        self._traj_pending.append((stamp, rel[0], rel[1], rel[2], R, t))
        return self._finish_fused(stamp, stats_dev, img_args, counters)

    def _finish_fused(self, stamp, stats_dev, img_args, counters) -> dict:
        """Shared stats-consumption tail of the fused visual and fused
        stereo-inertial per-frame paths (lag-1 in streaming mode)."""
        if self.streaming:
            # chain counters on device; consume the previous frame's stats
            self.n_kf, self.frames_since_kf, self.last_kf_inliers = counters
            # start the device->host copy NOW so next frame's read finds
            # the value already local — np.asarray would otherwise issue
            # the transfer lazily and serialize a round-trip into every
            # frame
            try:
                stats_dev.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
            pending, self._pending_stats = self._pending_stats, (stamp, stats_dev, img_args)
            if pending is None:
                info = {"state": self.state, "n_inliers": 0, "n_kf": 0,
                        "n_points": 0, "n_lines": 0, "new_landmarks": 0}
                self.stats.append(info)
                return info
            stamp_p, stats_dev, img_args = pending
            stats = np.asarray(stats_dev)
        else:
            stats = np.asarray(stats_dev)  # the single host<->device sync
            self.n_kf = int(stats[ST_NKF])
            self.frames_since_kf = int(stats[ST_FSKF])
            self.last_kf_inliers = int(stats[ST_LASTKFIN])

        ok = stats[ST_OK] > 0
        n_inliers = int(stats[ST_NIN])

        if ok:
            self.state = TrackingState.OK
            self._lost_frames = 0
        else:
            self.state = TrackingState.RECENTLY_LOST
            self._lost_frames += 1
            if self._lost_frames >= 2:
                frame = (self.build_frame_rgbd(*img_args) if self.is_rgbd
                         else self.build_frame(*img_args))
                if self._relocalize(frame):
                    n_inliers = self.cfg.tracking.min_inliers_local_map
                    self._lost_frames = 0
                elif self._lost_frames > self.cfg.tracking.recently_lost_sec * self.cfg.fps:
                    self._switch_to_new_map()

        if stats[ST_KF_CREATED] > 0:
            if self.loop_closer is not None:
                cands = [
                    (int(stats[ST_LOOP_SLOT + c]), float(stats[ST_LOOP_SCORE + c]))
                    for c in range(N_LOOP_CANDS)
                ]
                self.loop_closer.on_keyframe(self, int(stats[ST_KF_SLOT]), cands)
            self._try_merge(int(stats[ST_KF_SLOT]))
        elif self._deferred_ba:
            # amortized post-loop GBA: one bounded chunk on a non-KF frame
            self.run_deferred_ba()
        info = {
            "state": self.state,
            "n_inliers": n_inliers,
            "n_kf": int(stats[ST_NKF]),
            "n_points": int(stats[ST_NPTS]),
            "n_lines": int(stats[ST_NLNS]),
            "new_landmarks": int(stats[ST_NNEW]),
        }
        self.stats.append(info)
        return info

    def _process_fused_vi(self, img_args, stamp: float, allow_mapping: bool, imu: dict | None) -> dict:
        """One-dispatch stereo-inertial frame (post-IMU-init): the whole
        preintegrate->predict->inertial-track->KF/VI-BA/BoW pipeline runs
        on device (make_step_vi); the host syncs one stats vector (lag-1
        in streaming mode) and handles only rare paths + the VIBA1/VIBA2
        refinement schedule (reference LocalMapping.cc:151-196)."""
        from pli_slam_tpu.ops import imu as imu_ops

        if not self._vi_fused_active:
            self._vi_fused_active = True
            acc = self._preint_since_kf
            self._preint_acc = (
                acc if acc is not None
                else imu_ops.identity_with_bias(self.bg, self.ba)
            )
            self._preint_since_kf = None
            self.last_preint = None
        # ONE packed [T, 8] upload per frame (g | a | dt | mask) instead
        # of four small transfers (a design choice not yet measured on
        # the card)
        imu_packed = self._imu_batch_arrays(imu, packed=True)
        wide = self._map_event_cooldown > 0
        if wide:
            self._map_event_cooldown -= 1
        (R, t, R_prev, t_prev, self.v_w, self.bg, self.ba, self._preint_acc,
         self.pstore, self.lstore, self.kstore, self.bow_db,
         self._kf_view_dev, self._local_pt, self._pints,
         pt_idx, pt_in, ln_idx, ln_in, counters, stats_dev, rel) = self._step_vi(
            img_args, imu_packed, stamp, self.R, self.t,
            self.v_w, self.bg, self.ba, self.gravity_w, self._preint_acc,
            self.ext, self.n_kf, self.frames_since_kf, self.last_kf_inliers,
            allow_mapping, wide, self.pstore, self.lstore, self.kstore, self.bow_db,
            self._kf_view_dev, self._local_pt, self._pints,
        )
        self.R, self.t, self.R_prev, self.t_prev = R, t, R_prev, t_prev
        self._traj_pending.append((stamp, rel[0], rel[1], rel[2], R, t))
        info = self._finish_fused(stamp, stats_dev, img_args, counters)
        # staged VIBA refinement (reference VIBA1 at +5 s, VIBA2 at +15 s)
        # — queued as per-frame chunks like the post-loop GBA, so the
        # full-map sweep never lands on a single frame's budget
        if (
            self.state == TrackingState.OK
            and self._viba_stage is not None
            and self._viba_stage < 2
            and not self._deferred_ba
        ):
            dt_init = stamp - self._imu_init_stamp
            gate = 5.0 if self._viba_stage == 0 else 15.0
            if dt_init > gate:
                # NOTE: no standalone gravity refinement here — an
                # inertial-only Rwg/velocity overwrite between frames
                # leaves the live state inconsistent until the deferred
                # FIBA chunks land, and measurably collapses tracking at
                # exactly this gate (flagship bench ablation). The FIBA
                # chunks themselves reconcile gravity/bias/velocity
                # jointly (reference FullInertialBA in VIBA1/2).
                for chunk in self._fiba_schedule():
                    self._deferred_ba.append(("fiba", chunk))
                self._viba_stage += 1
        return info

    def _exit_vi_fused(self):
        """Leaving fused-VI mode (loss/reloc): hand the device-side
        per-KF accumulator back to the host-orchestrated path."""
        self._vi_fused_active = False
        if self._preint_acc is not None:
            self._preint_since_kf = self._preint_acc
            self._preint_acc = None

    def _imu_batch_arrays(self, imu: dict | None, packed: bool = False):
        """Pad/midpoint this frame's raw IMU batch to the fixed [T]
        arrays the preintegration scan consumes (reference
        Tracking::PreintegrateIMU drain loop, src/Tracking.cc:1142).

        The PREVIOUS frame's last raw sample is prepended: per-frame
        batches partition the sample stream at frame boundaries, so
        without the carried boundary sample the interval between the
        last sample of frame k-1 and the first of frame k is silently
        DROPPED — at 200 Hz / 20 fps that is 10% of every frame's
        motion, which IMU init then explains as a large fake gyro bias
        and a ~10 deg gravity error (observed on clean IMU). The
        reference's drain loop spans (t_{k-1}, t_k] for the same reason.
        """
        T = self._imu_pad
        g = np.zeros((T, 3), np.float32)
        a = np.zeros((T, 3), np.float32)
        dts = np.zeros(T, np.float32)
        mask = np.zeros(T, bool)
        if imu is not None:
            gyro = np.asarray(imu["gyro"], np.float32).reshape(-1, 3)
            acc = np.asarray(imu["acc"], np.float32).reshape(-1, 3)
            stamps = np.asarray(imu["stamps"], np.float64).reshape(-1)
            if self._first_imu_stamp is None and len(stamps):
                self._first_imu_stamp = float(stamps[0])
            prev = getattr(self, "_last_imu_raw", None)
            if prev is not None and len(stamps) and prev[0] < stamps[0] - 1e-9:
                stamps = np.concatenate([[prev[0]], stamps])
                gyro = np.vstack([prev[1], gyro])
                acc = np.vstack([prev[2], acc])
            if len(stamps):
                self._last_imu_raw = (
                    float(stamps[-1]), gyro[-1].copy(), acc[-1].copy()
                )
            n = min(len(stamps), T)
            if n >= 2:
                g[: n - 1] = 0.5 * (gyro[: n - 1] + gyro[1:n])
                a[: n - 1] = 0.5 * (acc[: n - 1] + acc[1:n])
                dts[: n - 1] = np.diff(stamps[:n]).astype(np.float32)
                mask[: n - 1] = dts[: n - 1] > 0
        if packed:
            # single [T, 8] transfer: g | a | dt | mask
            buf = np.concatenate(
                [g, a, dts[:, None], mask[:, None].astype(np.float32)], axis=1
            )
            return jnp.asarray(buf)
        return (jnp.asarray(g), jnp.asarray(a), jnp.asarray(dts), jnp.asarray(mask))

    def process_mono(self, img, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Monocular / mono-inertial frame (reference System::TrackMonocular)."""
        self._check_timestamp(stamp)
        frame = self.build_frame_mono(jnp.asarray(img))
        return self._process_frame(frame, stamp, allow_mapping, imu)

    def _process_frame(self, frame: FrameData, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        if self.use_imu and imu is not None:
            self._ingest_imu(imu, stamp)
        if self.state == TrackingState.NOT_INITIALIZED:
            if self.is_mono:
                return self._initialize_mono(frame, stamp)
            return self._initialize(frame, stamp)

        inertial_mode = self.use_imu and self.imu_ready and self.last_preint is not None
        if inertial_mode:
            from pli_slam_tpu.ops import imu as imu_ops
            from pli_slam_tpu.solve import inertial as inr

            prev_state = self._body_state()
            R_pred, v_pred, p_pred = imu_ops.predict_state(
                prev_state.R_wb, prev_state.v_w, prev_state.p_w,
                self.last_preint, self.bg, self.ba, self.gravity_w,
            )
            init_state = inr.BodyState(
                R_wb=R_pred, p_w=p_pred, v_w=v_pred, bg=self.bg, ba=self.ba
            )
            (state2, R, t, pt_idx, pt_in, ln_idx, ln_in, n_in,
             self.pstore, self.lstore) = self._track_inertial(
                frame, self.last_preint, prev_state, init_state, self.gravity_w,
                self.ext, self.pstore, self.lstore,
            )
            n_inliers = int(n_in)
            self.R_prev, self.t_prev = self.R, self.t
            if n_inliers >= self.cfg.tracking.min_inliers_track:
                self.R, self.t = R, t
                self.v_w = state2.v_w
                self.bg = state2.bg
                self.ba = state2.ba
                self.state = TrackingState.OK
                self._update_motion_model()
                self._lost_frames = 0
            else:
                # dead-reckon on the IMU (reference RECENTLY_LOST+IMU path)
                self.R, self.t = inr.camera_pose(init_state, self.ext)
                # velocity sanity clamp: dead-reckoning on noisy IMU
                # integrates bias + gravity error without bound (observed
                # 46 m/s after 2 s of loss); the reference bounds the
                # damage by declaring LOST after time_recently_lost —
                # clamp so the reloc seed poses stay finite meanwhile
                vn = float(jnp.linalg.norm(v_pred))
                v_max = 5.0
                self.v_w = v_pred * (v_max / vn) if vn > v_max else v_pred
                self.state = TrackingState.RECENTLY_LOST
                self._lost_frames += 1
                # bad-IMU detection (reference LocalMapping.cc:111-121 /
                # mbBadImu consumed at Tracking.cc:1373): tracking lost
                # within 10 s of IMU init on a small map means the
                # scale/gravity estimate was bad — reset the active map
                # rather than dead-reckon on garbage
                if (
                    self._lost_frames > self.cfg.tracking.recently_lost_sec * self.cfg.fps
                    and stamp - self._imu_init_stamp < 10.0
                    and self.n_kf <= 10
                ):
                    self.reset_active_map()
                    info = {"state": self.state, "n_inliers": 0, "n_kf": 0,
                            "n_points": 0, "n_lines": 0, "new_landmarks": 0}
                    self.stats.append(info)
                    return info
                # visual relocalization while dead-reckoning (the pose
                # prediction degrades fast on noisy IMU; PnP is the only
                # way back onto the map), then new-map-on-persistent-loss
                # (reference Tracking.cc:1590-1608)
                if self._lost_frames >= 3 and self._relocalize(frame):
                    n_inliers = self.cfg.tracking.min_inliers_local_map
                    self._lost_frames = 0
                elif self._lost_frames > self.cfg.tracking.recently_lost_sec * self.cfg.fps:
                    self._switch_to_new_map()
        else:
            R0, t0 = self._predict_pose()
            (R, t, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore) = self._track(
                frame, R0, t0, self.pstore, self.lstore,
                jnp.asarray(not (self.has_vel and self.cfg.tracking.motion_model)),
            )
            n_inliers = int(n_in)

            self.R_prev, self.t_prev = self.R, self.t
            if n_inliers >= self.cfg.tracking.min_inliers_track:
                self.R, self.t = R, t
                self.state = TrackingState.OK
                self._update_motion_model()
                self._lost_frames = 0
            else:
                # dead-reckon on the motion model (RECENTLY_LOST behavior)
                self.R, self.t = R0, t0
                self.state = TrackingState.RECENTLY_LOST
                self._lost_frames += 1
                if self._lost_frames >= 2 and self._relocalize(frame):
                    n_inliers = self.cfg.tracking.min_inliers_local_map
                    self._lost_frames = 0
                elif self._lost_frames > self.cfg.tracking.recently_lost_sec * self.cfg.fps:
                    # persistent loss: park the current map in the Atlas and
                    # start a fresh one (reference CreateMapInAtlas,
                    # src/Tracking.cc:2565; merge-back happens when place
                    # recognition later hits a stored map's keyframe)
                    self._switch_to_new_map()

        # inertial bookkeeping: initialize once enough keyframes + data
        # span exist; then staged VIBA1/VIBA2 refinement (reference
        # LocalMapping.cc:137-196)
        if self.use_imu and self.last_preint is not None and self.state == TrackingState.OK:
            if not self.imu_ready:
                if (
                    self._first_imu_stamp is not None
                    and stamp - self._first_imu_stamp >= self.cfg.imu.init_time_sec
                ):
                    self._try_imu_init()
            elif self._viba_stage is not None and self._viba_stage < 2:
                dt_init = stamp - self._imu_init_stamp
                gate = 5.0 if self._viba_stage == 0 else 15.0
                if dt_init > gate:
                    self._full_inertial_ba()
                    self._viba_stage += 1
            elif (
                self.is_mono
                and self._viba_stage == 2
                and stamp - self._imu_init_stamp < 50.0
                and self.frames_since_kf == 0
            ):
                # mono scale drift: periodic scale/gravity-only refinement
                # while the map is young (reference LocalMapping.cc:188-196)
                self._scale_refinement()

        self.frames_since_kf += 1
        # KF decision (reference NeedNewKeyFrame c1a/c2): compare against
        # what the reference keyframe OBSERVES (inliers + landmarks it
        # created), which is stable — not against the degraded inlier
        # count at its creation time.
        need_kf = (
            self.state == TrackingState.OK
            and n_inliers >= self.cfg.tracking.kf_min_inliers
            and self.frames_since_kf > max(self.cfg.tracking.kf_min_interval, 1)
            and (
                self.frames_since_kf >= self.cfg.tracking.kf_max_interval
                or n_inliers < self.cfg.tracking.kf_ref_ratio * max(self.last_kf_inliers, 1)
            )
        )
        n_new = 0
        if allow_mapping and need_kf and self.n_kf < self.cfg.map.max_keyframes:
            n_new = self._create_keyframe(frame, stamp, pt_idx, pt_in, ln_idx, ln_in)
            self.last_kf_inliers = n_inliers + int(n_new)
            self.frames_since_kf = 0
        elif self._deferred_ba:
            # amortized post-loop GBA: one bounded chunk on a non-KF frame
            self.run_deferred_ba()

        self._record(stamp)
        info = {
            "state": self.state,
            "n_inliers": n_inliers,
            "n_kf": self.n_kf,
            "n_points": int(self.pstore.valid.sum()),
            "n_lines": int(self.lstore.valid.sum()),
            "new_landmarks": int(n_new),
        }
        self.stats.append(info)
        return info

    def _initialize(self, frame: FrameData, stamp: float) -> dict:
        n_stereo = int((frame.stereo_ok & frame.feats.valid).sum())
        if n_stereo < self.cfg.tracking.min_init_features:
            return {"state": self.state, "n_inliers": 0, "n_kf": 0, "n_points": 0, "n_lines": 0, "new_landmarks": 0}
        neg = jnp.full(frame.feats.uv.shape[0], -1, jnp.int32)
        negl = jnp.full(frame.lines.angle.shape[0], -1, jnp.int32)
        f_mask = jnp.zeros(frame.feats.uv.shape[0], bool)
        l_mask = jnp.zeros(frame.lines.angle.shape[0], bool)
        self.pstore, self.lstore, self.kstore, n_new = self._insert(
            frame, self.R, self.t, stamp, neg, f_mask, negl, l_mask, self.n_kf,
            self.pstore, self.lstore, self.kstore,
        )
        self.n_kf = 1
        self.state = TrackingState.OK
        self.last_kf_inliers = n_stereo
        self.frames_since_kf = 0
        self._refresh_local_map(0)
        # the per-KF preintegration accumulator must start AT KF0: IMU
        # batches ingested before initialization (including frame 0's
        # pre-t0 samples) would otherwise leak into the KF0->KF1 chain
        # factor, making its dt exceed the pose gap
        self._preint_since_kf = None
        # NOTE: KF0's view is deliberately NOT seeded into the
        # triangulation ring — far landmarks triangulated against KF0
        # before windowed BA stabilizes the early poses measurably
        # degrade accuracy (ablated: ATE 0.376 vs 0.246 on the
        # far-geometry scene); the ring fills from KF1 onward.
        self._record(stamp)
        info = {"state": self.state, "n_inliers": n_stereo, "n_kf": 1,
                "n_points": int(self.pstore.valid.sum()), "n_lines": int(self.lstore.valid.sum()),
                "new_landmarks": int(n_new)}
        self.stats.append(info)
        return info

    def _initialize_mono(self, frame: FrameData, stamp: float) -> dict:
        """Two-view monocular bootstrapping (reference
        MonocularInitialization, src/Tracking.cc:2079-2282): hold the
        first well-featured frame, reconstruct against the next frame
        that yields enough inliers, spawn KF0+KF1 and the initial map."""
        def _info(n_inl=0, n_new=0):
            info = {
                "state": self.state, "n_inliers": int(n_inl), "n_kf": self.n_kf,
                "n_points": int(self.pstore.valid.sum()),
                "n_lines": int(self.lstore.valid.sum()), "new_landmarks": int(n_new),
            }
            self.stats.append(info)
            return info

        n_feat = int(frame.feats.valid.sum())
        if self._mono_init_frame is None:
            if n_feat >= self.cfg.tracking.min_init_features:
                self._mono_init_frame = (frame, stamp)
            self._record(stamp)
            return _info()
        prev, prev_stamp = self._mono_init_frame
        okf, R, t, depth1, n_inl = self._mono_reconstruct(
            prev, frame, jax.random.PRNGKey(len(self.trajectory) + 1)
        )
        if not bool(okf):
            # re-anchor on the current frame (the reference resets the
            # initializer when reconstruction fails, Tracking.cc:2127)
            if n_feat >= self.cfg.tracking.min_init_features:
                self._mono_init_frame = (frame, stamp)
            self._record(stamp)
            return _info(n_inl)

        # KF0 = the anchor frame at the origin, landmarks from the
        # median-depth-normalized triangulation
        prev_d = dataclasses.replace(prev, depth=depth1)
        neg = jnp.full(prev.feats.uv.shape[0], -1, jnp.int32)
        negl = jnp.full(prev.lines.angle.shape[0], -1, jnp.int32)
        f_mask = jnp.zeros(prev.feats.uv.shape[0], bool)
        l_mask = jnp.zeros(prev.lines.angle.shape[0], bool)
        self.pstore, self.lstore, self.kstore, n_new0 = self._insert(
            prev_d, jnp.eye(3), jnp.zeros(3), prev_stamp, neg, f_mask, negl, l_mask, 0,
            self.pstore, self.lstore, self.kstore,
        )
        self.n_kf = 1
        self._kf_views = [(prev.feats.uv, prev.feats.desc, prev.feats.valid, 0)]
        self._mono_init_frame = None
        self.state = TrackingState.OK
        # accumulator starts at KF0 (see _initialize): pre-init IMU
        # batches must not leak into the KF0->KF1 chain factor
        self._preint_since_kf = None

        # the current frame tracks the fresh map from the reconstructed
        # pose and becomes KF1
        (R2, t2, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore) = self._track(
            frame, R, t, self.pstore, self.lstore, jnp.asarray(False)
        )
        self.R_prev, self.t_prev = jnp.eye(3), jnp.zeros(3)
        self.R, self.t = R2, t2
        self._update_motion_model()
        n_new = self._create_keyframe(frame, stamp, pt_idx, pt_in, ln_idx, ln_in)
        self.last_kf_inliers = int(n_in) + n_new
        self.frames_since_kf = 0
        self._record(stamp)
        return _info(n_in, n_new0 + n_new)

    def _create_keyframe(self, frame, stamp, pt_idx, pt_in, ln_idx, ln_in) -> int:
        if self.is_mono and self._kf_views:
            # mono has no depth channel: triangulate new landmarks against
            # an OLDER keyframe's view (3 back) — consecutive keyframes
            # carry ~0.5 deg of parallax at room depths, which the
            # reference's own cosParallaxRays < 0.9998 gate rejects
            # (LocalMapping.cc:489); the reference gets its baseline from
            # searching up to 20 covisible keyframes. The keyframe pose is
            # read LIVE from the store — a by-value snapshot goes stale as
            # soon as windowed BA refines it.
            uvk, desck, validk, slotk = self._kf_views[0]
            Rk = self.kstore.R[slotk]
            tk = self.kstore.t[slotk]
            depth = self._mono_depths(frame, self.R, self.t, uvk, desck, validk, Rk, tk)
            frame = dataclasses.replace(frame, depth=depth)
        self.pstore, self.lstore, self.kstore, n_new = self._insert(
            frame, self.R, self.t, stamp, pt_idx, pt_in, ln_idx, ln_in, self.n_kf,
            self.pstore, self.lstore, self.kstore,
        )
        if self.use_imu:
            k = self.n_kf
            self.kstore = dataclasses.replace(
                self.kstore,
                v_w=self.kstore.v_w.at[k].set(self.v_w),
                bg=self.kstore.bg.at[k].set(self.bg),
                ba=self.kstore.ba.at[k].set(self.ba),
            )
            # snapshot the chain factor KF(k-1) -> KF(k) and reset the
            # accumulator (reference Tracking.cc:3599-3602)
            if k > 0 and self._preint_since_kf is not None:
                self._pints = self._pints.set(k, self._preint_since_kf)
            self._preint_since_kf = None
        self.n_kf += 1
        # windowed BA over the last W keyframes (first two fixed for gauge)
        W = self.cfg.opt.local_ba_window
        lo = max(self.n_kf - W, 0)
        window = np.arange(lo, lo + W)
        window = np.clip(window, 0, max(self.n_kf - 1, 0))
        n_fixed = max(self.cfg.opt.local_ba_fixed, W - (self.n_kf - lo))
        fixed = np.zeros(W, bool)
        fixed[: max(1, n_fixed)] = True
        # also fix duplicated padding entries
        for i in range(1, W):
            if window[i] <= window[i - 1]:
                fixed[i] = True
        if self.n_kf >= 3:
            inertial_ba = self.use_imu and self.imu_ready and self.gravity_w is not None
            if inertial_ba:
                stacked, imu_mask = self._kf_chain(window)
                self.kstore, self.pstore, self.lstore = self._vi_ba(
                    self.kstore, self.pstore, self.lstore,
                    jnp.asarray(window, jnp.int32), jnp.asarray(fixed),
                    stacked, jnp.asarray(imu_mask), self.gravity_w, self.ext,
                )
                k = self.n_kf - 1
                self.v_w = self.kstore.v_w[k]
                self.bg = self.kstore.bg[k]
                self.ba = self.kstore.ba[k]
            else:
                self.kstore, self.pstore, self.lstore = self._ba(
                    self.kstore, self.pstore, self.lstore,
                    jnp.asarray(window, jnp.int32), jnp.asarray(fixed),
                )
            # tracking pose continues from the refined latest KF
            k = self.n_kf - 1
            self.R = self.kstore.R[k]
            self.t = self.kstore.t[k]
        self._kf_views.append(
            (frame.feats.uv, frame.feats.desc, frame.feats.valid, self.n_kf - 1)
        )
        if len(self._kf_views) > 3:
            self._kf_views.pop(0)
        # BoW index + loop candidate (host-orchestrated sensors share the
        # same database the fused step maintains)
        self.bow_db, slots_, scores_ = self._bow_kf(
            self.bow_db, self.kstore, frame.feats.desc, frame.feats.valid,
            frame.lines.desc, frame.lines.valid, self.n_kf - 1, self.n_kf,
        )
        if self.loop_closer is not None:
            cands = [
                (int(s_), float(sc_))
                for s_, sc_ in zip(np.asarray(slots_), np.asarray(scores_))
            ]
            self.loop_closer.on_keyframe(self, self.n_kf - 1, cands)
        self._try_merge(self.n_kf - 1)
        self._cull_keyframes()
        self._refresh_local_map(self.n_kf - 1)
        return int(n_new)

    def _refresh_local_map(self, kf_slot: int):
        """Recompute the local tracking map around `kf_slot` (host-side
        analog of the fused step's in-branch refresh; used by the
        host-orchestrated paths and after reloc / merge / load)."""
        if kf_slot < 0:
            self._local_pt = _empty_local_map(self.cfg)
            return
        self._local_pt = self._local_ids_j(
            self.kstore, self.pstore, jnp.asarray(kf_slot, jnp.int32)
        )

    def rebuild_bow(self):
        """Recompute the BoW database from the landmark stores (used after
        checkpoint load — reference Map::PostLoad rebuilds the
        KeyFrameDatabase inverted files, src/Map.cc:967)."""
        ks, ps, ls = self.kstore, self.pstore, self.lstore
        voc_pt, voc_ln = self.voc_pt, self.voc_ln
        K = ks.valid.shape[0]

        @jax.jit
        def rebuild(ks, ps, ls):
            def one(k):
                ids = ks.obs_pt[k]
                m = (ids >= 0) & ps.valid[jnp.maximum(ids, 0)]
                bow_p = voc_pt.bow(ps.desc[jnp.maximum(ids, 0)], m)
                lids = ks.obs_ln[k]
                lm = (lids >= 0) & ls.valid[jnp.maximum(lids, 0)]
                bow_l = voc_ln.bow(ls.desc[jnp.maximum(lids, 0)], lm)
                return bow_p, bow_l

            bow_p, bow_l = jax.vmap(one)(jnp.arange(K))
            from pli_slam_tpu.worldmap import vocab as vocab_mod

            return vocab_mod.BowDatabase(
                hist_pt=jnp.where(ks.valid[:, None], bow_p, 0.0),
                hist_ln=jnp.where(ks.valid[:, None], bow_l, 0.0),
                valid=ks.valid,
            )

        self.bow_db = rebuild(ks, ps, ls)
        if self.n_kf > 0:
            self._refresh_local_map(self.n_kf - 1)

    def _record(self, stamp: float):
        # relative pose vs the newest keyframe: T_cr = T_cw ∘ T_rw^-1.
        # self.n_kf may be a device scalar (streaming mode) — everything
        # stays lazy, no host sync. The absolute pose rides along as the
        # fallback for frames recorded before any keyframe existed.
        ref = jnp.maximum(jnp.asarray(self.n_kf, jnp.int32) - 1, 0)
        R_r = self.kstore.R[ref]
        t_r = self.kstore.t[ref]
        R_cr = lie._mm(self.R, jnp.swapaxes(R_r, -1, -2))
        t_cr = self.t - lie._einsum("ij,j->i", R_cr, t_r)
        self._traj_pending.append((stamp, ref, R_cr, t_cr, self.R, self.t))

    def positions(self) -> np.ndarray:
        return np.stack([p for _, _, p in self.trajectory])
