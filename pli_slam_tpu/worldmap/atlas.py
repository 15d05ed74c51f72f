"""Atlas: multi-map container with new-map-on-loss and map merging.

JAX replacement for `Atlas` (reference: include/Atlas.h:57 —
active map + stored maps, `CreateNewMap` :80) and the merge machinery
(`LoopClosing::MergeLocal/MergeLocal2`, src/LoopClosing.cc:1096/:1761).

A Map is a bundle of the three SoA stores plus its BoW database. On
persistent tracking loss a fresh map becomes active (reference
Tracking::CreateMapInAtlas, src/Tracking.cc:2565); when place
recognition later hits a keyframe of a stored map, the active map is
welded into it: every active pose/landmark is transformed by the
verified SE3/Sim3 and copied into the stored map's free slots with
index remapping done as pure array ops (the reference's pointer surgery
becomes a gather/scatter pass).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.ops import lie
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu.worldmap import stores as st

_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class MapBundle:
    pstore: st.PointStore
    lstore: st.LineStore
    kstore: st.KeyFrameStore
    n_kf: int = 0
    # parked maps keep their BoW database alive so place recognition can
    # re-find them for merging (round-2 verdict: resetting the DB on
    # new-map made Atlas recovery amnesia)
    bow_db: object = None

    @staticmethod
    def empty(cfg: SlamConfig) -> "MapBundle":
        m = cfg.map
        return MapBundle(
            pstore=st.PointStore.empty(m.max_points),
            lstore=st.LineStore.empty(m.max_lines),
            kstore=st.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines),
        )


class Atlas:
    """Host-side multi-map registry (the stores themselves live on device)."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.maps: list[MapBundle] = [MapBundle.empty(cfg)]
        self.active_idx = 0

    @property
    def active(self) -> MapBundle:
        return self.maps[self.active_idx]

    def n_maps(self) -> int:
        return len(self.maps)

    def create_new_map(self) -> MapBundle:
        """New active map on tracking loss (reference CreateMapInAtlas)."""
        self.maps.append(MapBundle.empty(self.cfg))
        self.active_idx = len(self.maps) - 1
        return self.active

    def merge_active_into(self, target_idx: int, R_rel: jax.Array, t_rel: jax.Array,
                          fuse_src=None, fuse_dst=None) -> MapBundle:
        """Weld the active map into maps[target_idx].

        (R_rel, t_rel) maps ACTIVE-map world coordinates into TARGET-map
        world coordinates: x_t = R x_a + t. Poses transform as
        T_cw_t = T_cw_a ∘ T_rel^-1. Active-map landmark/keyframe rows are
        copied into the target's free slots; observation tables are
        re-indexed with gathers. The merged map becomes active; the old
        active map is dropped (reference SetBadFlag on the merged map).
        """
        src = self.active
        dst = self.maps[target_idx]
        dst_merged, kf_slots = merge_maps(dst, src, R_rel, t_rel, fuse_src, fuse_dst)
        # src-KF-slot -> merged-map-slot mapping, for callers that must
        # re-index per-KF side state (the IMU preintegration chain — the
        # reference's MergeInertialBA keeps inertial factors across the
        # seam, src/Optimizer.cc:6858)
        self.last_kf_slots = np.asarray(kf_slots)
        self.maps[target_idx] = dst_merged
        self.maps.pop(self.active_idx)
        self.active_idx = target_idx if target_idx < self.active_idx else target_idx - 1
        return self.active


def merge_maps(dst: MapBundle, src: MapBundle, R_rel, t_rel,
               fuse_src=None, fuse_dst=None) -> MapBundle:
    """Pure function: copy src (transformed) into dst's free slots.

    `fuse_src`/`fuse_dst` ([M] int32, -1 padded) identify src point
    landmarks verified to BE dst landmarks (the Sim3 inlier matches):
    instead of copying, their observations are remapped onto the dst
    landmark — the reference's duplicate fusion in
    LoopClosing::SearchAndFuse / MergeLocal (src/LoopClosing.cc:2097).
    These shared landmarks are what makes a post-merge welding BA
    actually couple the two sides of the seam.
    """
    # --- transform src geometry into dst world ---------------------------
    Rr_inv, tr_inv = lie.se3_inverse(R_rel, t_rel)
    src_pts = lie._einsum("ij,nj->ni", R_rel, src.pstore.x) + t_rel
    src_seg = jnp.concatenate(
        [
            lie._einsum("ij,nj->ni", R_rel, src.lstore.seg[:, :3]) + t_rel,
            lie._einsum("ij,nj->ni", R_rel, src.lstore.seg[:, 3:]) + t_rel,
        ],
        axis=-1,
    )
    # poses: T_cw_dst = T_cw_src ∘ T_rel^-1
    src_R = jnp.einsum("kij,jl->kil", src.kstore.R, Rr_inv, precision=_HI)
    src_t = jnp.einsum("kij,j->ki", src.kstore.R, tr_inv, precision=_HI) + src.kstore.t

    # --- allocate free slots in dst --------------------------------------
    def remap_into(dst_valid, src_valid):
        slots, ok = st.alloc_slots(~dst_valid, src_valid)
        # mapping src row -> dst row (or -1)
        return slots, ok

    # fused src points take the dst landmark's id instead of a fresh slot
    P_cap = src.pstore.x.shape[0]
    fuse_map = jnp.full(P_cap, -1, jnp.int32)
    if fuse_src is not None:
        fs = jnp.asarray(fuse_src, jnp.int32)
        fd = jnp.asarray(fuse_dst, jnp.int32)
        fuse_map = fuse_map.at[jnp.maximum(fs, 0)].set(
            jnp.where(fs >= 0, fd, fuse_map[jnp.maximum(fs, 0)])
        )
    want_pt = src.pstore.valid & (fuse_map < 0)
    pt_slots, pt_ok = remap_into(dst.pstore.valid, want_pt)
    ln_slots, ln_ok = remap_into(dst.lstore.valid, src.lstore.valid)
    kf_slots, kf_ok = remap_into(dst.kstore.valid, src.kstore.valid)
    # full src->dst point map for observation re-indexing
    pt_map = jnp.where(fuse_map >= 0, fuse_map, pt_slots)

    def scatter_rows(dst_arr, src_arr, slots, ok):
        safe = jnp.maximum(slots, 0)
        if dst_arr.ndim == 1:
            return dst_arr.at[safe].set(jnp.where(ok, src_arr, dst_arr[safe]))
        mask = ok.reshape((-1,) + (1,) * (dst_arr.ndim - 1))
        return dst_arr.at[safe].set(jnp.where(mask, src_arr, dst_arr[safe]))

    # --- points -----------------------------------------------------------
    ps = dst.pstore
    ps = dataclasses.replace(
        ps,
        x=scatter_rows(ps.x, src_pts, pt_slots, pt_ok),
        desc=scatter_rows(ps.desc, src.pstore.desc, pt_slots, pt_ok),
        desc_bank=scatter_rows(ps.desc_bank, src.pstore.desc_bank, pt_slots, pt_ok),
        valid=scatter_rows(ps.valid, src.pstore.valid, pt_slots, pt_ok),
        n_obs=scatter_rows(ps.n_obs, src.pstore.n_obs, pt_slots, pt_ok),
        visible=scatter_rows(ps.visible, src.pstore.visible, pt_slots, pt_ok),
        found=scatter_rows(ps.found, src.pstore.found, pt_slots, pt_ok),
    )
    ls = dst.lstore
    ls = dataclasses.replace(
        ls,
        seg=scatter_rows(ls.seg, src_seg, ln_slots, ln_ok),
        desc=scatter_rows(ls.desc, src.lstore.desc, ln_slots, ln_ok),
        valid=scatter_rows(ls.valid, src.lstore.valid, ln_slots, ln_ok),
        n_obs=scatter_rows(ls.n_obs, src.lstore.n_obs, ln_slots, ln_ok),
    )
    ln_first = jnp.maximum(kf_slots[jnp.clip(src.lstore.first_kf, 0, kf_slots.shape[0] - 1)], 0)
    ln_last = jnp.maximum(kf_slots[jnp.clip(src.lstore.last_kf, 0, kf_slots.shape[0] - 1)], 0)
    ls = dataclasses.replace(
        ls,
        first_kf=scatter_rows(ls.first_kf, ln_first, ln_slots, ln_ok),
        last_kf=scatter_rows(ls.last_kf, ln_last, ln_slots, ln_ok),
    )

    # --- keyframes with re-indexed observation tables ---------------------
    # src obs_pt holds src-point ids; map through pt_slots (gather), -1 safe
    def remap_obs(obs_src, lm_slots):
        safe = jnp.maximum(obs_src, 0)
        mapped = lm_slots[safe]
        return jnp.where(obs_src >= 0, mapped, -1)

    obs_pt_new = remap_obs(src.kstore.obs_pt, pt_map)
    obs_ln_new = remap_obs(src.kstore.obs_ln, ln_slots)
    # also remap landmark->kf anchors
    ps = dataclasses.replace(
        ps,
        first_kf=scatter_rows(ps.first_kf, jnp.maximum(kf_slots[jnp.clip(src.pstore.first_kf, 0, kf_slots.shape[0] - 1)], 0), pt_slots, pt_ok),
        last_kf=scatter_rows(ps.last_kf, jnp.maximum(kf_slots[jnp.clip(src.pstore.last_kf, 0, kf_slots.shape[0] - 1)], 0), pt_slots, pt_ok),
    )
    ks = dst.kstore
    ks = dataclasses.replace(
        ks,
        R=scatter_rows(ks.R, src_R, kf_slots, kf_ok),
        t=scatter_rows(ks.t, src_t, kf_slots, kf_ok),
        v_w=scatter_rows(ks.v_w, lie._einsum("ij,kj->ki", R_rel, src.kstore.v_w), kf_slots, kf_ok),
        bg=scatter_rows(ks.bg, src.kstore.bg, kf_slots, kf_ok),
        ba=scatter_rows(ks.ba, src.kstore.ba, kf_slots, kf_ok),
        stamp=scatter_rows(ks.stamp, src.kstore.stamp, kf_slots, kf_ok),
        valid=scatter_rows(ks.valid, src.kstore.valid, kf_slots, kf_ok),
        obs_pt=scatter_rows(ks.obs_pt, obs_pt_new, kf_slots, kf_ok),
        obs_uvr=scatter_rows(ks.obs_uvr, src.kstore.obs_uvr, kf_slots, kf_ok),
        obs_sigma2=scatter_rows(ks.obs_sigma2, src.kstore.obs_sigma2, kf_slots, kf_ok),
        obs_stereo=scatter_rows(ks.obs_stereo, src.kstore.obs_stereo, kf_slots, kf_ok),
        obs_ln=scatter_rows(ks.obs_ln, obs_ln_new, kf_slots, kf_ok),
        obs_l=scatter_rows(ks.obs_l, src.kstore.obs_l, kf_slots, kf_ok),
        obs_ln_sigma2=scatter_rows(ks.obs_ln_sigma2, src.kstore.obs_ln_sigma2, kf_slots, kf_ok),
    )
    # --- covisibility graph + landmark->KF incidence bitsets --------------
    # permutation P[j, i] = 1 where src KF i landed in dst slot j; the src
    # covis block and the per-landmark KF bitsets transport through it as
    # matmuls (no scatters)
    K = ks.covis.shape[0]
    safe_kf = jnp.maximum(kf_slots, 0)
    P = (
        jnp.zeros((K, K), jnp.int32)
        .at[safe_kf, jnp.arange(K)]
        .add(kf_ok.astype(jnp.int32))
    )
    covis_src = jnp.einsum("ji,ik->jk", P, src.kstore.covis, precision=_HI)
    covis_src = jnp.einsum("jk,lk->jl", covis_src, P, precision=_HI)
    ks = dataclasses.replace(ks, covis=ks.covis + covis_src)
    shifts = jnp.arange(32, dtype=jnp.uint32)

    def transport_bits(obs_bits_src):
        """Permute a [*, ceil(K/32)] KF-incidence bitset through P."""
        KW = obs_bits_src.shape[1]
        bits = ((obs_bits_src[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1))
        bits = bits.reshape(obs_bits_src.shape[0], -1)[:, :K].astype(jnp.int32)
        new_bits = jnp.einsum("pi,ji->pj", bits, P, precision=_HI)  # [*, K]
        padded = jnp.pad(new_bits, ((0, 0), (0, KW * 32 - K))).reshape(-1, KW, 32)
        return jnp.sum(
            padded.astype(jnp.uint32) << shifts[None, None, :], axis=-1, dtype=jnp.uint32
        )

    repacked = transport_bits(src.pstore.obs_bits)
    ps = dataclasses.replace(
        ps, obs_bits=scatter_rows(ps.obs_bits, repacked, pt_slots, pt_ok)
    )
    ls = dataclasses.replace(
        ls, obs_bits=scatter_rows(ls.obs_bits, transport_bits(src.lstore.obs_bits), ln_slots, ln_ok)
    )
    if fuse_src is not None:
        # fused landmarks: accumulate the src observations onto the dst row
        fs_safe = jnp.maximum(fs, 0)
        fd_safe = jnp.maximum(fd, 0)
        fok = (fs >= 0) & (fd >= 0)
        ps = dataclasses.replace(
            ps,
            n_obs=ps.n_obs.at[fd_safe].add(
                jnp.where(fok, src.pstore.n_obs[fs_safe], 0)
            ),
            obs_bits=ps.obs_bits.at[fd_safe].set(
                jnp.where(
                    fok[:, None],
                    ps.obs_bits[fd_safe] | repacked[fs_safe],
                    ps.obs_bits[fd_safe],
                )
            ),
        )
    # next-free-slot semantics: the tracker inserts keyframes at slot
    # n_kf, so it must point past the highest occupied slot
    n_next = int(jnp.max(jnp.where(ks.valid, jnp.arange(K), -1))) + 1
    return (
        MapBundle(pstore=ps, lstore=ls, kstore=ks, n_kf=max(dst.n_kf, n_next)),
        kf_slots,
    )
