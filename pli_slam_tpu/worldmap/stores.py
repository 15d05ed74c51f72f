"""Struct-of-arrays map stores: keyframes, point and line landmarks.

JAX replacement for the reference's pointer-graph map data model
(reference: src/MapPoint.cc, src/MapLine.cc, src/KeyFrame.cc,
src/Map.cc, include/Atlas.h). Instead of heap objects with observation
dictionaries and per-object mutexes, the map is a set of fixed-capacity
parallel arrays living on device:

- `PointStore` / `LineStore`: landmark state + bookkeeping counters
  (visible/found ratios for culling, reference MapPoint::IncreaseFound);
- `KeyFrameStore`: poses, IMU states, and per-keyframe observation
  tables — `obs_pt[k, s]` is the landmark id observed by feature slot
  `s` of keyframe `k` (-1 = none), together with the measurement. This
  is the dense analog of the reference's MapPoint::mObservations /
  KeyFrame::mvpMapPoints double bookkeeping, and is exactly the layout
  local BA consumes (solve/ba.py) without any graph traversal.

Allocation is slot-based: `alloc_slots` finds free rows with a cumsum
prefix over the free mask (no host roundtrip). All mutation functions
are pure (return a new store) and jit-safe.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.utils.config import MapConfig


DESC_BANK = 4  # stored descriptor views per point landmark


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointStore:
    x: jax.Array  # [P,3] world position
    desc: jax.Array  # [P,256] int8 ±1 distinctive descriptor (bank medoid)
    valid: jax.Array  # [P] bool
    n_obs: jax.Array  # [P] int32
    visible: jax.Array  # [P] int32 — times projected in frustum
    found: jax.Array  # [P] int32 — times matched (reference found ratio)
    first_kf: jax.Array  # [P] int32
    last_kf: jax.Array  # [P] int32 — last KF that observed it
    obs_bits: jax.Array  # [P, ceil(K/32)] uint32 — which KFs observe it
    # (the inverted incidence behind the covisibility graph; the dense
    # analog of MapPoint::mObservations keys, reference src/MapPoint.cc)
    desc_bank: jax.Array  # [P, DESC_BANK, 256] int8 — recent observed
    # descriptor views (ring by n_obs); `desc` is maintained as the
    # bank's min-sum-Hamming medoid, the incremental analog of the
    # reference's ComputeDistinctiveDescriptors over all observations
    # (src/MapPoint.cc:300) without the O(obs^2) rebuild

    @staticmethod
    def empty(capacity: int, kf_capacity: int = 512) -> "PointStore":
        return PointStore(
            x=jnp.zeros((capacity, 3)),
            desc=jnp.zeros((capacity, 256), jnp.int8),
            valid=jnp.zeros(capacity, bool),
            n_obs=jnp.zeros(capacity, jnp.int32),
            visible=jnp.ones(capacity, jnp.int32),
            found=jnp.ones(capacity, jnp.int32),
            first_kf=jnp.zeros(capacity, jnp.int32),
            last_kf=jnp.zeros(capacity, jnp.int32),
            obs_bits=jnp.zeros((capacity, (kf_capacity + 31) // 32), jnp.uint32),
            desc_bank=jnp.zeros((capacity, DESC_BANK, 256), jnp.int8),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LineStore:
    seg: jax.Array  # [L,6] world endpoints (xs, xe)
    desc: jax.Array  # [L,256] int8
    valid: jax.Array  # [L] bool
    n_obs: jax.Array  # [L] int32
    visible: jax.Array  # [L] int32
    found: jax.Array  # [L] int32
    first_kf: jax.Array  # [L] int32
    last_kf: jax.Array  # [L] int32
    # which KFs observe each line — feeds covisibility weights alongside
    # the point incidence (the reference DECLARES this counter but has it
    # commented out, src/KeyFrame.cc:573-590; SURVEY's stance is to fix
    # reference bugs, so line-rich/point-poor scenes pick the right
    # BA window and essential-graph edges here)
    obs_bits: jax.Array  # [L, ceil(K/32)] uint32

    @staticmethod
    def empty(capacity: int, kf_capacity: int = 512) -> "LineStore":
        return LineStore(
            seg=jnp.zeros((capacity, 6)),
            desc=jnp.zeros((capacity, 256), jnp.int8),
            valid=jnp.zeros(capacity, bool),
            n_obs=jnp.zeros(capacity, jnp.int32),
            visible=jnp.ones(capacity, jnp.int32),
            found=jnp.ones(capacity, jnp.int32),
            first_kf=jnp.zeros(capacity, jnp.int32),
            last_kf=jnp.zeros(capacity, jnp.int32),
            obs_bits=jnp.zeros((capacity, (kf_capacity + 31) // 32), jnp.uint32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KeyFrameStore:
    """Keyframe poses + dense observation tables.

    Poses are T_cw. Observation tables are per-feature-slot: slot s of
    KF k stores the measurement taken by that ORB/line feature and the
    landmark id it was associated with.
    """

    R: jax.Array  # [K,3,3] T_cw rotation
    t: jax.Array  # [K,3]
    v_w: jax.Array  # [K,3] body velocity (inertial)
    bg: jax.Array  # [K,3] gyro bias
    ba: jax.Array  # [K,3] accel bias
    stamp: jax.Array  # [K] float32 seconds
    valid: jax.Array  # [K] bool
    # point observations
    obs_pt: jax.Array  # [K,S] int32 landmark id or -1
    obs_uvr: jax.Array  # [K,S,3] (u, v, u_r)
    obs_sigma2: jax.Array  # [K,S]
    obs_stereo: jax.Array  # [K,S] bool
    # line observations
    obs_ln: jax.Array  # [K,Sl] int32 landmark id or -1
    obs_l: jax.Array  # [K,Sl,3] normalized image line
    obs_ln_sigma2: jax.Array  # [K,Sl]
    # covisibility graph: covis[i, j] = number of point landmarks KFs i
    # and j share (reference KeyFrame::UpdateConnections,
    # src/KeyFrame.cc:539 — point observations only, like the reference)
    covis: jax.Array  # [K,K] int32

    @staticmethod
    def empty(capacity: int, slots_pt: int, slots_ln: int) -> "KeyFrameStore":
        return KeyFrameStore(
            R=jnp.tile(jnp.eye(3)[None], (capacity, 1, 1)),
            t=jnp.zeros((capacity, 3)),
            v_w=jnp.zeros((capacity, 3)),
            bg=jnp.zeros((capacity, 3)),
            ba=jnp.zeros((capacity, 3)),
            stamp=jnp.zeros(capacity),
            valid=jnp.zeros(capacity, bool),
            obs_pt=jnp.full((capacity, slots_pt), -1, jnp.int32),
            obs_uvr=jnp.zeros((capacity, slots_pt, 3)),
            obs_sigma2=jnp.ones((capacity, slots_pt)),
            obs_stereo=jnp.zeros((capacity, slots_pt), bool),
            obs_ln=jnp.full((capacity, slots_ln), -1, jnp.int32),
            obs_l=jnp.zeros((capacity, slots_ln, 3)),
            obs_ln_sigma2=jnp.ones((capacity, slots_ln)),
            covis=jnp.zeros((capacity, capacity), jnp.int32),
        )


def alloc_slots(free_mask: jax.Array, want_mask: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Assign free store rows to requested items, without host roundtrips.

    free_mask: [C] bool — store rows available.
    want_mask: [N] bool — items that need a slot.
    Returns (slot_idx [N] int32 with -1 where unassigned, ok [N] bool).
    Items are packed in order; runs out gracefully when free rows < wants.
    """
    free_idx = jnp.where(free_mask, jnp.arange(free_mask.shape[0], dtype=jnp.int32), jnp.int32(free_mask.shape[0]))
    free_sorted = jnp.sort(free_idx)  # free row ids first, capacity-sentinels last
    rank = jnp.cumsum(want_mask.astype(jnp.int32)) - 1  # allocation order per item
    rank = jnp.clip(rank, 0, free_mask.shape[0] - 1)
    slot = free_sorted[rank]
    ok = want_mask & (slot < free_mask.shape[0]) & (rank < jnp.sum(free_mask.astype(jnp.int32)))
    return jnp.where(ok, slot, -1).astype(jnp.int32), ok
