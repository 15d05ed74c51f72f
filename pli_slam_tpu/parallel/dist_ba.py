"""Distributed Schur-complement bundle adjustment over a device mesh.

The reference has no distributed computing at all (SURVEY.md §2.3); its
LocalBundleAdjustment is a single-threaded g2o solve over a shared-memory
heap. Here the BA problem is partitioned the dense-array way:

- LANDMARKS (and their observations) are sharded across the mesh axis —
  the huge, embarrassingly-parallel side of the problem;
- POSES are replicated (the pose window is tiny: W <= ~16);
- each device assembles its shard's contribution to the reduced camera
  system S = Hpp - Hpl Hll^-1 Hlp, which is `psum`-reduced over ICI;
- the dense [6W, 6W] solve is computed redundantly on every device
  (cheaper than a broadcast), and landmark back-substitution is local.

This is the distributed analog of the reference's `Marginalize`
(src/Optimizer.cc:5125) and scales to pod slices by letting the psum
ride ICI within a slice and DCN across hosts, per the north star.

The per-shard math is exactly solve/ba.py with `axis_name` set, so the
single-chip and distributed paths cannot drift apart.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pli_slam_tpu.solve import ba as ba_mod
from pli_slam_tpu.utils.config import OptimizerConfig

AXIS = "shard"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (AXIS,))


def partition_observations(
    prob: ba_mod.BAProblem, n_shards: int, compact: bool = True
) -> ba_mod.BAProblem:
    """Re-index a pose-major problem into `n_shards` landmark shards.

    Landmarks are split into contiguous blocks; each observation row is
    kept pose-major inside its shard (the solve/ba.py layout invariant
    holds per shard because a landmark lives in exactly one shard and
    per-pose slot ids were unique globally). Observation slots whose
    landmark belongs to another shard are masked out locally — across
    all shards every observation is counted exactly once.

    With `compact` (default), each shard's observation arrays are
    GATHERED down to (a small pad over) the rows it owns instead of
    carrying the full masked-out global arrays: per-shard linearization
    work then scales ~1/n_shards, which is what makes the distributed
    solve load-balanced at production shapes (16k landmarks / 100k
    observations) rather than merely correct. The gather is done PER
    (shard, pose) with padding to a common per-pose count, preserving
    the equal-count pose-major block layout assemble_visual's
    reshape-sum accumulation requires (solve/ba.py:273).
    """
    P_total = prob.pts.shape[0]
    L_total = prob.lns.shape[0]
    assert P_total % n_shards == 0 and L_total % n_shards == 0
    p_blk = P_total // n_shards
    l_blk = L_total // n_shards

    # INTERLEAVED landmark ownership (shard s owns ids s, s+n, s+2n, ...):
    # real maps allocate landmark slots roughly in creation order, so a
    # pose's observations cluster in a contiguous id range — contiguous
    # blocks would put ALL of a pose's work on one shard and the
    # per-(shard, pose) compaction below couldn't shrink anything.
    # Striding decorrelates ownership from pose, so every pose's
    # observations spread ~evenly across the mesh. Global id of shard
    # s's local row j is j * n_shards + s.
    def shard_obs(idx):
        owner = jnp.where(idx >= 0, idx % n_shards, -1)
        local = jnp.where(idx >= 0, idx // n_shards, -1)
        return owner, local

    own_p, loc_p = shard_obs(prob.po_pt)
    own_l, loc_l = shard_obs(prob.lo_ln)

    if compact:
        W = prob.R.shape[0]

        def plan(own_np, pose_np, mask_np):
            """Per-(shard, pose) row lists padded to a common count."""
            live = mask_np & (own_np >= 0)
            rows = [
                [np.nonzero(live & (own_np == s) & (pose_np == w))[0] for w in range(W)]
                for s in range(n_shards)
            ]
            cap = max(max((len(r) for sr in rows for r in sr), default=1), 1)
            plans = []
            for s in range(n_shards):
                idx = np.zeros((W, cap), np.int64)
                keep = np.zeros((W, cap), bool)
                for w in range(W):
                    r = rows[s][w]
                    idx[w, : len(r)] = r
                    keep[w, : len(r)] = True
                pose = np.repeat(np.arange(W, dtype=np.int32)[:, None], cap, axis=1)
                plans.append((jnp.asarray(idx.reshape(-1)),
                              jnp.asarray(keep.reshape(-1)),
                              jnp.asarray(pose.reshape(-1))))
            return plans

        plans_p = plan(np.asarray(own_p), np.asarray(prob.po_pose),
                       np.asarray(prob.po_mask))
        plans_l = plan(np.asarray(own_l), np.asarray(prob.lo_pose),
                       np.asarray(prob.lo_mask))

    reps = []
    for s in range(n_shards):
        rep = dataclasses.replace(
            prob,
            pts=prob.pts[s::n_shards],
            pt_mask=prob.pt_mask[s::n_shards],
            lns=prob.lns[s::n_shards],
            ln_mask=prob.ln_mask[s::n_shards],
            po_pt=jnp.where(own_p == s, loc_p, -1),
            po_mask=prob.po_mask & (own_p == s),
            lo_ln=jnp.where(own_l == s, loc_l, -1),
            lo_mask=prob.lo_mask & (own_l == s),
        )
        if compact:
            pr, pk, pp = plans_p[s]
            lr, lk, lp = plans_l[s]
            rep = dataclasses.replace(
                rep,
                po_pose=pp, po_pt=jnp.where(pk, rep.po_pt[pr], -1),
                po_uvr=rep.po_uvr[pr], po_stereo=rep.po_stereo[pr],
                po_sigma2=rep.po_sigma2[pr], po_mask=rep.po_mask[pr] & pk,
                lo_pose=lp, lo_ln=jnp.where(lk, rep.lo_ln[lr], -1),
                lo_l=rep.lo_l[lr], lo_sigma2=rep.lo_sigma2[lr],
                lo_mask=rep.lo_mask[lr] & lk,
            )
        reps.append(rep)
    # stack shard-locals along the leading (sharded) axis
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *reps)


def solve_ba_distributed(
    cam, prob_stacked: ba_mod.BAProblem, cfg: OptimizerConfig, mesh: Mesh, iters: int | None = None
) -> ba_mod.BAResult:
    """Run distributed BA. `prob_stacked` is the output of
    `partition_observations` — every array has a leading shard axis.

    Returns a BAResult whose landmark arrays keep the shard axis
    (concatenate on the host to recover the global stores) and whose
    pose arrays are replicated (identical on all shards).
    """
    from jax import shard_map

    spec_sharded = ba_mod.BAProblem(
        R=P(), t=P(), pose_mask=P(), fixed_mask=P(),
        pts=P(AXIS), pt_mask=P(AXIS), lns=P(AXIS), ln_mask=P(AXIS),
        po_pose=P(AXIS), po_pt=P(AXIS), po_uvr=P(AXIS), po_stereo=P(AXIS),
        po_sigma2=P(AXIS), po_mask=P(AXIS),
        lo_pose=P(AXIS), lo_ln=P(AXIS), lo_l=P(AXIS), lo_sigma2=P(AXIS), lo_mask=P(AXIS),
    )
    out_spec = ba_mod.BAResult(
        R=P(), t=P(), pts=P(AXIS), lns=P(AXIS), po_chi2=P(AXIS), lo_chi2=P(AXIS), cost=P()
    )

    # poses are replicated: drop the leading shard axis from pose fields
    prob_in = dataclasses.replace(
        prob_stacked,
        R=prob_stacked.R[0], t=prob_stacked.t[0],
        pose_mask=prob_stacked.pose_mask[0], fixed_mask=prob_stacked.fixed_mask[0],
    )

    _POSE_FIELDS = {"R", "t", "pose_mask", "fixed_mask"}

    def body(prob_local: ba_mod.BAProblem) -> ba_mod.BAResult:
        # shard_map passes each sharded field with a leading axis of size 1
        kw = {
            f.name: getattr(prob_local, f.name)
            if f.name in _POSE_FIELDS
            else getattr(prob_local, f.name)[0]
            for f in dataclasses.fields(ba_mod.BAProblem)
        }
        res = ba_mod.solve_ba(cam, ba_mod.BAProblem(**kw), cfg, iters=iters, axis_name=AXIS)
        return ba_mod.BAResult(
            R=res.R, t=res.t,
            pts=res.pts[None], lns=res.lns[None],
            po_chi2=res.po_chi2[None], lo_chi2=res.lo_chi2[None],
            cost=res.cost,
        )

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(spec_sharded,),
        out_specs=out_spec,
    )
    return jax.jit(fn)(prob_in)


def solve_gba_distributed(
    cam, prob_stacked: ba_mod.BAProblem, cfg: OptimizerConfig, mesh: Mesh,
    iters: int | None = None, wcap: int = 16,
) -> ba_mod.BAResult:
    """Distributed whole-map GBA: the alternating (resection-intersection)
    solver with landmarks sharded across the mesh. The landmark step is
    embarrassingly parallel; the pose step psum-reduces [K,6,6]+[K,6]
    per-pose blocks — the only collective traffic per iteration
    (reference analog: the RunGlobalBundleAdjustment background thread,
    src/LoopClosing.cc:2243, here scaled across chips instead of hidden
    on a second core)."""
    from jax import shard_map

    spec_sharded = ba_mod.BAProblem(
        R=P(), t=P(), pose_mask=P(), fixed_mask=P(),
        pts=P(AXIS), pt_mask=P(AXIS), lns=P(AXIS), ln_mask=P(AXIS),
        po_pose=P(AXIS), po_pt=P(AXIS), po_uvr=P(AXIS), po_stereo=P(AXIS),
        po_sigma2=P(AXIS), po_mask=P(AXIS),
        lo_pose=P(AXIS), lo_ln=P(AXIS), lo_l=P(AXIS), lo_sigma2=P(AXIS), lo_mask=P(AXIS),
    )
    out_spec = ba_mod.BAResult(
        R=P(), t=P(), pts=P(AXIS), lns=P(AXIS), po_chi2=P(AXIS), lo_chi2=P(AXIS), cost=P()
    )
    prob_in = dataclasses.replace(
        prob_stacked,
        R=prob_stacked.R[0], t=prob_stacked.t[0],
        pose_mask=prob_stacked.pose_mask[0], fixed_mask=prob_stacked.fixed_mask[0],
    )
    _POSE_FIELDS = {"R", "t", "pose_mask", "fixed_mask"}

    def body(prob_local: ba_mod.BAProblem) -> ba_mod.BAResult:
        kw = {
            f.name: getattr(prob_local, f.name)
            if f.name in _POSE_FIELDS
            else getattr(prob_local, f.name)[0]
            for f in dataclasses.fields(ba_mod.BAProblem)
        }
        res = ba_mod.solve_ba_alternating(
            cam, ba_mod.BAProblem(**kw), cfg, iters=iters, wcap=wcap, axis_name=AXIS
        )
        return ba_mod.BAResult(
            R=res.R, t=res.t,
            pts=res.pts[None], lns=res.lns[None],
            po_chi2=res.po_chi2[None], lo_chi2=res.lo_chi2[None],
            cost=res.cost,
        )

    fn = shard_map(body, mesh=mesh, in_specs=(spec_sharded,), out_specs=out_spec)
    return jax.jit(fn)(prob_in)
