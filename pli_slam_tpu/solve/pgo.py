"""Pose-graph optimization (Sim3 / SE3), dense and batched.

JAX replacement for the reference's essential-graph optimizers
(reference: src/Optimizer.cc — `OptimizeEssentialGraph` 7-DoF :2437,
`OptimizeEssentialGraph6DoF` :2755, `OptimizeEssentialGraph4DoF`
:8247) built on g2o's sparse Sim3 machinery
(Thirdparty/g2o/g2o/types/types_seven_dof_expmap.cpp).

Design inversion: the reference assembles a sparse Hessian and runs a
sparse Cholesky; at SLAM scales (K <= ~1000 keyframes, 7K <= 7000
unknowns) a DENSE [7K, 7K] system is a few hundred MB-FLOPs — cheap
on a matrix unit and far friendlier than sparse triangular solves. Edge
residuals r = log(S_meas^-1 S_j S_i^-1) and their Jacobians come from
`jax.jacfwd` vmapped over edges (each edge is a tiny 7->7 map).

Poses are world->camera Sim3 (R, t, s); SE3 mode pins s = 1 by masking
the scale column.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import lie

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Padded pose graph. Edges reference node slots."""

    R: jax.Array  # [K,3,3] S_cw rotation
    t: jax.Array  # [K,3]
    s: jax.Array  # [K] scale
    node_mask: jax.Array  # [K] bool
    fixed_mask: jax.Array  # [K] bool
    e_i: jax.Array  # [E] int32 source node
    e_j: jax.Array  # [E] int32 target node
    e_R: jax.Array  # [E,3,3] measured S_ji = S_j S_i^-1
    e_t: jax.Array  # [E,3]
    e_s: jax.Array  # [E]
    e_weight: jax.Array  # [E] (loop edges can be up-weighted)
    e_mask: jax.Array  # [E] bool


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log( S_m^-1 ∘ S_j ∘ S_i^-1 ) in R^7 (rho, phi, sigma)."""
    # S_j ∘ S_i^-1
    Rii, tii, sii = lie.sim3_inverse(Ri, ti, si)
    Rji, tji, sji = lie.sim3_compose(Rj, tj, sj, Rii, tii, sii)
    Rmi, tmi, smi = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rmi, tmi, smi, Rji, tji, sji)
    phi = lie.so3_log(Re)
    sigma = jnp.log(jnp.maximum(se, 1e-9))
    # translation part of sim3 log: use V^-1-free first-order form (te is
    # already small near convergence); adequate as a residual metric
    return jnp.concatenate([te, phi, sigma[None]])


def _edge_residual_perturbed(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


def _edge_residual_perturbed_right(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Right-perturbed variant: S' = S ∘ exp(xi), i.e. the increment acts
    in WORLD coordinates. Used by the 4-DoF (gravity-aligned) mode, where
    the free rotation dof must be yaw about the world gravity axis."""
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    Ri2, ti2, si2 = lie.sim3_compose(Ri, ti, si, dRi, dti, dsi)
    Rj2, tj2, sj2 = lie.sim3_compose(Rj, tj, sj, dRj, dtj, dsj)
    return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


def optimize(
    graph: PoseGraph,
    iters: int = 20,
    se3: bool = False,
    damping: float = 1e-6,
    mode: str | None = None,
) -> PoseGraph:
    """Run `iters` GN iterations (reference budget: optimize(20),
    src/Optimizer.cc:2689).

    mode: "sim3" (7-DoF, reference OptimizeEssentialGraph :2437),
    "se3" (6-DoF, scale pinned — :2755), or "4dof" (translation + yaw
    about the world z/gravity axis, the inertial essential graph —
    reference OptimizeEssentialGraph4DoF / Edge4DoF, Optimizer.cc:8247).
    `se3=True` is a legacy alias for mode="se3".
    """
    if mode is None:
        mode = "se3" if se3 else "sim3"
    K = graph.R.shape[0]
    dof = 7
    # dofs pinned to zero update per mode (xi = [rho(3), phi(3), sigma])
    if mode == "sim3":
        pinned = ()
    elif mode == "se3":
        pinned = (6,)
    elif mode == "4dof":
        pinned = (3, 4, 6)  # phi_x, phi_y, sigma — free: rho, yaw
    else:
        raise ValueError(f"unknown pgo mode {mode!r}")
    perturbed = _edge_residual_perturbed_right if mode == "4dof" else _edge_residual_perturbed

    zeros7 = jnp.zeros(7)

    def linearize(R, t, s):
        Ri, ti, si = R[graph.e_i], t[graph.e_i], s[graph.e_i]
        Rj, tj, sj = R[graph.e_j], t[graph.e_j], s[graph.e_j]

        def one(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
            r = perturbed(zeros7, zeros7, Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
            Ji = jax.jacfwd(lambda x: perturbed(x, zeros7, Ri, ti, si, Rj, tj, sj, Rm, tm, sm))(zeros7)
            Jj = jax.jacfwd(lambda x: perturbed(zeros7, x, Ri, ti, si, Rj, tj, sj, Rm, tm, sm))(zeros7)
            return r, Ji, Jj

        return jax.vmap(one)(Ri, ti, si, Rj, tj, sj, graph.e_R, graph.e_t, graph.e_s)

    def iteration(_, carry):
        R, t, s = carry
        r, Ji, Jj = linearize(R, t, s)  # [E,7], [E,7,7], [E,7,7]
        w = jnp.where(graph.e_mask, graph.e_weight, 0.0)

        H = jnp.zeros((K, K, dof, dof))
        g = jnp.zeros((K, dof))
        Hii = jnp.einsum("eai,e,eaj->eij", Ji, w, Ji, precision=_HI)
        Hjj = jnp.einsum("eai,e,eaj->eij", Jj, w, Jj, precision=_HI)
        Hij = jnp.einsum("eai,e,eaj->eij", Ji, w, Jj, precision=_HI)
        H = H.at[graph.e_i, graph.e_i].add(Hii)
        H = H.at[graph.e_j, graph.e_j].add(Hjj)
        H = H.at[graph.e_i, graph.e_j].add(Hij)
        H = H.at[graph.e_j, graph.e_i].add(jnp.swapaxes(Hij, -1, -2))
        g = g.at[graph.e_i].add(jnp.einsum("eai,e,ea->ei", Ji, w, r, precision=_HI))
        g = g.at[graph.e_j].add(jnp.einsum("eai,e,ea->ei", Jj, w, r, precision=_HI))

        free = (graph.node_mask & ~graph.fixed_mask).astype(H.dtype)
        H = H * free[:, None, None, None] * free[None, :, None, None]
        eye = jnp.eye(dof)
        H = H.at[jnp.arange(K), jnp.arange(K)].add((1.0 - free)[:, None, None] * eye + damping * eye)
        g = g * free[:, None]
        for d in pinned:
            # pin dof d: identity row/col so its update is zero
            H = H.at[:, :, d, :].set(0.0)
            H = H.at[:, :, :, d].set(0.0)
            H = H.at[jnp.arange(K), jnp.arange(K), d, d].set(1.0)
            g = g.at[:, d].set(0.0)

        Hd = H.transpose(0, 2, 1, 3).reshape(K * dof, K * dof)
        delta = -jnp.linalg.solve(Hd, g.reshape(-1)).reshape(K, dof)
        bad = ~jnp.all(jnp.isfinite(delta))
        delta = jnp.where(bad, 0.0, delta)

        dR, dt, ds = lie.sim3_exp(delta)
        if mode == "4dof":
            R2, t2, s2 = lie.sim3_compose(R, t, s, dR, dt, ds)
        else:
            R2, t2, s2 = lie.sim3_compose(dR, dt, ds, R, t, s)
        return lie.normalize_rotation(R2), t2, s2

    R, t, s = jax.lax.fori_loop(0, iters, iteration, (graph.R, graph.t, graph.s))
    return dataclasses.replace(graph, R=R, t=t, s=s)


def chain_edges(R: jax.Array, t: jax.Array, s: jax.Array, valid: jax.Array):
    """Sequential odometry edges k-1 -> k from current estimates.

    (the spanning-tree backbone of the reference's essential graph)
    """
    K = R.shape[0]
    i = jnp.arange(K - 1, dtype=jnp.int32)
    j = i + 1
    Rii, tii, sii = lie.sim3_inverse(R[i], t[i], s[i])
    Rm, tm, sm = lie.sim3_compose(R[j], t[j], s[j], Rii, tii, sii)
    mask = valid[i] & valid[j]
    return i, j, Rm, tm, sm, mask


def covis_edges(R: jax.Array, t: jax.Array, s: jax.Array, valid: jax.Array,
                covis: jax.Array, n_top: int = 2, min_weight: int = 30):
    """Covisibility edges: each keyframe to its `n_top` most covisible
    non-adjacent keyframes with weight >= min_weight (the reference's
    essential graph adds covisibility edges with w >= 100 on top of the
    spanning tree, src/Optimizer.cc:2437-2750; our threshold is lower
    because the dense slot budget caps per-pair counts).
    Measurements are the CURRENT relative poses, matching chain_edges.
    """
    K = R.shape[0]
    ids = jnp.arange(K, dtype=jnp.int32)
    w = jnp.where(valid[:, None] & valid[None, :], covis, 0)
    w = jnp.where(jnp.abs(ids[:, None] - ids[None, :]) <= 1, 0, w)  # chain covers these
    top_w, top_j = jax.lax.top_k(w, n_top)  # [K, n_top]
    i = jnp.repeat(ids, n_top)
    j = top_j.reshape(-1).astype(jnp.int32)
    mask = (top_w.reshape(-1) >= min_weight) & valid[i] & valid[j] & (i < j)
    Rii, tii, sii = lie.sim3_inverse(R[i], t[i], s[i])
    Rm, tm, sm = lie.sim3_compose(R[j], t[j], s[j], Rii, tii, sii)
    return i, j, Rm, tm, sm, mask
