"""Two-view triangulation and epipolar geometry helpers, batched.

JAX replacement for the triangulation inside
`LocalMapping::CreateNewMapPoints` (reference: src/LocalMapping.cc:343 —
per-pair SVD of the 4x4 DLT system) and the epipolar checks of
`ORBmatcher::SearchForTriangulation` (reference: src/ORBmatcher.cc,
`CheckDistEpipolarLine`). Everything is vmapped over correspondence
batches; the DLT solve uses the closed-form smallest-eigenvector of
A^T A (4x4 symmetric) instead of per-point SVD loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import camera as cam_ops
from pli_slam_tpu.ops import lie

_HI = jax.lax.Precision.HIGHEST


def triangulate_dlt(R1, t1, R2, t2, ray1: jax.Array, ray2: jax.Array) -> jax.Array:
    """DLT triangulation in normalized camera coordinates.

    (R_i, t_i): T_cw of the two views; ray_i: [N,3] unit-depth rays
    (z=1) of the matched observations. Returns world points [N,3].
    """
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)  # [3,4]
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)

    def build_A(r1, r2):
        rows = jnp.stack(
            [
                r1[0] * P1[2] - P1[0],
                r1[1] * P1[2] - P1[1],
                r2[0] * P2[2] - P2[0],
                r2[1] * P2[2] - P2[1],
            ]
        )  # [4,4]
        return rows

    A = jax.vmap(build_A)(ray1, ray2)  # [N,4,4]
    AtA = jnp.einsum("nij,nik->njk", A, A, precision=_HI)
    # smallest eigenvector by shifted inverse-power iteration with a
    # closed-form 4x4 inverse: adjugate-inverse + 3 matvecs is pure
    # elementwise math, with no batched tiny eigh.
    # The shift is a fraction of the diagonal scale, so (AtA - sI) is
    # well-conditioned for inversion while the smallest eigencomponent
    # still dominates the iteration.
    diag_scale = jnp.einsum("nii->n", AtA) / 4.0
    M = AtA + 1e-6 * jnp.maximum(diag_scale, 1e-12)[:, None, None] * jnp.eye(4)
    Minv = _inv4x4(M)
    v = jnp.ones(AtA.shape[:-2] + (4,))
    for _ in range(3):
        v = jnp.einsum("nij,nj->ni", Minv, v, precision=_HI)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    Xh = v
    w = Xh[..., 3]
    safe = jnp.abs(w) > 1e-9
    X = Xh[..., :3] / jnp.where(safe, w, 1.0)[..., None]
    return jnp.where(safe[..., None], X, 0.0)


def _inv4x4(m: jax.Array) -> jax.Array:
    """Closed-form batched 4x4 inverse via cofactor expansion (elementwise
    only — no LU/eig lowering)."""
    # unpack
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (
            a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
            - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
            + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0])
        )

    rows = (0, 1, 2, 3)
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = tuple(r for r in rows if r != i)
        for j in range(4):
            cj = tuple(c for c in rows if c != j)
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            cof[i][j] = sign * det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
    det = sum(a[0][j] * cof[0][j] for j in range(4))
    adj = jnp.stack([jnp.stack([cof[j][i] for j in range(4)], -1) for i in range(4)], -2)
    det_safe = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return adj / det_safe[..., None, None]


def triangulate_midpoint(R1, t1, R2, t2, ray1, ray2):
    """Midpoint triangulation (cheaper, also batched). Returns ([N,3], parallax cos [N])."""
    Rw1, tw1 = lie.se3_inverse(R1, t1)
    Rw2, tw2 = lie.se3_inverse(R2, t2)
    d1 = jnp.einsum("ij,nj->ni", Rw1, ray1, precision=_HI)
    d2 = jnp.einsum("ij,nj->ni", Rw2, ray2, precision=_HI)
    d1 = d1 / jnp.maximum(jnp.linalg.norm(d1, axis=-1, keepdims=True), 1e-12)
    d2 = d2 / jnp.maximum(jnp.linalg.norm(d2, axis=-1, keepdims=True), 1e-12)
    o1, o2 = tw1, tw2
    # solve [d1 -d2][s;t] = o2 - o1 in least squares (2x2 normal equations)
    b = o2 - o1
    a11 = jnp.sum(d1 * d1, axis=-1)
    a12 = -jnp.sum(d1 * d2, axis=-1)
    a22 = jnp.sum(d2 * d2, axis=-1)
    b1 = jnp.sum(d1 * b, axis=-1)
    b2 = -jnp.sum(d2 * b, axis=-1)
    det = a11 * a22 - a12 * a12
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    s = (b1 * a22 - b2 * a12) / det_safe
    u = (a11 * b2 - a12 * b1) / det_safe
    p1 = o1 + s[..., None] * d1
    p2 = o2 + u[..., None] * d2
    X = 0.5 * (p1 + p2)
    cos_par = jnp.sum(d1 * d2, axis=-1)
    return X, cos_par


def triangulation_checks(
    cam, R1, t1, R2, t2, X_w, uv1, uv2, sigma2_1, sigma2_2,
    min_parallax_cos: float = 0.9998, max_chi2: float = 5.991,
):
    """Acceptance gates mirroring CreateNewMapPoints (LocalMapping.cc:489-593):
    positive depth in both views, reprojection chi2 in both, parallax."""
    x1 = lie.se3_apply(R1, t1, X_w)
    x2 = lie.se3_apply(R2, t2, X_w)
    ok = (x1[..., 2] > 0.05) & (x2[..., 2] > 0.05)
    e1 = cam_ops.project(cam, x1) - uv1
    e2 = cam_ops.project(cam, x2) - uv2
    chi1 = jnp.sum(e1 * e1, axis=-1) / sigma2_1
    chi2_ = jnp.sum(e2 * e2, axis=-1) / sigma2_2
    ok = ok & (chi1 < max_chi2) & (chi2_ < max_chi2)
    # parallax from the viewing rays
    Rw1, tw1 = lie.se3_inverse(R1, t1)
    Rw2, tw2 = lie.se3_inverse(R2, t2)
    r1 = X_w - tw1
    r2 = X_w - tw2
    cos_par = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
    )
    ok = ok & (cos_par < min_parallax_cos)
    return ok


def epipolar_gate(cam, R1, t1, R2, t2, uv1, uv2, thresh: float = 3.84):
    """Pairwise epipolar-distance predicate [N1,N2] for triangulation search.

    Fundamental from relative pose (rectified-intrinsics pinhole):
    F = K^-T [t]x R K^-1 with (R, t) = T_c2w ∘ T_wc1.
    """
    R12, t12 = lie.se3_compose(R2, t2, *lie.se3_inverse(R1, t1))
    E = lie._mm(lie.hat(t12), R12)
    Kinv = jnp.linalg.inv(cam.K())
    F = lie._mm(Kinv.T, lie._mm(E, Kinv))
    h1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=1)  # [N1,3]
    h2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], axis=1)
    lines = jnp.einsum("ij,nj->ni", F, h1, precision=_HI)  # epiline of uv1 in img2
    num = jnp.abs(jnp.einsum("mi,ni->nm", h2, lines, precision=_HI))  # [N1,N2]
    den = jnp.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None]
    d2 = (num / jnp.maximum(den, 1e-9)) ** 2
    return d2 < thresh
