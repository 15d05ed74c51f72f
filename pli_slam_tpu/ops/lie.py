"""SO(3) / SE(3) / Sim(3) Lie-group operations, vmap/jit friendly.

JAX replacement for the reference's scattered SE(3) math:
- `expmap_se3` / `logmap_se3` / `inverse_se3` (reference: include/Auxiliar.h:49-88)
- SO3 Exp/Log/right-Jacobian (reference: include/ImuTypes.h:269-279,
  src/ImuTypes.cc `NormalizeRotation`, `RightJacobianSO3`)
- g2o SE3Quat / Sim3 (reference: Thirdparty/g2o/g2o/types/{se3quat.h,sim3.h})

All functions are elementwise-batched by construction (trailing-dim
convention: rotations are `[..., 3, 3]`, vectors `[..., 3]`), safe in
float32 via Taylor fallbacks near theta=0, and contain no Python
branching on traced values — safe under `jit`, `vmap`, `grad`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_EPS = 1e-6

# All Lie-group matrices are 3x3/4x4: FLOPs are negligible but precision is
# not — an f32 dot with no precision set may run in TF32 on the GPU (10-bit
# mantissa), which destroys rotation orthogonality. Force full float32.
_HI = jax.lax.Precision.HIGHEST
_mm = partial(jnp.matmul, precision=_HI)
_einsum = partial(jnp.einsum, precision=_HI)


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v). [...,3] -> [...,3,3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat. [...,3,3] -> [...,3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jax.Array):
    """Stable (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) given t^2.

    AD-safe at theta=0: the singular branch's operands are clamped with a
    second `where` ("double-where") so reverse/forward-mode AD never sees
    0 * inf from the unselected branch.
    """
    small = theta2 < _EPS
    t2_safe = jnp.where(small, 1.0, theta2)  # keeps the generic branch finite
    theta = jnp.sqrt(t2_safe)
    # Taylor: sin t / t ~ 1 - t^2/6 ; (1-cos)/t^2 ~ 1/2 - t^2/24 ; (t-sin)/t^3 ~ 1/6 - t^2/120
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / t2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (t2_safe * theta))
    return a, b, c


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle [...,3] -> rotation matrix [...,3,3]."""
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix [...,3,3] -> axis-angle [...,3].

    Handles theta near 0 and near pi (float32-safe).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # Generic branch: vee of antisymmetric part, scaled.
    w_asym = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    # theta via atan2(sin, cos): smooth at identity (arccos'(1) = -inf
    # would poison autodiff through pose-graph residuals at zero error)
    sin_norm2 = jnp.sum(w_asym * w_asym, axis=-1)
    small_s = sin_norm2 < 1e-12
    sin_t = jnp.sqrt(jnp.where(small_s, 1.0, sin_norm2))
    sin_t = jnp.where(small_s, 0.0, sin_t)
    theta = jnp.arctan2(sin_t, cos_t)
    scale = jnp.where(
        theta < 1e-3,
        1.0 + theta * theta / 6.0,
        theta / jnp.where(theta < 1e-3, 1.0, jnp.maximum(sin_t, 1e-12)),
    )
    w_generic = w_asym * scale[..., None]
    # Near-pi branch. The symmetric part S = (R+R^T)/2 kills the sin(theta)*K
    # term exactly, leaving (1+cos)I + (1-cos) a a^T; the row at the largest
    # diagonal entry then gives the axis *linearly* (f32 error ~1e-7, vs
    # ~sqrt(eps)=2.4e-4 for the per-component sqrt(diag) extraction).
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    diag_k = jnp.take_along_axis(diag, k[..., None], axis=-1)[..., 0]
    a_k = jnp.sqrt(jnp.maximum((diag_k + 1.0) * 0.5, 1e-12))
    one_minus_cos = jnp.maximum(1.0 - cos_t, 1e-6)
    S = (R + jnp.swapaxes(R, -1, -2)) * 0.5
    rows = jnp.take_along_axis(S, k[..., None, None] * jnp.ones_like(S[..., :1, :], dtype=k.dtype), axis=-2)[..., 0, :]
    axis_unnorm = rows / (one_minus_cos * a_k)[..., None]
    # overwrite the k-th component with a_k itself (its row entry holds (1+cos) too)
    onehot_k = jax.nn.one_hot(k, 3, dtype=R.dtype)
    axis_unnorm = jnp.where(onehot_k > 0, a_k[..., None], axis_unnorm)
    norm = jnp.linalg.norm(axis_unnorm, axis=-1, keepdims=True)
    axis_pi = axis_unnorm / jnp.maximum(norm, 1e-12)
    # arccos is ill-conditioned at theta ~ pi; recover theta from the
    # antisymmetric part instead: |w_asym| = sin(theta) = sin(pi - theta).
    sin_norm = jnp.linalg.norm(w_asym, axis=-1)
    theta_pi = jnp.pi - jnp.arcsin(jnp.clip(sin_norm, 0.0, 1.0))
    # For theta < pi the antisymmetric part fixes the axis sign.
    dot = jnp.sum(axis_pi * w_asym, axis=-1)
    axis_pi = jnp.where((dot < -1e-9)[..., None], -axis_pi, axis_pi)
    w_pi = axis_pi * theta_pi[..., None]
    near_pi = (jnp.pi - theta) < 1e-3
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def so3_right_jacobian(w: jax.Array) -> jax.Array:
    """Right Jacobian Jr of SO(3): Exp(w + dw) ~ Exp(w) Exp(Jr dw).

    Reference math: src/ImuTypes.cc `RightJacobianSO3`.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I - b[..., None, None] * W + c[..., None, None] * _mm(W, W)


def so3_right_jacobian_inv(w: jax.Array) -> jax.Array:
    """Inverse right Jacobian of SO(3) (reference: InverseRightJacobianSO3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < _EPS
    t2_safe = jnp.where(small, 1.0, theta2)  # AD-safe double-where
    theta = jnp.sqrt(t2_safe)
    # coefficient of W^2:  1/t^2 - (1+cos t)/(2 t sin t); Taylor: 1/12 + t^2/720
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / t2_safe - (1.0 + jnp.cos(theta)) / (2.0 * theta * jnp.maximum(jnp.sin(theta), 1e-12)),
    )
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + 0.5 * W + cot_term[..., None, None] * _mm(W, W)


def normalize_rotation(R: jax.Array) -> jax.Array:
    """Project to the closest rotation matrix via SVD (reference: NormalizeRotation)."""
    u, _, vt = jnp.linalg.svd(R, full_matrices=False)
    det = jnp.linalg.det(_mm(u, vt))
    # flip last column of u if det < 0 to stay in SO(3)
    u = u.at[..., :, -1].multiply(jnp.sign(det)[..., None])
    return _mm(u, vt)


# ---------------------------------------------------------------------------
# SE(3): represented as (R [...,3,3], t [...,3]).  T x = R x + t.
# Twists are 6-vectors [rho(3), phi(3)] (translation part first, matching the
# reference's expmap_se3 convention of x = [trans, rot]).
# ---------------------------------------------------------------------------


def se3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Twist [...,6] = [rho, phi] -> (R, t) with t = V(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(phi * phi, axis=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = so3_exp(phi)
    V = I + b[..., None, None] * W + c[..., None, None] * _mm(W, W)
    t = _einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R: jax.Array, t: jax.Array) -> jax.Array:
    """(R, t) -> twist [...,6] = [rho, phi]."""
    phi = so3_log(R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < _EPS
    W = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), W.shape)
    # V^{-1} = I - W/2 + coef * W^2, coef = (1/t^2)(1 - (t sin t)/(2(1-cos t)))
    half_t = theta * 0.5
    cot_half = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * jnp.cos(half_t) / jnp.maximum(jnp.sin(half_t), 1e-12)) / jnp.maximum(theta2, 1e-24),
    )
    Vinv = I - 0.5 * W + cot_half[..., None, None] * _mm(W, W)
    rho = _einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(R: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array]:
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -_einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb) -> tuple[jax.Array, jax.Array]:
    """(Ra,ta) ∘ (Rb,tb): first apply b, then a."""
    return _mm(Ra, Rb), _einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, x) -> jax.Array:
    return _einsum("...ij,...j->...i", R, x) + t


def se3_matrix(R: jax.Array, t: jax.Array) -> jax.Array:
    """Pack (R,t) into a homogeneous [...,4,4] matrix."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_from_matrix(T: jax.Array) -> tuple[jax.Array, jax.Array]:
    return T[..., :3, :3], T[..., :3, 3]


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s); action x -> s R x + t (reference: g2o/types/sim3.h)
# Twists are 7-vectors [rho, phi, sigma], sigma = log scale.
# ---------------------------------------------------------------------------


def sim3_exp(xi: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Twist [...,7] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    W = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    small_sig = jnp.abs(sigma) < _EPS
    small_th = theta2 < _EPS
    # coefficients of V = a_ I + b_ W + c_ W^2 for Sim3 (Strasdat's thesis)
    a_coef = jnp.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / jnp.where(small_sig, 1.0, sigma))
    sig2t2 = sigma * sigma + theta2
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)

    def _generic():
        # AD-safe: denominators forced to 1 where the Taylor branch wins,
        # so the unselected branch never produces inf/1e24-scale values
        # that leak through `where` gradients.
        A = s * sin_t
        B = s * cos_t
        den1 = jnp.where(small_th, 1.0, theta * sig2t2)
        den2 = jnp.where(small_th, 1.0, sig2t2)
        den3 = jnp.where(small_th, 1.0, theta2)
        b_ = (A * sigma + (1.0 - B) * theta) / den1
        c_ = (a_coef - ((B - 1.0) * sigma + A * theta) / den2) / den3
        return b_, c_

    b_gen, c_gen = _generic()
    # small-theta Taylor in theta (exact in sigma where stable):
    #   b -> (s(sigma-1)+1)/sigma^2,  c -> (s(sigma^2/2 - sigma + 1) - 1 - ... )/sigma^3;
    # at theta<1e-3 the low-order Taylor (also in sigma) is ample for f32.
    b_small = jnp.where(
        small_sig,
        0.5 + sigma / 3.0,
        (sigma * s - s + 1.0) / jnp.where(small_sig, 1.0, sigma * sigma),
    )
    c_small = 1.0 / 6.0 + sigma / 8.0
    b_ = jnp.where(small_th, b_small, b_gen)
    c_ = jnp.where(small_th, c_small, c_gen)
    V = a_coef[..., None, None] * I + b_[..., None, None] * W + c_[..., None, None] * _mm(W, W)
    t = _einsum("...ij,...j->...i", V, rho)
    return R, t, s


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return _mm(Ra, Rb), sa[..., None] * _einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb


def sim3_apply(R, t, s, x):
    return s[..., None] * _einsum("...ij,...j->...i", R, x) + t


# ---------------------------------------------------------------------------
# Quaternion helpers (wxyz convention) for trajectory IO.
# ---------------------------------------------------------------------------


def quat_from_rotation(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion [...,4] (w,x,y,z). Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    q1 = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    q2 = jnp.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], axis=-1)
    q3 = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], axis=-1)
    cases = jnp.stack([q0, q1, q2, q3], axis=-2)  # [...,4,4]
    diag = jnp.stack([tr, m00, m11, m22], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    q = jnp.take_along_axis(cases, k[..., None, None] * jnp.ones_like(cases[..., :1, :], dtype=k.dtype), axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return jnp.where((q[..., :1] < 0), -q, q)


def rotation_from_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion [...,4] (w,x,y,z) -> rotation matrix [...,3,3]."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )
