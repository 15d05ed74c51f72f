"""Camera models: Pinhole and Kannala-Brandt-8 fisheye, as batched pure functions.

JAX replacement for the reference's `GeometricCamera` virtual
interface (reference: include/CameraModels/GeometricCamera.h:37-102,
src/CameraModels/{Pinhole,KannalaBrandt8}.cpp). Instead of virtual
dispatch over heap objects, a camera is a small pytree of parameters and
every operation is vmapped over points; the model kind is a static field
so `jit` specializes per model.

Projection convention: points in camera frame, z forward; pixel = (u, v).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

PINHOLE = 0
KANNALA_BRANDT8 = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera intrinsics.

    fx, fy, cx, cy always; k[4] are KB8 coefficients (k1..k4) for the
    fisheye model, ignored for pinhole (the reference rectifies stereo
    pinhole input, so distortion is handled at ingest — as does
    `Tracking::ParseCamParamFile`, reference src/Tracking.cc:144).
    `bf` = baseline * fx for stereo (reference Frame `mbf`).
    """

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    k: jax.Array  # [4] KB8 distortion
    bf: jax.Array  # stereo baseline * fx
    width: int = dataclasses.field(metadata=dict(static=True), default=752)
    height: int = dataclasses.field(metadata=dict(static=True), default=480)
    model: int = dataclasses.field(metadata=dict(static=True), default=PINHOLE)

    @staticmethod
    def pinhole(fx, fy, cx, cy, bf=0.0, width=752, height=480) -> "Camera":
        f32 = partial(jnp.asarray, dtype=jnp.float32)
        return Camera(f32(fx), f32(fy), f32(cx), f32(cy), jnp.zeros(4, jnp.float32), f32(bf), int(width), int(height), PINHOLE)

    @staticmethod
    def kannala_brandt8(fx, fy, cx, cy, k, bf=0.0, width=752, height=480) -> "Camera":
        f32 = partial(jnp.asarray, dtype=jnp.float32)
        return Camera(f32(fx), f32(fy), f32(cx), f32(cy), f32(k), f32(bf), int(width), int(height), KANNALA_BRANDT8)

    @property
    def baseline(self) -> jax.Array:
        return self.bf / self.fx

    def K(self) -> jax.Array:
        return jnp.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], dtype=jnp.float32
        )


def _kb8_theta_d(cam: Camera, theta: jax.Array) -> jax.Array:
    t2 = theta * theta
    k1, k2, k3, k4 = cam.k[0], cam.k[1], cam.k[2], cam.k[3]
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def project(cam: Camera, xyz: jax.Array) -> jax.Array:
    """Camera-frame points [...,3] -> pixels [...,2].

    Pinhole: (reference Pinhole::project, src/CameraModels/Pinhole.cpp)
    KB8: equidistant + polynomial (reference KannalaBrandt8::project).
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if cam.model == PINHOLE:
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        return jnp.stack([cam.fx * x * inv_z + cam.cx, cam.fy * y * inv_z + cam.cy], axis=-1)
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(r, z)
    td = _kb8_theta_d(cam, theta)
    scale = td / jnp.maximum(r, 1e-9)
    return jnp.stack([cam.fx * x * scale + cam.cx, cam.fy * y * scale + cam.cy], axis=-1)


def unproject(cam: Camera, uv: jax.Array) -> jax.Array:
    """Pixels [...,2] -> unit-depth rays [...,3] with z=1.

    KB8 inverts theta_d(theta) by fixed Newton iterations (8, matching the
    reference's iterative `unproject`, src/CameraModels/KannalaBrandt8.cpp)
    — fixed trip count keeps it jit-friendly.
    """
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    if cam.model == PINHOLE:
        return jnp.stack([mx, my, jnp.ones_like(mx)], axis=-1)
    td = jnp.sqrt(mx * mx + my * my)
    td_c = jnp.clip(td, 0.0, jnp.pi / 2.0 * 1.5)
    theta = td_c

    def newton(_, th):
        t2 = th * th
        k1, k2, k3, k4 = cam.k[0], cam.k[1], cam.k[2], cam.k[3]
        f = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - td_c
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        return th - f / jnp.maximum(df, 1e-6)

    theta = jax.lax.fori_loop(0, 8, newton, theta)
    scale = jnp.tan(theta) / jnp.maximum(td, 1e-9)
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def project_jacobian(cam: Camera, xyz: jax.Array) -> jax.Array:
    """d(pixel)/d(camera-frame point): [...,2,3].

    (reference: Pinhole::projectJac / KannalaBrandt8::projectJac)
    """
    if cam.model == PINHOLE:
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        inv_z2 = inv_z * inv_z
        zeros = jnp.zeros_like(x)
        row0 = jnp.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], axis=-1)
        row1 = jnp.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    # KB8: autodiff the projection (elementwise, negligible vs matching cost)
    flat = xyz.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(lambda p: project(cam, p)))(flat)
    return J.reshape(xyz.shape[:-1] + (2, 3))


def in_image(cam: Camera, uv: jax.Array, margin: float = 0.0) -> jax.Array:
    """Bounds check [...,2] -> bool[...]."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= margin) & (u < cam.width - margin) & (v >= margin) & (v < cam.height - margin)


def stereo_project(cam: Camera, xyz: jax.Array) -> jax.Array:
    """[...,3] -> (u_l, v_l, u_r) for a rectified stereo pair.

    u_r = u_l - bf/z (reference: Frame::UnprojectStereo inverse relation).
    """
    uv = project(cam, xyz)
    z = xyz[..., 2]
    ur = uv[..., 0] - cam.bf / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def back_project_stereo(cam: Camera, uv: jax.Array, disparity: jax.Array) -> jax.Array:
    """Pixels + disparity -> camera-frame 3D points. z = bf / disparity.

    (reference: Frame::backProjection, src/Frame.cc:1349)
    """
    z = cam.bf / jnp.maximum(disparity, 1e-6)
    ray = unproject(cam, uv)
    return ray * z[..., None]


def depth_from_disparity(cam: Camera, disparity: jax.Array) -> jax.Array:
    return cam.bf / jnp.maximum(disparity, 1e-6)
