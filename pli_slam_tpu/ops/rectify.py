"""Stereo rectification / undistortion at image ingest.

JAX replacement for the reference's cv::initUndistortRectifyMap +
cv::remap pipeline (reference: src/Tracking.cc:144-258 builds M1l/M2l,
M1r/M2r from the LEFT./RIGHT. K/D/R/P YAML blocks,
Examples/Stereo-Inertial/Config/EuRoC.yaml:55-104; the CLI driver remaps
every frame, Examples/Stereo/stereo_euroc.cc:166-167).

The remap GRIDS are built once on the host in float64 (OpenCV
convention: for each rectified pixel, un-project through the rectified
projection P, rotate back by R^-1, distort with the radial-tangential
model, project through the raw intrinsics K). The per-frame work — one
bilinear gather per image — runs on device inside the frame program.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def radtan_distort(x: np.ndarray, y: np.ndarray, D: np.ndarray):
    """Apply the OpenCV radial-tangential model to normalized coords.

    D = [k1, k2, p1, p2, (k3)].
    """
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x_d, y_d


def build_rectify_map(K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray,
                      width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Map from rectified pixel -> raw pixel (cv::initUndistortRectifyMap).

    K [3,3] raw intrinsics, D [4-5] distortion, R [3,3] rectifying
    rotation (raw cam -> rectified cam), P [3,4] rectified projection.
    Returns (map_x, map_y) float32 [H, W].
    """
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    fx_p, fy_p = P[0, 0], P[1, 1]
    cx_p, cy_p = P[0, 2], P[1, 2]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    # un-project through the rectified projection, rotate back to the raw
    # camera frame (R maps raw -> rectified, so apply R^T)
    xn = (u - cx_p) / fx_p
    yn = (v - cy_p) / fy_p
    ray = np.stack([xn, yn, np.ones_like(xn)], axis=-1) @ R  # == (R^T @ ray^T)^T
    x = ray[..., 0] / ray[..., 2]
    y = ray[..., 1] / ray[..., 2]
    x_d, y_d = radtan_distort(x, y, D)
    map_x = K[0, 0] * x_d + K[0, 2]
    map_y = K[1, 1] * y_d + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap_bilinear(img: jax.Array, map_x: jax.Array, map_y: jax.Array) -> jax.Array:
    """Bilinear remap on device (cv::remap INTER_LINEAR equivalent).

    Out-of-bounds source coordinates clamp to the border (the border
    pixels of EuRoC rectification lie outside the raw image by <2 px).
    """
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(map_x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(map_y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(map_x - x0.astype(map_x.dtype), 0.0, 1.0)
    fy = jnp.clip(map_y - y0.astype(map_y.dtype), 0.0, 1.0)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    top = i00 * (1.0 - fx) + i01 * fx
    bot = i10 * (1.0 - fx) + i11 * fx
    return top * (1.0 - fy) + bot * fy


@dataclasses.dataclass(frozen=True)
class StereoRectifier:
    """Precomputed remap grids for a stereo rig (device arrays)."""

    map_x_l: jax.Array
    map_y_l: jax.Array
    map_x_r: jax.Array
    map_y_r: jax.Array

    @staticmethod
    def from_kdrp(K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r, width: int, height: int) -> "StereoRectifier":
        mxl, myl = build_rectify_map(K_l, D_l, R_l, P_l, width, height)
        mxr, myr = build_rectify_map(K_r, D_r, R_r, P_r, width, height)
        return StereoRectifier(
            map_x_l=jnp.asarray(mxl), map_y_l=jnp.asarray(myl),
            map_x_r=jnp.asarray(mxr), map_y_r=jnp.asarray(myr),
        )

    def __call__(self, img_l: jax.Array, img_r: jax.Array):
        return (
            remap_bilinear(img_l, self.map_x_l, self.map_y_l),
            remap_bilinear(img_r, self.map_x_r, self.map_y_r),
        )


def euroc_rectifier() -> StereoRectifier:
    """The EuRoC MAV rig's rectifier, constants from the reference's
    Examples/Stereo-Inertial/Config/EuRoC.yaml:55-104 (LEFT./RIGHT.
    K/D/R/P blocks)."""
    c = EUROC_KDRP
    return StereoRectifier.from_kdrp(
        c["K_l"], c["D_l"], c["R_l"], c["P_l"],
        c["K_r"], c["D_r"], c["R_r"], c["P_r"], 752, 480,
    )


EUROC_KDRP = {
    "K_l": np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]]),
    "D_l": np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    "R_l": np.array([
        [0.999966347530033, -0.001422739138722922, 0.008079580483432283],
        [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
        [-0.008089410156878961, -0.007044357138835809, 0.9999424675829176],
    ]),
    "P_l": np.array([
        [435.2046959714599, 0.0, 367.4517211914062, 0.0],
        [0.0, 435.2046959714599, 252.2008514404297, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ]),
    "K_r": np.array([[457.587, 0.0, 379.999], [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]]),
    "D_r": np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]),
    "R_r": np.array([
        [0.9999633526194376, -0.003625811871560086, 0.007755443660172947],
        [0.003680398547259526, 0.9999684752771629, -0.007035845251224894],
        [-0.007729688520722713, 0.007064130529506649, 0.999945173484644],
    ]),
    "P_r": np.array([
        [435.2046959714599, 0.0, 367.4517211914062, -47.90639384423901],
        [0.0, 435.2046959714599, 252.2008514404297, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ]),
}
