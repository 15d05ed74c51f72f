"""Synthetic stereo-inertial sequence generator (renderer + IMU).

Fills the role of the EuRoC replay datasets for testing/benchmarking on
hosts without the dataset (the reference's drivers replay EuRoC from
disk, Examples/Stereo-Inertial/stereo_inertial_euroc.cc:124-151). A
textured "room" (inside of a box with a procedural value-noise texture
plus a dark grid of straight lines) is ray-traced per pixel on device,
so any camera trajectory yields photo-consistent stereo pairs with
abundant ORB corners AND straight line segments; ground-truth poses,
velocities, and ideal IMU samples come from the analytic trajectory.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.ops import lie
from pli_slam_tpu.ops.camera import Camera

ROOM_HALF = 6.35  # box half-extent; deliberately NOT on the 1 m texture grid
# (a wall at an integer coordinate would lie entirely inside a grid line)


def _value_noise(p: jax.Array, seed: float) -> jax.Array:
    """Smooth pseudo-random scalar field over 3D points [...,3] -> [0,1]."""
    out = jnp.zeros(p.shape[:-1])
    # sum of incommensurate sinusoids — cheap, smooth, corner-rich after
    # thresholding at multiple frequencies
    freqs = [(1.3, 2.1, 1.7), (2.9, 1.1, 3.3), (5.1, 4.3, 2.2), (8.7, 7.9, 9.4)]
    amps = [0.4, 0.3, 0.2, 0.1]
    for (fx, fy, fz), a in zip(freqs, amps):
        phase = seed * 12.9898
        out = out + a * jnp.sin(fx * p[..., 0] + phase) * jnp.sin(fy * p[..., 1] + 1.7 * phase) * jnp.sin(
            fz * p[..., 2] + 0.3 * phase
        )
    return 0.5 + 0.5 * out


def _texture(p: jax.Array) -> jax.Array:
    """Wall texture in [0, 255]: blobby noise + dark grid lines every 1 m."""
    base = 60.0 + 150.0 * _value_noise(p * 1.0, 0.7)
    # sharper speckle to create FAST corners
    speck = _value_noise(p * 4.0, 3.1)
    base = jnp.where(speck > 0.62, 235.0, base)
    base = jnp.where(speck < 0.38, 35.0, base)
    # dark grid lines (axis-aligned planes every 1 m) -> straight image lines
    def gridline(c):
        return jnp.abs(c - jnp.round(c)) < 0.06
    grid = gridline(p[..., 0]) | gridline(p[..., 1]) | gridline(p[..., 2])
    return jnp.where(grid, 15.0, base)


def _trace_room(cam: Camera, R_wc: jax.Array, t_wc: jax.Array, room_half: float):
    """Ray-trace the room box; returns (t_best [H,W] ray depth, p_hit [H,W,3])."""
    h, w = cam.height, cam.width
    from pli_slam_tpu.ops import camera as cam_ops

    if cam.model == cam_ops.PINHOLE:
        us = (jnp.arange(w, dtype=jnp.float32) - cam.cx) / cam.fx
        vs = (jnp.arange(h, dtype=jnp.float32) - cam.cy) / cam.fy
        dirs_c = jnp.stack(
            [
                jnp.broadcast_to(us[None, :], (h, w)),
                jnp.broadcast_to(vs[:, None], (h, w)),
                jnp.ones((h, w)),
            ],
            axis=-1,
        )
    else:
        # fisheye (KB8): per-pixel ray via the model's Newton unprojection
        uu, vv = jnp.meshgrid(
            jnp.arange(w, dtype=jnp.float32), jnp.arange(h, dtype=jnp.float32)
        )
        dirs_c = cam_ops.unproject(cam, jnp.stack([uu, vv], axis=-1))
    d_w = jnp.einsum("ij,hwj->hwi", R_wc, dirs_c, precision=jax.lax.Precision.HIGHEST)
    o_w = t_wc
    # intersect with the 6 box planes x,y,z = +-ROOM_HALF, take nearest t>0
    t_best = jnp.full((h, w), 1e9)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            denom = d_w[..., axis]
            t_hit = (sign * room_half - o_w[axis]) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
            hit = o_w + t_hit[..., None] * d_w
            other = [a for a in range(3) if a != axis]
            inside = (
                (t_hit > 0.05)
                & (jnp.abs(hit[..., other[0]]) <= room_half + 1e-3)
                & (jnp.abs(hit[..., other[1]]) <= room_half + 1e-3)
            )
            t_best = jnp.where(inside & (t_hit < t_best), t_hit, t_best)
    p_hit = o_w + t_best[..., None] * d_w
    return t_best, p_hit


def render_view(cam: Camera, R_wc: jax.Array, t_wc: jax.Array, room_half: float = ROOM_HALF) -> jax.Array:
    """Ray-trace the room box from camera pose T_wc. Returns [H, W] float32."""
    t_best, p_hit = _trace_room(cam, R_wc, t_wc, room_half)
    img = _texture(p_hit)
    # slight vignette/shading by distance for realism
    img = img * (1.0 - 0.015 * jnp.clip(t_best, 0.0, 12.0))
    return jnp.clip(img, 0.0, 255.0)


def render_depth(cam: Camera, R_wc: jax.Array, t_wc: jax.Array, room_half: float = ROOM_HALF) -> jax.Array:
    """Ground-truth camera-z depth map [H, W] (pinhole rays have z=1, so
    the ray parameter IS the depth). 0 where no surface is hit."""
    t_best, _ = _trace_room(cam, R_wc, t_wc, room_half)
    return jnp.where(t_best < 1e8, t_best, 0.0)


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Analytic smooth trajectory inside the room: p(t), R(t) and derivatives."""

    amp: tuple = (1.8, 1.2, 0.6)
    freq: tuple = (0.25, 0.31, 0.17)  # Hz
    yaw_amp: float = 0.5
    yaw_freq: float = 0.2

    def pose(self, t: float):
        """Returns (R_wb [3,3], p_w [3]) — body/camera frame: z forward."""
        ax, ay, az = self.amp
        fx, fy, fz = self.freq
        p = np.array(
            [
                ax * math.sin(2 * math.pi * fx * t),
                ay * math.sin(2 * math.pi * fy * t + 1.0),
                az * math.sin(2 * math.pi * fz * t + 2.0),
            ]
        )
        yaw = self.yaw_amp * math.sin(2 * math.pi * self.yaw_freq * t)
        pitch = 0.15 * math.sin(2 * math.pi * 0.13 * t + 0.5)
        cy, sy = math.cos(yaw), math.sin(yaw)
        cp, sp = math.cos(pitch), math.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        return Ry @ Rx, p

    def velocity(self, t: float, eps: float = 1e-4):
        _, p0 = self.pose(t - eps)
        _, p1 = self.pose(t + eps)
        return (p1 - p0) / (2 * eps)

    def imu_sample(self, t: float, gravity: float = 9.81, eps: float = 1e-3):
        """Ideal gyro (body rates) and accel (specific force in body frame).

        Pure numpy: this runs per IMU sample on the host, and a jnp op
        here would cost one device round-trip per sample."""
        R0, _ = self.pose(t - eps)
        R1, _ = self.pose(t + eps)
        Rm, _ = self.pose(t)
        dR = R0.T @ R1
        cos_a = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
        ang = np.arccos(cos_a)
        vee = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
        w = vee if ang < 1e-6 else vee * (ang / np.sin(ang))
        w = w / (2 * eps)
        v0 = self.velocity(t - eps)
        v1 = self.velocity(t + eps)
        a_w = (v1 - v0) / (2 * eps)
        g = np.array([0.0, 0.0, -gravity])
        a_b = Rm.T @ (a_w - g)  # specific force
        return w.astype(np.float32), a_b.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ImuNoiseModel:
    """Additive IMU corruption: white noise + constant bias + bias random
    walk. Continuous-time densities, discretized at the sample rate
    (sigma_d = sigma_c * sqrt(rate); walk step = walk_c * sqrt(dt))."""

    noise_gyro: float = 1.7e-4  # rad/s/sqrt(Hz)
    noise_acc: float = 2.0e-3  # m/s^2/sqrt(Hz)
    walk_gyro: float = 1.94e-5  # rad/s^2/sqrt(Hz)
    walk_acc: float = 3.0e-3  # m/s^3/sqrt(Hz)
    bg0: tuple = (0.003, -0.002, 0.004)  # constant gyro bias, rad/s
    ba0: tuple = (0.05, -0.03, 0.06)  # constant accel bias, m/s^2
    seed: int = 0

    @staticmethod
    def euroc() -> "ImuNoiseModel":
        """The reference's EuRoC noise operating point
        (Examples/Stereo-Inertial/Config/EuRoC.yaml:44-49)."""
        return ImuNoiseModel()


class _ImuCorruptor:
    """Stateful sampler: applies an ImuNoiseModel to ideal samples,
    integrating the bias random walk across calls (chronological)."""

    def __init__(self, model: ImuNoiseModel, rate_hz: float):
        self.m = model
        self.rng = np.random.default_rng(model.seed)
        self.sq_rate = math.sqrt(rate_hz)
        self.sq_dt = math.sqrt(1.0 / rate_hz)
        self.bg = np.asarray(model.bg0, np.float32).copy()
        self.ba = np.asarray(model.ba0, np.float32).copy()

    def __call__(self, gyro: np.ndarray, acc: np.ndarray):
        m = self.m
        g = gyro + self.bg + (m.noise_gyro * self.sq_rate) * self.rng.standard_normal(3)
        a = acc + self.ba + (m.noise_acc * self.sq_rate) * self.rng.standard_normal(3)
        self.bg = self.bg + (m.walk_gyro * self.sq_dt) * self.rng.standard_normal(3)
        self.ba = self.ba + (m.walk_acc * self.sq_dt) * self.rng.standard_normal(3)
        return g.astype(np.float32), a.astype(np.float32)


def make_sequence(
    cam: Camera,
    n_frames: int,
    fps: float = 20.0,
    traj: Trajectory | None = None,
    imu_rate: float = 200.0,
    room_half: float = ROOM_HALF,
    with_depth: bool = False,
    Tbc: np.ndarray | None = None,
    imu_noise: ImuNoiseModel | None = None,
):
    """Generator yielding per-frame dicts with stereo images, gt pose, imu batch.

    With `Tbc` (4x4 body->camera transform), `traj` describes the BODY
    (IMU) trajectory and the rendered camera rides at T_wc = T_wb * Tbc
    — the EuRoC rig geometry (the reference parses Tbc into IMU::Calib,
    src/Tracking.cc:761). IMU samples are always in the body frame.
    """
    traj = traj or Trajectory()
    baseline = float(cam.bf / cam.fx)
    render = jax.jit(partial(render_view, room_half=room_half))
    render_d = jax.jit(partial(render_depth, room_half=room_half)) if with_depth else None
    n_imu = int(round(imu_rate / fps))
    corrupt = _ImuCorruptor(imu_noise, imu_rate) if imu_noise is not None else None
    R_bc = np.eye(3, dtype=np.float32) if Tbc is None else np.asarray(Tbc, np.float32)[:3, :3]
    t_bc = np.zeros(3, np.float32) if Tbc is None else np.asarray(Tbc, np.float32)[:3, 3]
    for k in range(n_frames):
        t = k / fps
        R_wb, p_wb = traj.pose(t)
        R_wc = R_wb @ R_bc
        p_w = p_wb + R_wb @ t_bc
        R_wc_j = jnp.asarray(R_wc, jnp.float32)
        p_w_j = jnp.asarray(p_w, jnp.float32)
        # right camera displaced along camera +x
        p_r = p_w_j + R_wc_j[:, 0] * baseline
        img_l = render(cam, R_wc_j, p_w_j)
        img_r = render(cam, R_wc_j, p_r)
        # IMU samples covering (t_prev, t]
        stamps = t - (np.arange(n_imu)[::-1]) / imu_rate
        gyro = np.zeros((n_imu, 3), np.float32)
        acc = np.zeros((n_imu, 3), np.float32)
        for i, ts in enumerate(stamps):
            gyro[i], acc[i] = traj.imu_sample(max(ts, 0.0))
            if corrupt is not None:
                gyro[i], acc[i] = corrupt(gyro[i], acc[i])
        yield {
            "t": t,
            "img_l": img_l,
            "img_r": img_r,
            **({"depth": render_d(cam, R_wc_j, p_w_j)} if with_depth else {}),
            "R_wc": np.asarray(R_wc, np.float32),
            "p_w": np.asarray(p_w, np.float32),
            "v_w": traj.velocity(t).astype(np.float32),
            "imu_stamps": stamps.astype(np.float32),
            "imu_gyro": gyro,
            "imu_acc": acc,
        }


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray) -> float:
    """Absolute trajectory error after SE(3) (Umeyama, no scale) alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    H = E.T @ G
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    aligned = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
