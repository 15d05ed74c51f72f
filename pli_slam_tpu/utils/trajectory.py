"""Trajectory writers and error metrics (TUM / EuRoC / KITTI formats).

JAX replacement for the reference's trajectory savers
(reference: src/System.cc — `SaveTrajectoryTUM` :409,
`SaveTrajectoryEuRoC` :502, `SaveKeyFrameTrajectoryEuRoC` :602,
`SaveTrajectoryKITTI` :654) plus the external evo-style ATE/RPE
evaluation the reference relies on (SURVEY.md §4 item 1).

Poses are (stamp_seconds, R_wc [3,3], p_w [3]) — camera-to-world.
"""

from __future__ import annotations

import numpy as np


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from pli_slam_tpu.ops import lie

    return np.asarray(lie.quat_from_rotation(jnp.asarray(R, jnp.float32)))


def save_tum(path: str, traj: list[tuple[float, np.ndarray, np.ndarray]]) -> None:
    """TUM format: `stamp tx ty tz qx qy qz qw` (reference SaveTrajectoryTUM)."""
    with open(path, "w") as f:
        for stamp, R, p in traj:
            w, x, y, z = _quat_wxyz(R)
            f.write(f"{stamp:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} {x:.7f} {y:.7f} {z:.7f} {w:.7f}\n")


def save_euroc(path: str, traj: list[tuple[float, np.ndarray, np.ndarray]]) -> None:
    """EuRoC format: `stamp_ns, tx, ty, tz, qw, qx, qy, qz` (SaveTrajectoryEuRoC)."""
    with open(path, "w") as f:
        for stamp, R, p in traj:
            w, x, y, z = _quat_wxyz(R)
            f.write(
                f"{int(stamp*1e9)},{p[0]:.7f},{p[1]:.7f},{p[2]:.7f},{w:.7f},{x:.7f},{y:.7f},{z:.7f}\n"
            )


def save_kitti(path: str, traj: list[tuple[float, np.ndarray, np.ndarray]]) -> None:
    """KITTI format: 12 numbers per row, row-major [R|t] (SaveTrajectoryKITTI)."""
    with open(path, "w") as f:
        for _, R, p in traj:
            T = np.hstack([R, p.reshape(3, 1)])
            f.write(" ".join(f"{v:.9e}" for v in T.reshape(-1)) + "\n")


def load_tum(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    import jax.numpy as jnp

    from pli_slam_tpu.ops import lie

    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            stamp, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            R = np.asarray(lie.rotation_from_quat(jnp.asarray([qw, qx, qy, qz], jnp.float32)))
            out.append((stamp, R, np.array([tx, ty, tz])))
    return out


def load_euroc(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    """Parse the EuRoC CSV format written by save_euroc (round-trip)."""
    import jax.numpy as jnp

    from pli_slam_tpu.ops import lie

    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(v) for v in line.split(",")]
            stamp_ns, tx, ty, tz, qw, qx, qy, qz = vals[:8]
            R = np.asarray(lie.rotation_from_quat(jnp.asarray([qw, qx, qy, qz], jnp.float32)))
            out.append((stamp_ns * 1e-9, R, np.array([tx, ty, tz])))
    return out


def load_kitti(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    """Parse the KITTI 12-number [R|t] format (stamps are row indices)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            T = np.array([float(v) for v in line.split()]).reshape(3, 4)
            out.append((float(i), T[:, :3].copy(), T[:, 3].copy()))
    return out


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """SE(3)/Sim(3) alignment est->gt. Returns (s, R, t)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    s = float((D * np.diag(S)).sum() / (E ** 2).sum()) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> float:
    s, R, t = align_umeyama(est, gt, with_scale)
    aligned = s * est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def rpe_rmse(
    est_traj: list[tuple[float, np.ndarray, np.ndarray]],
    gt_traj: list[tuple[float, np.ndarray, np.ndarray]],
    delta: int = 1,
) -> tuple[float, float]:
    """Relative pose error over index offset `delta`: (trans_rmse, rot_rmse_deg)."""
    terrs, rerrs = [], []
    n = min(len(est_traj), len(gt_traj))
    for i in range(n - delta):
        _, Re0, pe0 = est_traj[i]
        _, Re1, pe1 = est_traj[i + delta]
        _, Rg0, pg0 = gt_traj[i]
        _, Rg1, pg1 = gt_traj[i + delta]
        d_est_t = Re0.T @ (pe1 - pe0)
        d_gt_t = Rg0.T @ (pg1 - pg0)
        terrs.append(np.linalg.norm(d_est_t - d_gt_t))
        dR = (Rg0.T @ Rg1).T @ (Re0.T @ Re1)
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        rerrs.append(np.degrees(ang))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))
