"""Benchmark: FLAGSHIP stereo-inertial point-line SLAM throughput on one chip.

The headline metric is the north-star configuration (BASELINE.md config
#4): full stereo-inertial point+line tracking with Atlas/loop-closing
enabled, EuRoC operating point (752x480 stereo, 1200 ORB x 8 levels,
line budget, 200 Hz IMU with EuRoC-level noise + bias + walk), on a
loop-rich >=200-frame synthetic trajectory whose revisit triggers a
REAL loop closure inside the measured window (the reference's real-time
contract: Examples/Stereo-Inertial/stereo_inertial_euroc.cc:242-249,
20 fps frame period).

Reported: mean fps, p99 frame ms (what the 50 ms real-time budget
actually constrains), ATE, loops closed — plus the visual-only tracking
number of previous rounds as `extra`.

Runs on one GPU and exits non-zero on any other platform. Prints ONE
JSON line:
  {"metric": "stereo_inertial_tracking_fps_752x480", "value": <fps>,
   "unit": "fps", "vs_baseline": <fps / 20.0>, "extra": {...}}

vs_baseline > 1 means faster than the reference's 20 fps real-time gate
(the reference holds 20 fps on CPU by construction — BASELINE.md).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from pli_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_cam():
    from pli_slam_tpu.ops.camera import Camera

    return Camera.pinhole(
        fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480
    )


def reset_tracker_for_measurement(tracker, cfg):
    """Wipe all run state but keep the instance's compiled callables."""
    import jax.numpy as jnp

    from pli_slam_tpu.worldmap.atlas import Atlas

    tracker.reset_active_map()
    tracker.atlas = Atlas(cfg)
    tracker._traj_pending.clear()
    tracker._traj_done.clear()
    tracker.stats.clear()
    tracker._prev_stamp = None
    tracker._lost_frames = 0
    tracker.R = jnp.eye(3)
    tracker.t = jnp.zeros(3)
    tracker.R_prev = jnp.eye(3)
    tracker.t_prev = jnp.zeros(3)
    tracker.vel_xi = jnp.zeros(6)
    tracker.has_vel = False
    tracker._pending_stats = None
    from pli_slam_tpu.frontend.tracker import TrackingState

    tracker.state = TrackingState.NOT_INITIALIZED


def flagship_setup():
    """The flagship deployment: (cfg, cam, trajectory) of stereo-inertial
    tracking at the EuRoC operating point on a revisiting path."""
    from pli_slam_tpu.utils import synthetic
    from pli_slam_tpu.utils.config import SlamConfig

    cfg = SlamConfig.euroc_stereo_inertial()
    cfg = dataclasses.replace(
        cfg,
        imu=dataclasses.replace(cfg.imu, init_time_sec=1.5, max_samples_per_frame=16),
        # tighter per-KF creation budget for the long run: ~40 KFs at the
        # default budget fill the 16k point store and matching degrades
        tracking=dataclasses.replace(cfg.tracking, kf_max_new_points=256),
    )
    cam = make_cam()
    # period-7s Lissajous: the camera re-enters its starting viewpoint
    # every 140 frames, so a >=200-frame run revisits mapped space and
    # the BoW+Sim3 pipeline closes a real loop inside the timed window.
    # Amplitudes give ~0.9 m/s peak speed — the EuRoC MAV envelope
    # (MH ~0.45 m/s mean, V2_03 ~0.75).
    traj = synthetic.Trajectory(
        amp=(1.0, 0.5, 0.3), freq=(1 / 7, 2 / 7, 3 / 7),
        yaw_amp=0.4, yaw_freq=1 / 7,
    )
    return cfg, cam, traj


def run_flagship(n_frames):
    """Stereo-inertial + loop closure on a periodic (revisiting) path."""
    from pli_slam_tpu.frontend.tracker import Tracker
    from pli_slam_tpu.utils import synthetic

    cfg, cam, traj = flagship_setup()
    log(f"bench[flagship]: rendering {n_frames} frames")
    frames = []
    for fr in synthetic.make_sequence(
        cam, n_frames, fps=cfg.fps, traj=traj,
        imu_noise=synthetic.ImuNoiseModel.euroc(),
    ):
        frames.append(
            (fr["img_l"], fr["img_r"], fr["t"], fr["p_w"],
             {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]})
        )
    jax.block_until_ready(frames[-1][0])
    log("bench[flagship]: rendering done; warmup/compile")

    # PASS 1 — compile warmup over the FULL sequence: the sequence
    # deterministically triggers every program variant it will need
    # (pre-init host path, fused VI step with/without KF branch, IMU
    # init, VI window BA, loop detection/closure, amortized GBA chunks),
    # so nothing compiles inside the measured pass; a fixed-count warmup
    # prefix cannot cover late variants like loop closure.
    warm_tracker = Tracker(cam, cfg)
    warm_tracker.streaming = True
    for i, (img_l, img_r, t, _, imu) in enumerate(frames):
        warm_tracker.process(img_l, img_r, t, imu=imu)
        if i % 40 == 0:
            log(f"bench[flagship]: warm pass frame {i}")
    warm_tracker.finalize()
    warm_tracker.positions()
    log(f"bench[flagship]: warm pass done (imu_ready={warm_tracker.imu_ready}, "
        f"loops={warm_tracker.loop_closer.n_loops_closed if warm_tracker.loop_closer else 0}); measuring")

    # PASS 2 — SAME tracker object with its state wiped: a fresh Tracker
    # would create fresh jax.jit wrappers whose first calls pay a
    # persistent-cache load per program inside the measured pass;
    # reusing the instance keeps every in-process compiled callable hot.
    tracker = warm_tracker
    reset_tracker_for_measurement(tracker, cfg)
    tracker.streaming = True
    n_warm = 3  # buffer-allocation jitter only
    for img_l, img_r, t, _, imu in frames[:n_warm]:
        tracker.process(img_l, img_r, t, imu=imu)
    times = []
    t0 = time.time()
    for i, (img_l, img_r, t, _, imu) in enumerate(frames[n_warm:]):
        f0 = time.perf_counter()
        tracker.process(img_l, img_r, t, imu=imu)
        times.append(time.perf_counter() - f0)
        if i % 40 == 0:
            log(f"bench[flagship]: frame {i}")
    tracker.finalize()  # drain amortized GBA chunks inside the timed region
    tracker.positions()
    elapsed = time.time() - t0
    fps = (n_frames - n_warm) / elapsed

    gt = np.stack([p for _, _, _, p, _ in frames])
    est = tracker.positions()
    ate = synthetic.ate_rmse(est, gt)
    times_ms = np.asarray(times) * 1e3
    return {
        "fps": round(fps, 2),
        "p99_ms": round(float(np.percentile(times_ms, 99)), 1),
        "p50_ms": round(float(np.percentile(times_ms, 50)), 1),
        "worst_ms": round(float(times_ms.max()), 1),
        "ate_m": round(float(ate), 4),
        "loops_closed": int(tracker.loop_closer.n_loops_closed)
        if tracker.loop_closer else 0,
        "imu_ready": bool(tracker.imu_ready),
        "n_keyframes": int(tracker.n_kf),
        "n_points": int(tracker.pstore.valid.sum()),
        "n_lines": int(tracker.lstore.valid.sum()),
        "frames": n_frames,
    }


def run_visual(n_frames):
    """The previous rounds' visual-only bench (kept as `extra`)."""
    from pli_slam_tpu.frontend.tracker import Tracker
    from pli_slam_tpu.utils import synthetic
    from pli_slam_tpu.utils.config import SlamConfig

    cfg = SlamConfig.euroc_stereo()
    cam = make_cam()
    log(f"bench[visual]: rendering {n_frames} frames")
    frames = []
    for fr in synthetic.make_sequence(cam, n_frames, fps=cfg.fps):
        frames.append((fr["img_l"], fr["img_r"], fr["t"], fr["p_w"]))
    jax.block_until_ready(frames[-1][0])
    log("bench[visual]: rendering done; warmup/compile")

    n_warm = min(12, n_frames // 3)
    tracker = Tracker(cam, cfg)
    tracker.streaming = True
    for img_l, img_r, t, _ in frames[:n_warm]:
        tracker.process(img_l, img_r, t)
    tracker.positions()
    log("bench[visual]: warmup done; measuring")

    t0 = time.time()
    for i, (img_l, img_r, t, _) in enumerate(frames[n_warm:]):
        tracker.process(img_l, img_r, t)
    tracker.finalize()
    tracker.positions()
    elapsed = time.time() - t0
    fps = (n_frames - n_warm) / elapsed

    gt = np.stack([p for _, _, _, p in frames])
    ate = synthetic.ate_rmse(tracker.positions(), gt)
    return {"fps": round(fps, 2), "ate_m": round(float(ate), 4)}


def main():
    from pli_slam_tpu.utils.device import card_label, require_gpu

    try:
        dev = require_gpu()[0]
        card = card_label()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        log(f"bench: refusing to measure: {e}")
        return 1
    log(f"bench: device {dev.platform} / {dev.device_kind} x{len(jax.devices())}; card: {card}")
    n_flag = int(os.environ.get("BENCH_FRAMES", "220"))
    n_vis = int(os.environ.get("BENCH_FRAMES_VISUAL", "40"))
    flag = run_flagship(n_flag)
    vis = run_visual(n_vis)
    result = {
        "metric": "stereo_inertial_tracking_fps_752x480",
        "value": flag["fps"],
        "unit": "fps",
        "vs_baseline": round(flag["fps"] / 20.0, 3),
        "extra": {
            "p99_ms": flag["p99_ms"],
            "p50_ms": flag["p50_ms"],
            "worst_ms": flag["worst_ms"],
            "ate_m_synthetic": flag["ate_m"],
            "loops_closed": flag["loops_closed"],
            "imu_ready": flag["imu_ready"],
            "frames": flag["frames"],
            "n_keyframes": flag["n_keyframes"],
            "n_points": flag["n_points"],
            "n_lines": flag["n_lines"],
            "visual_fps": vis["fps"],
            "visual_ate_m": vis["ate_m"],
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
