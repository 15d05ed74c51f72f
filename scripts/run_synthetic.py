"""End-to-end synthetic run: SLAM over a rendered sequence, report ATE.

Usage: python scripts/run_synthetic.py [n_frames] [--tiny] [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

from pli_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from pli_slam_tpu.frontend.tracker import Tracker
from pli_slam_tpu.ops.camera import Camera
from pli_slam_tpu.utils import synthetic
from pli_slam_tpu.utils.config import SlamConfig


def main():
    n_frames = 40
    for a in sys.argv[1:]:
        if a.isdigit():
            n_frames = int(a)
    tiny = "--tiny" in sys.argv
    if tiny:
        cfg = SlamConfig.tiny_test()
        cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
        traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
        room_half = 2.55  # small room: keeps stereo disparities useful for the tiny camera
    else:
        cfg = SlamConfig.euroc_stereo()
        cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
        traj = synthetic.Trajectory()
        room_half = synthetic.ROOM_HALF

    tracker = Tracker(cam, cfg)
    gt = []
    t_start = time.time()
    times = []
    for i, fr in enumerate(synthetic.make_sequence(cam, n_frames, fps=cfg.fps, traj=traj, room_half=room_half)):
        t0 = time.time()
        info = tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        dt = time.time() - t0
        times.append(dt)
        gt.append(fr["p_w"])
        if i % 10 == 0 or i == n_frames - 1:
            print(f"frame {i:4d} {info['state']:>15s} inliers={info['n_inliers']:4d} "
                  f"kf={info['n_kf']:3d} pts={info['n_points']:5d} lines={info['n_lines']:4d} {dt*1e3:7.1f}ms",
                  flush=True)
    gt = np.stack(gt)
    est = tracker.positions()
    ate = synthetic.ate_rmse(est, gt)
    steady = np.median(times[5:]) if len(times) > 10 else np.median(times)
    print(f"\nATE RMSE: {ate:.4f} m over {n_frames} frames "
          f"({np.linalg.norm(np.diff(gt, axis=0), axis=1).sum():.2f} m path)")
    print(f"median frame time: {steady*1e3:.1f} ms ({1.0/steady:.1f} fps), total {time.time()-t_start:.1f}s")
    return ate


if __name__ == "__main__":
    main()
