"""TUM RGB-D replay driver (the reference's rgbd_tum equivalent).

Usage:
  python scripts/run_tum.py <sequence_dir> [--frames N] [--out DIR]
      [--freiburg 1|2|3]

Replays a TUM RGB-D sequence (rgb.txt/depth.txt associated inline, or a
pre-built associations.txt) through the System facade's RGB-D path,
writes a TUM-format trajectory + ATE report.
(reference: Examples/RGB-D/rgbd_tum.cc; association per the dataset's
associate.py protocol)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pli_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args:
        print(__doc__)
        return 1
    seq_dir = args[0]
    n_frames = None
    if "--frames" in sys.argv:
        n_frames = int(sys.argv[sys.argv.index("--frames") + 1])
    out_dir = "results_tum"
    if "--out" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)

    from pli_slam_tpu.ops.camera import Camera
    from pli_slam_tpu.system import System
    from pli_slam_tpu.utils import viewer
    from pli_slam_tpu.utils.config import SlamConfig
    from pli_slam_tpu.utils.datasets import TumCalib, TumRgbdSequence

    fr_n = 3
    if "--freiburg" in sys.argv:
        fr_n = int(sys.argv[sys.argv.index("--freiburg") + 1])
    calib = TumCalib.freiburg(fr_n)
    seq = TumRgbdSequence(seq_dir, calib)
    cam = Camera.pinhole(
        fx=calib.fx, fy=calib.fy, cx=calib.cx, cy=calib.cy, bf=calib.bf,
        width=calib.width, height=calib.height,
    )
    cfg = SlamConfig(sensor="rgbd", width=calib.width, height=calib.height, fps=30.0)
    sysm = System(cam, cfg)
    sysm.tracker.streaming = True
    print(f"sequence: {len(seq)} associated frames; running {n_frames or len(seq)}")

    stamps = []
    t0 = time.time()
    for i, fr in enumerate(seq.frames(stop=n_frames)):
        info = sysm.track_rgbd(fr["img"], fr["depth"], fr["t"])
        stamps.append(fr["t"])
        if i % 50 == 0:
            print(f"frame {i:5d} {info['state']:>15s} inliers={info['n_inliers']:4d} "
                  f"kf={info['n_kf']:4d}", flush=True)
    elapsed = time.time() - t0
    print(f"done: {len(stamps)} frames in {elapsed:.1f}s ({len(stamps)/elapsed:.1f} fps)")

    sysm.save_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"))
    sysm.save_keyframe_trajectory_tum(os.path.join(out_dir, "keyframes_tum.txt"))
    viewer.draw_map(sysm.tracker, os.path.join(out_dir, "map.png"))

    gt = seq.gt_positions_at(stamps)
    if gt is not None:
        from pli_slam_tpu.utils.trajectory import ate_rmse

        est = sysm.tracker.positions()
        ate = ate_rmse(est, gt)
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
        viewer.draw_trajectory_comparison(est, gt, os.path.join(out_dir, "trajectory.png"), ate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
