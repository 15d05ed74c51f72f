"""KITTI odometry replay driver (the reference's stereo_kitti equivalent).

Usage:
  python scripts/run_kitti.py <sequence_dir> [--frames N] [--out DIR]
      [--poses poses.txt] [--no-lines]

Replays a KITTI odometry sequence (times.txt + image_0/image_1 +
calib.txt) through the System facade at the reference's KITTI operating
point (2000 ORB features — Examples/Stereo/Config/KITTI00-02.yaml),
writes a KITTI-format trajectory + ATE report.
(reference: Examples/Stereo/stereo_kitti.cc)
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
    out_dir = "results_kitti"
    if "--out" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)

    from pli_slam_tpu.ops.camera import Camera
    from pli_slam_tpu.system import System
    from pli_slam_tpu.utils import viewer
    from pli_slam_tpu.utils.config import OrbConfig, SlamConfig
    from pli_slam_tpu.utils.datasets import KittiSequence

    poses = None
    if "--poses" in sys.argv:
        poses = sys.argv[sys.argv.index("--poses") + 1]
    seq = KittiSequence(seq_dir, poses_txt=poses)
    c = seq.calib
    # peek the first image for the true raster size (sequences differ: 1241/1226 wide)
    first = next(seq.frames(stop=1))
    h, w = first["img_l"].shape
    cam = Camera.pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf, width=w, height=h)
    # KITTI operating point: 2000 ORB (KITTI00-02.yaml), 10 fps camera
    cfg = SlamConfig(
        sensor="stereo", width=w, height=h, fps=10.0,
        orb=OrbConfig(n_features=2000),
        use_lines="--no-lines" not in sys.argv,
    )
    sysm = System(cam, cfg)
    sysm.tracker.streaming = True
    print(f"sequence: {len(seq)} frames at {w}x{h}; running {n_frames or len(seq)}")

    stamps = []
    t0 = time.time()
    for i, fr in enumerate(seq.frames(stop=n_frames)):
        info = sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"])
        stamps.append(fr["t"])
        if i % 50 == 0:
            print(f"frame {i:5d} {info['state']:>15s} inliers={info['n_inliers']:4d} "
                  f"kf={info['n_kf']:4d}", flush=True)
    elapsed = time.time() - t0
    print(f"done: {len(stamps)} frames in {elapsed:.1f}s ({len(stamps)/elapsed:.1f} fps)")

    sysm.save_trajectory_kitti(os.path.join(out_dir, "trajectory_kitti.txt"))
    sysm.save_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"))
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
