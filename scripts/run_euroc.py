"""EuRoC replay driver (the reference's stereo_inertial_euroc equivalent).

Usage:
  python scripts/run_euroc.py <sequence_dir> [--mono-imu|--stereo|--stereo-imu]
      [--frames N] [--out DIR] [--native-loader]

Replays an ASL-format sequence through the System facade, writes
TUM/EuRoC trajectories, an ATE report against ground truth, and map/
trajectory visualizations. (reference:
Examples/Stereo-Inertial/stereo_inertial_euroc.cc)
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
    out_dir = "results"
    if "--out" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)

    from pli_slam_tpu.ops.camera import Camera
    from pli_slam_tpu.system import System
    from pli_slam_tpu.utils import viewer
    from pli_slam_tpu.utils.config import SlamConfig
    from pli_slam_tpu.utils.euroc import EurocCalib, EurocSequence

    sensor = "stereo_imu" if "--stereo-imu" in sys.argv else "stereo"
    if "--config" in sys.argv:
        # full config-driven setup from a reference-style YAML (camera,
        # rectification K/D/R/P, Tbc, IMU, ORB budgets) — reference:
        # src/Tracking.cc:144-770 parses the same file
        from pli_slam_tpu.utils.config import load_yaml_full

        yaml_path = sys.argv[sys.argv.index("--config") + 1]
        cfg, cam, rectifier = load_yaml_full(yaml_path)
        cfg = cfg.replace(sensor=sensor)
        if "--no-rectify" in sys.argv:
            rectifier = None
    else:
        cfg = SlamConfig.euroc_stereo_inertial() if sensor == "stereo_imu" else SlamConfig.euroc_stereo()
        calib = EurocCalib()
        cam = Camera.pinhole(
            fx=calib.fx, fy=calib.fy, cx=calib.cx, cy=calib.cy, bf=calib.bf,
            width=calib.width, height=calib.height,
        )
        from pli_slam_tpu.ops.rectify import euroc_rectifier

        rectifier = None if "--no-rectify" in sys.argv else euroc_rectifier()
    seq = EurocSequence(seq_dir)
    sysm = System(cam, cfg, rectifier=rectifier)
    sysm.tracker.streaming = True  # real-time replay: lag-1 stats readout
    print(f"sequence: {len(seq)} frames; running {n_frames or len(seq)}")

    from pli_slam_tpu.utils.log import StageTimer

    # frame source: native C++ prefetch pool decodes PNGs ahead of the
    # tracker (utils/native_loader.py) when requested and available
    if "--native-loader" in sys.argv:
        frame_iter = seq.frames_native(stop=n_frames)
    else:
        frame_iter = seq.frames(stop=n_frames)

    timer = StageTimer(["ingest", "track"])  # SAVE_TIMES-style CSV
    stamps = []
    t0 = time.time()
    i = 0
    while True:
        with timer.stage("ingest"):
            fr = next(frame_iter, None)
        if fr is None:
            break
        imu = None
        if sensor == "stereo_imu":
            imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
        with timer.stage("track"):
            info = sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"], imu_batch=imu)
        timer.end_frame()
        stamps.append(fr["t"])
        if i % 50 == 0:
            print(f"frame {i:5d} {info['state']:>15s} inliers={info['n_inliers']:4d} "
                  f"kf={info['n_kf']:4d}", flush=True)
        i += 1
    elapsed = time.time() - t0
    print(f"done: {len(stamps)} frames in {elapsed:.1f}s ({len(stamps)/elapsed:.1f} fps)")
    timer.save_csv(os.path.join(out_dir, "track_times.csv"))
    print("per-stage ms (mean):", {k: round(v, 2) for k, v in timer.means_ms().items()})

    sysm.save_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"))
    sysm.save_trajectory_euroc(os.path.join(out_dir, "trajectory_euroc.csv"))
    sysm.save_keyframe_trajectory_tum(os.path.join(out_dir, "keyframes_tum.txt"))
    viewer.draw_map(sysm.tracker, os.path.join(out_dir, "map.png"))

    gt = seq.gt_positions_at(stamps)
    if gt is not None:
        from pli_slam_tpu.utils.trajectory import ate_rmse

        est = sysm.tracker.positions()
        ate = ate_rmse(est, gt)
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
        viewer.draw_trajectory_comparison(est, gt, os.path.join(out_dir, "trajectory.png"), ate)
        with open(os.path.join(out_dir, "ate.txt"), "w") as f:
            f.write(f"{ate:.6f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
