"""Live stereo-inertial driver: asynchronous sensor feed -> tracker.

ROS-analog entry point (reference:
Examples/ROS/PLI_SLAM2/src/ros_stereo_inertial.cc). Sensor messages
arrive asynchronously on producer threads (here: a replay thread
pushing an EuRoC sequence at wall-clock rate, standing in for ROS
subscriptions or a socket); `StereoInertialSync` pairs them and the
tracking loop consumes synchronized frames.

Usage:
  python scripts/run_live.py <euroc_sequence_dir> [--frames N] [--rate HZ]
"""

import os
import sys
import threading
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
    rate = 20.0
    if "--rate" in sys.argv:
        rate = float(sys.argv[sys.argv.index("--rate") + 1])

    from pli_slam_tpu.ops.camera import Camera
    from pli_slam_tpu.ops.rectify import euroc_rectifier
    from pli_slam_tpu.system import System
    from pli_slam_tpu.utils.config import SlamConfig
    from pli_slam_tpu.utils.euroc import EurocCalib, EurocSequence
    from pli_slam_tpu.utils.livefeed import StereoInertialSync

    calib = EurocCalib()
    cam = Camera.pinhole(fx=calib.fx, fy=calib.fy, cx=calib.cx, cy=calib.cy,
                         bf=calib.bf, width=calib.width, height=calib.height)
    cfg = SlamConfig.euroc_stereo_inertial()
    sysm = System(cam, cfg, rectifier=euroc_rectifier())
    sysm.tracker.streaming = True
    sync = StereoInertialSync(use_imu=True)

    seq = EurocSequence(seq_dir)

    def producer():
        """Replay thread standing in for the ROS subscribers: pushes
        images and IMU at wall-clock rate."""
        for i, fr in enumerate(seq.frames(stop=n_frames)):
            for s, g, a in zip(fr["imu_stamps"], fr["imu_gyro"], fr["imu_acc"]):
                sync.imu.push(s, g, a)
            sync.left.push(fr["t"], fr["img_l"])
            sync.right.push(fr["t"], fr["img_r"])
            time.sleep(1.0 / rate)
        sync.stop()

    threading.Thread(target=producer, daemon=True).start()

    n, t0 = 0, time.time()
    while True:
        item = sync.next_frame(timeout=2.0)
        if item is None:
            break
        info = sysm.track_stereo(item["img_l"], item["img_r"], item["t"],
                                 imu_batch=item["imu"])
        n += 1
        if n % 50 == 0:
            print(f"frame {n:5d} {info['state']:>15s} kf={info['n_kf']:4d}", flush=True)
    elapsed = time.time() - t0
    print(f"live run done: {n} frames in {elapsed:.1f}s ({n/max(elapsed,1e-9):.1f} fps)")
    sysm.save_trajectory_tum("trajectory_live_tum.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
