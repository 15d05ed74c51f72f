"""Streaming (lag-1 stats readout) mode must be value-identical to sync.

Streaming is the mode bench.py and run_euroc.py use — the host reads the
previous frame's stats so the sync latency overlaps device compute. The device chain (poses, stores, keyframe decisions) must not
depend on the readout mode; round 2 violated this (has_vel was derived
from the lagged stats instead of chained on device) and paid 3.5x ATE.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from pli_slam_tpu.frontend.tracker import Tracker
from pli_slam_tpu.ops.camera import Camera
from pli_slam_tpu.utils import synthetic
from pli_slam_tpu.utils.config import SlamConfig


def _run(streaming: bool):
    cfg = SlamConfig.tiny_test()
    cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    tracker = Tracker(cam, cfg)
    tracker.streaming = streaming
    for fr in synthetic.make_sequence(cam, 18, fps=cfg.fps, traj=traj, room_half=2.55):
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    return tracker


def test_streaming_matches_sync():
    tr_s = _run(True)
    tr_y = _run(False)
    assert int(tr_s.n_kf) == int(tr_y.n_kf)
    np.testing.assert_allclose(tr_s.positions(), tr_y.positions(), atol=1e-5)
    # stats lag by one frame in streaming; the same keyframes must exist
    np.testing.assert_array_equal(
        np.asarray(tr_s.kstore.valid), np.asarray(tr_y.kstore.valid)
    )
