"""EuRoC MAV dataset loader: stereo images + IMU + ground truth.

JAX replacement for the reference's per-dataset CLI plumbing
(reference: Examples/Stereo-Inertial/stereo_inertial_euroc.cc —
`LoadImages` :124, `LoadIMU` :142, rectification-map setup from the
YAML in `Tracking::ParseCamParamFile`, src/Tracking.cc:144-258).

Layout expected (standard ASL): <root>/mav0/cam0/data/*.png,
cam1/data/*.png, cam0/data.csv, imu0/data.csv,
state_groundtruth_estimate0/data.csv.

This loader yields RAW (distorted) images; pass
`ops.rectify.euroc_rectifier()` to the System/Tracker so the bilinear
undistort+rectify remap runs on device inside the frame program
(equivalent of the reference's cv::initUndistortRectifyMap + remap at
ingestion — see ops/rectify.py and tests/test_rectify.py).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from functools import partial

import numpy as np

try:
    from PIL import Image  # pillow ships with the baked environment

    def _read_png(path: str) -> np.ndarray:
        return np.asarray(Image.open(path), dtype=np.float32)

except Exception:  # pragma: no cover - fallback without pillow
    def _read_png(path: str) -> np.ndarray:
        raise RuntimeError("No PNG reader available (pillow missing)")


@dataclasses.dataclass
class EurocCalib:
    """Rectified stereo calibration (the reference's EuRoC.yaml:6-23,55-104)."""

    fx: float = 435.2046959714599
    fy: float = 435.2046959714599
    cx: float = 367.4517211914062
    cy: float = 252.2008514404297
    bf: float = 47.90639384423901
    width: int = 752
    height: int = 480


class EurocSequence:
    def __init__(self, root: str):
        self.root = root
        mav = os.path.join(root, "mav0")
        self.cam0_dir = os.path.join(mav, "cam0", "data")
        self.cam1_dir = os.path.join(mav, "cam1", "data")
        self.stamps = sorted(
            int(f.split(".")[0]) for f in os.listdir(self.cam0_dir) if f.endswith(".png")
        )
        self.imu = self._load_imu(os.path.join(mav, "imu0", "data.csv"))
        gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        self.gt = self._load_gt(gt_csv) if os.path.exists(gt_csv) else None

    @staticmethod
    def _load_imu(path: str) -> np.ndarray:
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#"):
                    rows.append([float(v) for v in row])
        return np.asarray(rows)  # [T, 7]: ns, gx, gy, gz, ax, ay, az

    @staticmethod
    def _load_gt(path: str) -> np.ndarray:
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#"):
                    rows.append([float(v) for v in row[:8]])
        return np.asarray(rows)  # [T, 8]: ns, px, py, pz, qw, qx, qy, qz

    def __len__(self):
        return len(self.stamps)

    def frames(self, start: int = 0, stop: int | None = None):
        """Yield per-frame dicts matching utils.synthetic.make_sequence."""
        stop = len(self.stamps) if stop is None else stop
        prev_ns = None
        for ns in self.stamps[start:stop]:
            t = ns * 1e-9
            img_l = _read_png(os.path.join(self.cam0_dir, f"{ns}.png"))
            img_r = _read_png(os.path.join(self.cam1_dir, f"{ns}.png"))
            if prev_ns is None:
                imu_batch = np.zeros((0, 7))
            else:
                m = (self.imu[:, 0] > prev_ns) & (self.imu[:, 0] <= ns)
                imu_batch = self.imu[m]
            prev_ns = ns
            yield {
                "t": t,
                "img_l": img_l,
                "img_r": img_r,
                "imu_stamps": imu_batch[:, 0] * 1e-9,
                "imu_gyro": imu_batch[:, 1:4].astype(np.float32),
                "imu_acc": imu_batch[:, 4:7].astype(np.float32),
            }

    def frames_native(self, start: int = 0, stop: int | None = None, n_workers: int = 2):
        """Same stream as `frames()` but decoded by the native C++
        prefetch pool (native/dataloader.cpp) — PNG decode overlaps
        tracking like the reference's ingest on the tracking thread.
        Falls back to the pure-Python path when the toolchain is absent.
        """
        from pli_slam_tpu.utils import native_loader

        stop = len(self.stamps) if stop is None else stop
        if not native_loader.available():
            yield from self.frames(start, stop)
            return
        stamps = self.stamps[start:stop]
        lp = [os.path.join(self.cam0_dir, f"{ns}.png") for ns in stamps]
        rp = [os.path.join(self.cam1_dir, f"{ns}.png") for ns in stamps]
        probe = _read_png(lp[0])
        h, w = probe.shape[:2]
        pre = native_loader.StereoPrefetcher(lp, rp, w, h, n_workers=n_workers)
        try:
            prev_ns = None
            for ns, (img_l, img_r) in zip(stamps, pre):
                if prev_ns is None:
                    imu_batch = np.zeros((0, 7))
                else:
                    m = (self.imu[:, 0] > prev_ns) & (self.imu[:, 0] <= ns)
                    imu_batch = self.imu[m]
                prev_ns = ns
                yield {
                    "t": ns * 1e-9,
                    "img_l": img_l,
                    "img_r": img_r,
                    "imu_stamps": imu_batch[:, 0] * 1e-9,
                    "imu_gyro": imu_batch[:, 1:4].astype(np.float32),
                    "imu_acc": imu_batch[:, 4:7].astype(np.float32),
                }
        finally:
            pre.close()

    def gt_positions_at(self, stamps_sec: list[float]) -> np.ndarray | None:
        """Interpolate ground-truth positions at the given timestamps."""
        if self.gt is None:
            return None
        gt_t = self.gt[:, 0] * 1e-9
        out = np.stack(
            [np.interp(stamps_sec, gt_t, self.gt[:, i]) for i in (1, 2, 3)], axis=-1
        )
        return out
