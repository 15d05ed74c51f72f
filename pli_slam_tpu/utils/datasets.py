"""KITTI-odometry and TUM-RGBD dataset loaders.

JAX replacements for the reference's per-dataset CLI plumbing:
  - KITTI stereo: Examples/Stereo/stereo_kitti.cc (`LoadImages` reads
    times.txt + image_0/image_1 pairs).
  - TUM RGB-D: Examples/RGB-D/rgbd_tum.cc (`LoadImages` reads an
    association file of rgb/depth pairs; DepthMapFactor rescales the
    16-bit depth PNGs).

Both yield numpy float32 grayscale frames ready for the jitted frame
program; calibration is parsed from the dataset itself (KITTI calib.txt
P0/P1) or from the reference's canonical YAML values (TUM fr1/2/3).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pli_slam_tpu.utils.euroc import _read_png


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = img[..., :3] @ np.asarray([0.299, 0.587, 0.114], np.float32)
    return np.ascontiguousarray(img, dtype=np.float32)


# ---------------------------------------------------------------------------
# KITTI odometry (stereo)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KittiCalib:
    """Stereo calibration from a KITTI odometry `calib.txt`.

    P0/P1 are 3x4 rectified projection matrices; the stereo baseline is
    -P1[0,3]/fx (reference hardcodes the same numbers per sequence in
    Examples/Stereo/Config/KITTI*.yaml: Camera.fx/.../Camera.bf).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int = 1241
    height: int = 376

    @staticmethod
    def from_calib_txt(path: str) -> "KittiCalib":
        mats = {}
        with open(path) as f:
            for line in f:
                if ":" in line:
                    key, vals = line.split(":", 1)
                    mats[key.strip()] = np.fromstring(vals, sep=" ").reshape(3, 4)
        p0, p1 = mats["P0"], mats["P1"]
        fx = float(p0[0, 0])
        return KittiCalib(
            fx=fx, fy=float(p0[1, 1]), cx=float(p0[0, 2]), cy=float(p0[1, 2]),
            bf=float(-p1[0, 3]),  # P1[0,3] = -fx*baseline -> bf = fx*b
        )


class KittiSequence:
    """One KITTI odometry sequence directory
    (<root>/times.txt, image_0/, image_1/, calib.txt[, poses.txt])."""

    def __init__(self, root: str, poses_txt: str | None = None):
        self.root = root
        with open(os.path.join(root, "times.txt")) as f:
            self.stamps = np.asarray([float(s) for s in f.read().split()])
        self.left_dir = os.path.join(root, "image_0")
        self.right_dir = os.path.join(root, "image_1")
        self.calib = KittiCalib.from_calib_txt(os.path.join(root, "calib.txt"))
        self.gt = None
        poses_txt = poses_txt or os.path.join(root, "poses.txt")
        if os.path.exists(poses_txt):
            rows = np.loadtxt(poses_txt).reshape(-1, 3, 4)
            self.gt = rows[:, :, 3]  # camera positions [N,3]

    def __len__(self):
        return len(self.stamps)

    def frames(self, start: int = 0, stop: int | None = None):
        stop = len(self) if stop is None else min(stop, len(self))
        for i in range(start, stop):
            name = f"{i:06d}.png"
            img_l = _to_gray(_read_png(os.path.join(self.left_dir, name)))
            img_r = _to_gray(_read_png(os.path.join(self.right_dir, name)))
            if i == start:
                self.calib.height, self.calib.width = img_l.shape
            yield {"t": float(self.stamps[i]), "img_l": img_l, "img_r": img_r}

    def gt_positions_at(self, idx_or_stamps) -> np.ndarray | None:
        if self.gt is None:
            return None
        n = len(idx_or_stamps)
        return self.gt[:n]


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TumCalib:
    """TUM RGB-D intrinsics (reference Examples/RGB-D/Config/TUM*.yaml).

    freiburg1/2/3 defaults; DepthMapFactor 5000 converts the 16-bit
    depth PNG to meters (rgbd_tum.cc reads the same key)."""

    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    width: int = 640
    height: int = 480
    depth_factor: float = 5000.0
    # virtual stereo baseline for the depth->disparity conversion, the
    # reference's Camera.bf (TUM3.yaml: 40.0)
    bf: float = 40.0

    @staticmethod
    def freiburg(n: int) -> "TumCalib":
        if n == 1:
            return TumCalib(fx=517.3, fy=516.5, cx=318.6, cy=255.3)
        if n == 2:
            return TumCalib(fx=520.9, fy=521.0, cx=325.1, cy=249.7)
        return TumCalib()


def _read_stamped_list(path: str) -> list[tuple[float, str]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1]))
    return rows


def associate(rgb: list[tuple[float, str]], depth: list[tuple[float, str]],
              max_dt: float = 0.02) -> list[tuple[float, str, str]]:
    """Greedy nearest-timestamp association of rgb and depth lists —
    the offline associate.py step the reference requires before
    rgbd_tum.cc can run, done inline."""
    out = []
    j = 0
    for t, rgb_f in rgb:
        while j + 1 < len(depth) and abs(depth[j + 1][0] - t) <= abs(depth[j][0] - t):
            j += 1
        if abs(depth[j][0] - t) <= max_dt:
            out.append((t, rgb_f, depth[j][1]))
    return out


class TumRgbdSequence:
    """One TUM RGB-D sequence directory (<root>/rgb.txt, depth.txt,
    rgb/, depth/[, groundtruth.txt, associations.txt])."""

    def __init__(self, root: str, calib: TumCalib | None = None):
        self.root = root
        self.calib = calib or TumCalib()
        assoc_path = os.path.join(root, "associations.txt")
        if os.path.exists(assoc_path):
            self.assoc = []
            with open(assoc_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 4 and not line.startswith("#"):
                        self.assoc.append((float(parts[0]), parts[1], parts[3]))
        else:
            self.assoc = associate(
                _read_stamped_list(os.path.join(root, "rgb.txt")),
                _read_stamped_list(os.path.join(root, "depth.txt")),
            )
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt = None
        if os.path.exists(gt_path):
            rows = []
            with open(gt_path) as f:
                for line in f:
                    if line.strip() and not line.startswith("#"):
                        rows.append([float(v) for v in line.split()[:4]])
            self.gt = np.asarray(rows)  # [T,4]: t, x, y, z

    def __len__(self):
        return len(self.assoc)

    def frames(self, start: int = 0, stop: int | None = None):
        stop = len(self) if stop is None else min(stop, len(self))
        for i in range(start, stop):
            t, rgb_f, depth_f = self.assoc[i]
            img = _to_gray(_read_png(os.path.join(self.root, rgb_f)))
            depth_raw = _read_png(os.path.join(self.root, depth_f))
            depth = np.asarray(depth_raw, np.float32) / self.calib.depth_factor
            yield {"t": t, "img": img, "depth": depth}

    def gt_positions_at(self, stamps: list[float]) -> np.ndarray | None:
        if self.gt is None:
            return None
        idx = np.searchsorted(self.gt[:, 0], np.asarray(stamps))
        idx = np.clip(idx, 0, len(self.gt) - 1)
        return self.gt[idx, 1:4]
