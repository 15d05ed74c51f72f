"""System facade: the top-level API of the framework.

JAX replacement for `ORB_SLAM3::System` (reference:
src/System.cc — ctor :41-153, `TrackStereo` :155, `TrackMonocular`,
`ActivateLocalizationMode` :334, `Reset/ResetActiveMap` :362-377,
`Shutdown` :379, `SaveTrajectoryTUM/EuRoC/KITTI` :409/:502/:654) and of
the map persistence layer (`Map::Save/Load`, src/Map.cc:233-565, and the
boost-serialization PreSave/PostLoad — here the struct-of-arrays stores
serialize losslessly with a single `np.savez`, SURVEY.md Phase 9).

No threads are spawned: tracking, local mapping, and loop closing run
as device programs inside `track_stereo` (deterministic by
construction — same inputs, same trajectory).
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu.ops.camera import Camera
from pli_slam_tpu.utils import trajectory as tio
from pli_slam_tpu.utils.config import SlamConfig


class System:
    SENSORS = ("stereo", "stereo_imu", "mono", "mono_imu", "rgbd")

    def __init__(self, cam: Camera, cfg: SlamConfig | None = None, rectifier=None):
        """`rectifier`: optional ops.rectify.StereoRectifier; raw distorted
        stereo pairs are rectified on device inside the frame program
        (reference: Tracking::ParseCamParamFile rectification-map setup,
        src/Tracking.cc:144-258)."""
        self.cfg = cfg or SlamConfig.euroc_stereo()
        if self.cfg.sensor not in self.SENSORS:
            raise ValueError(f"unknown sensor {self.cfg.sensor}")
        self.cam = cam
        self.rectifier = rectifier
        self.tracker = Tracker(cam, self.cfg, rectifier=rectifier)
        self.localization_only = False
        self._frame_times: list[float] = []

    # -- tracking entry points (reference System::Track*) -----------------
    def track_stereo(self, img_l, img_r, stamp: float, imu_batch=None) -> dict:
        """Process one stereo frame (+ optional IMU batch since last frame).

        Returns a per-frame info dict including the current pose estimate.
        """
        t0 = time.time()
        info = self.tracker.process(
            img_l, img_r, stamp,
            allow_mapping=not self.localization_only, imu=imu_batch,
        )
        self._frame_times.append(time.time() - t0)
        return self._with_pose(info)

    def track_rgbd(self, img, depth, stamp: float, imu_batch=None) -> dict:
        """Process one RGB-D frame (reference System::TrackRGBD,
        src/System.h:112 — depth becomes a virtual right coordinate)."""
        t0 = time.time()
        info = self.tracker.process_rgbd(
            img, depth, stamp, allow_mapping=not self.localization_only
        )
        self._frame_times.append(time.time() - t0)
        return self._with_pose(info)

    def track_monocular(self, img, stamp: float, imu_batch=None) -> dict:
        """Process one monocular frame (+ optional IMU batch) (reference
        System::TrackMonocular, src/System.h:118)."""
        t0 = time.time()
        info = self.tracker.process_mono(
            img, stamp, allow_mapping=not self.localization_only, imu=imu_batch
        )
        self._frame_times.append(time.time() - t0)
        return self._with_pose(info)

    def _with_pose(self, info: dict) -> dict:
        _, R_wc, p_w = self.tracker.trajectory[-1]
        info = dict(info)
        info["R_wc"] = R_wc
        info["p_w"] = p_w
        return info

    # -- mode switches (reference ActivateLocalizationMode) ----------------
    def activate_localization_mode(self):
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def reset(self):
        """Full reset (reference System::Reset)."""
        self.tracker = Tracker(self.cam, self.cfg, rectifier=self.rectifier)
        self._frame_times.clear()

    def reset_active_map(self):
        """Discard only the active map, keeping parked Atlas maps
        (reference System::ResetActiveMap, src/System.h:151)."""
        self.tracker.reset_active_map()

    def shutdown(self):
        """Drain amortized post-loop GBA chunks (reference System::Shutdown
        joins the GBA thread, src/System.cc:379)."""
        self.tracker.finalize()

    # -- trajectory output -------------------------------------------------
    def save_trajectory_tum(self, path: str):
        self.tracker.finalize()
        tio.save_tum(path, self.tracker.trajectory)

    def save_trajectory_euroc(self, path: str):
        self.tracker.finalize()
        tio.save_euroc(path, self.tracker.trajectory)

    def save_trajectory_kitti(self, path: str):
        self.tracker.finalize()
        tio.save_kitti(path, self.tracker.trajectory)

    def _keyframe_trajectory(self):
        self.tracker.finalize()
        ks = self.tracker.kstore
        traj = []
        for k in range(self.tracker.n_kf):
            R_cw = np.asarray(ks.R[k])
            t_cw = np.asarray(ks.t[k])
            traj.append((float(ks.stamp[k]), R_cw.T, -R_cw.T @ t_cw))
        return traj

    def save_keyframe_trajectory_tum(self, path: str):
        tio.save_tum(path, self._keyframe_trajectory())

    def save_keyframe_trajectory_euroc(self, path: str):
        """(reference System::SaveKeyFrameTrajectoryEuRoC, src/System.cc:602)"""
        tio.save_euroc(path, self._keyframe_trajectory())

    def save_keyframe_trajectory_kitti(self, path: str):
        """(reference KITTI-format keyframe saver, src/System.cc:654 family)"""
        tio.save_kitti(path, self._keyframe_trajectory())

    # -- stats (reference SAVE_TIMES instrumentation) ----------------------
    def timing_stats(self) -> dict:
        times = np.asarray(self._frame_times[3:] or self._frame_times)
        return {
            "mean_ms": float(times.mean() * 1e3) if len(times) else 0.0,
            "median_ms": float(np.median(times) * 1e3) if len(times) else 0.0,
            "fps": float(1.0 / max(np.median(times), 1e-9)) if len(times) else 0.0,
        }

    def save_imu_init_log(self, path: str):
        """Per-attempt IMU-initialization debug CSV (reference
        System::SaveDebugData, src/System.cc:708-761): keyframe count,
        accept/reject reason, estimated scale, gravity angle from
        vertical, gyro/accel biases, solver cost drop, wall time."""
        cols = ("n_kf", "accepted", "reason", "scale", "gravity_angle_deg",
                "bg", "ba", "cost0", "cost1", "wall_ms")
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for rec in self.tracker.imu_init_log:
                row = []
                for c in cols:
                    v = rec.get(c, "")
                    if isinstance(v, list):
                        v = " ".join(f"{x:.6g}" for x in v)
                    elif isinstance(v, float):
                        v = f"{v:.6g}"
                    row.append(str(v))
                f.write(",".join(row) + "\n")

    # -- checkpoint / resume (reference Map::Save/Load + SaveAtlas) --------
    def save_map(self, path: str):
        """Serialize every store to one npz — the whole map state."""
        tr = self.tracker
        arrays = {}
        for name, store in (("pt", tr.pstore), ("ln", tr.lstore), ("kf", tr.kstore)):
            for f in dataclasses.fields(store):
                arrays[f"{name}_{f.name}"] = np.asarray(getattr(store, f.name))
        arrays["meta_n_kf"] = np.asarray(tr.n_kf)
        arrays["meta_R"] = np.asarray(tr.R)
        arrays["meta_t"] = np.asarray(tr.t)
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str):
        data = np.load(path)
        tr = self.tracker
        for name, store_attr in (("pt", "pstore"), ("ln", "lstore"), ("kf", "kstore")):
            store = getattr(tr, store_attr)
            kw = {
                # fields added after a snapshot was written keep their
                # empty-store value (e.g. ln_obs_bits on pre-round-5 maps)
                f.name: (
                    jnp.asarray(data[f"{name}_{f.name}"])
                    if f"{name}_{f.name}" in data
                    else getattr(store, f.name)
                )
                for f in dataclasses.fields(store)
            }
            setattr(tr, store_attr, type(store)(**kw))
        tr.n_kf = int(data["meta_n_kf"])
        tr.R = jnp.asarray(data["meta_R"])
        tr.t = jnp.asarray(data["meta_t"])
        tr.state = TrackingState.OK if tr.n_kf > 0 else TrackingState.NOT_INITIALIZED
        # rebuild the loop-closing/relocalization BoW index from the
        # loaded landmark descriptors (reference Map::PostLoad rebuilds
        # the KeyFrameDatabase, src/Map.cc:967)
        if tr.n_kf > 0:
            tr.rebuild_bow()
        if tr.loop_closer is not None:
            tr.loop_closer = type(tr.loop_closer)(self.cfg)
