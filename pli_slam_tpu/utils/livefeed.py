"""Live-feed front end: asynchronous sensor ingestion + synchronization.

JAX analog of the reference's ROS wrapper
(Examples/ROS/PLI_SLAM2/src/ros_stereo_inertial.cc:39-145): an
`ImuGrabber` and `ImageGrabber` accumulate asynchronously arriving
sensor messages from any transport (socket, ROS bridge, shared-memory
ring, replay thread); `SyncWithImu` pairs left/right images whose
timestamps agree within `max_stereo_skew`, waits until IMU coverage
reaches the image stamp, and emits one synchronized work item
(img_l, img_r, stamp, imu_batch) per frame for `System.track_stereo`.

Thread-safe: producers push from IO threads, the consumer drains from
the tracking loop — the queue-and-condvar topology of the reference's
`mBufMutex` fields, with the busy-wait `while(1) ... sleep(5ms)` loop
(ros_stereo_inertial.cc:105) replaced by condition variables.
"""

from __future__ import annotations

import collections
import threading

import numpy as np


class ImuGrabber:
    """Accumulates (stamp, gyro[3], acc[3]) samples (reference
    ImuGrabber::GrabImu, ros_stereo_inertial.cc:126)."""

    def __init__(self, maxlen: int = 4096):
        self.buf: collections.deque = collections.deque(maxlen=maxlen)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)

    def push(self, stamp: float, gyro, acc) -> None:
        with self.cond:
            self.buf.append((float(stamp), np.asarray(gyro, np.float32),
                             np.asarray(acc, np.float32)))
            self.cond.notify_all()

    def latest_stamp(self) -> float:
        with self.lock:
            return self.buf[-1][0] if self.buf else -np.inf

    def pop_until(self, stamp: float):
        """All samples with t <= stamp, removed from the buffer
        (the drain loop at ros_stereo_inertial.cc:117-124)."""
        out = []
        with self.lock:
            while self.buf and self.buf[0][0] <= stamp:
                out.append(self.buf.popleft())
        return out


class ImageGrabber:
    """Accumulates stamped images for one camera (reference
    ImageGrabber::GrabImageLeft/Right, ros_stereo_inertial.cc:56-74:
    the reference keeps only the newest frame on overflow — same here
    via the bounded deque)."""

    def __init__(self, maxlen: int = 8):
        self.buf: collections.deque = collections.deque(maxlen=maxlen)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)

    def push(self, stamp: float, img) -> None:
        with self.cond:
            self.buf.append((float(stamp), img))
            self.cond.notify_all()

    def head_stamp(self) -> float:
        with self.lock:
            return self.buf[0][0] if self.buf else np.inf

    def pop(self):
        with self.lock:
            return self.buf.popleft() if self.buf else None

    def drop_older_than(self, stamp: float) -> int:
        n = 0
        with self.lock:
            while self.buf and self.buf[0][0] < stamp:
                self.buf.popleft()
                n += 1
        return n


class StereoInertialSync:
    """Synchronizer: pairs L/R frames + the IMU span since the last
    frame (reference ImageGrabber::SyncWithImu, ros_stereo_inertial.cc:
    101-145). `next_frame` blocks up to `timeout` for a complete item.
    """

    def __init__(self, max_stereo_skew: float = 0.01, use_imu: bool = True):
        self.left = ImageGrabber()
        self.right = ImageGrabber()
        self.imu = ImuGrabber()
        self.max_skew = max_stereo_skew
        self.use_imu = use_imu
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()
        with self.left.cond:
            self.left.cond.notify_all()

    def next_frame(self, timeout: float = 1.0):
        """Returns dict(img_l, img_r, t, imu) or None on timeout/stop."""
        deadline = threading.Timer(timeout, lambda: None)  # wall clock below
        import time as _time

        t_end = _time.time() + timeout
        while not self._stop.is_set():
            tl, tr = self.left.head_stamp(), self.right.head_stamp()
            # drop the older stream head until the pair agrees (the
            # reference's two while-loops, ros_stereo_inertial.cc:108-112)
            if np.isfinite(tl) and np.isfinite(tr):
                if tl < tr - self.max_skew:
                    self.left.pop()
                    continue
                if tr < tl - self.max_skew:
                    self.right.pop()
                    continue
                stamp = min(tl, tr)
                # IMU must cover the image stamp before tracking
                # (ros_stereo_inertial.cc:114 `if(mpImuGb->imuBuf.back()->header.stamp...`)
                if self.use_imu and self.imu.latest_stamp() < stamp:
                    if _time.time() >= t_end:
                        return None
                    with self.imu.cond:
                        self.imu.cond.wait(0.005)
                    continue
                _, img_l = self.left.pop()
                _, img_r = self.right.pop()
                imu_batch = None
                if self.use_imu:
                    samples = self.imu.pop_until(stamp)
                    if samples:
                        imu_batch = {
                            "stamps": np.asarray([s for s, _, _ in samples]),
                            "gyro": np.stack([g for _, g, _ in samples]),
                            "acc": np.stack([a for _, _, a in samples]),
                        }
                return {"img_l": img_l, "img_r": img_r, "t": stamp, "imu": imu_batch}
            if _time.time() >= t_end:
                return None
            with self.left.cond:
                self.left.cond.wait(0.005)
        return None
