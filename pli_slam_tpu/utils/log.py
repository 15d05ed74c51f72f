"""Leveled logger + per-stage timing CSV.

JAX analog of the reference's `Verbose` static logger
(include/System.h:47-72: QUIET/NORMAL/VERBOSE/VERY_VERBOSE/DEBUG with
`PrintMess`) and of the SAVE_TIMES per-stage CSV instrumentation
(src/Tracking.cc:945-952 `f_track_times`).
"""

from __future__ import annotations

import os
import sys
import time

QUIET, NORMAL, VERBOSE, VERY_VERBOSE, DEBUG = 0, 1, 2, 3, 4
_NAMES = {QUIET: "QUIET", NORMAL: "NORMAL", VERBOSE: "VERBOSE",
          VERY_VERBOSE: "VERY_VERBOSE", DEBUG: "DEBUG"}

# default mirrors the reference's System.cc:151 (SetTh(QUIET)); override
# with PLI_SLAM_VERBOSITY=normal|verbose|very_verbose|debug
_level = QUIET
_env = os.environ.get("PLI_SLAM_VERBOSITY", "").upper()
for _k, _v in _NAMES.items():
    if _env == _v:
        _level = _k


def set_level(level: int) -> None:
    """Reference Verbose::SetTh."""
    global _level
    _level = level


def get_level() -> int:
    return _level


def log(msg: str, level: int = NORMAL) -> None:
    """Reference Verbose::PrintMess(msg, eLevel)."""
    if level <= _level:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str) -> None:
    log(msg, DEBUG)


class StageTimer:
    """Accumulates per-frame stage wall times and writes a CSV —
    the SAVE_TIMES `f_track_times` analog. Usage:

        timer = StageTimer(["extract", "track", "ba"])
        with timer.stage("extract"): ...
        timer.end_frame()
        timer.save_csv("track_times.csv")
    """

    def __init__(self, stages: list[str]):
        self.stages = list(stages)
        self.rows: list[dict[str, float]] = []
        self._cur: dict[str, float] = {}

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer._cur[self.name] = self.timer._cur.get(self.name, 0.0) + dt
            return False

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def end_frame(self) -> None:
        self.rows.append(self._cur)
        self._cur = {}

    def save_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("frame," + ",".join(self.stages) + "\n")
            for i, row in enumerate(self.rows):
                f.write(
                    f"{i}," + ",".join(f"{row.get(s, 0.0) * 1e3:.3f}" for s in self.stages) + "\n"
                )

    def means_ms(self) -> dict[str, float]:
        if not self.rows:
            return {s: 0.0 for s in self.stages}
        return {
            s: 1e3 * sum(r.get(s, 0.0) for r in self.rows) / len(self.rows)
            for s in self.stages
        }
