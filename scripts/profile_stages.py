"""Per-stage timing of the tracking pipeline on the current JAX backend.

The analog of the reference's SAVE_TIMES instrumentation
(reference: src/Tracking.cc:945-952): frame build / track / insert / BA,
each timed with block_until_ready so dispatch+compute is attributed to
the right stage.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pli_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np


def bench(name, fn, n=5):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:30s} {dt*1e3:9.2f} ms")
    return out


def main():
    from functools import partial

    from pli_slam_tpu.frontend import tracker as trk
    from pli_slam_tpu.frontend.frame import make_build_frame
    from pli_slam_tpu.ops.camera import Camera
    from pli_slam_tpu.utils import synthetic
    from pli_slam_tpu.utils.config import SlamConfig
    from pli_slam_tpu.worldmap import stores as st

    cfg = SlamConfig.euroc_stereo()
    cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2,
                         bf=0.11 * 435.2, width=752, height=480)

    frames = list(synthetic.make_sequence(cam, 6, fps=cfg.fps))
    img_l = frames[3]["img_l"]
    img_r = frames[3]["img_r"]

    build_frame = make_build_frame(cam, cfg)
    print("== stage timings (post-compile) ==")
    frame = bench("build_frame", lambda: build_frame(img_l, img_r))

    # build a plausibly-populated store by running a few frames first
    tracker = trk.Tracker(cam, cfg)
    for fr in frames[:4]:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    pstore, lstore, kstore = tracker.pstore, tracker.lstore, tracker.kstore
    R, t = tracker.R, tracker.t

    track = jax.jit(partial(trk.track_step, cam, cfg))
    out = bench("track_step", lambda: track(frame, R, t, pstore, lstore))
    _, _, pt_idx, pt_in, ln_idx, ln_in, n_in, _, _ = out

    insert = jax.jit(partial(trk.insert_keyframe, cam, cfg))
    bench("insert_keyframe", lambda: insert(
        frame, R, t, 0.0, pt_idx, pt_in, ln_idx, ln_in, tracker.n_kf,
        pstore, lstore, kstore))

    ba = jax.jit(partial(trk.local_ba, cam, cfg))
    W = cfg.opt.local_ba_window
    window = jnp.arange(W, dtype=jnp.int32)
    fixed = jnp.zeros(W, bool).at[:2].set(True)
    bench("local_ba", lambda: ba(kstore, pstore, lstore, window, fixed), n=3)

    # sub-stage: the matching round alone
    match = jax.jit(partial(trk._match_points_against_store, cam, cfg))
    bench("  match_points (1 round)", lambda: match(frame, R, t, pstore, 15.0))
    matchl = jax.jit(partial(trk._match_lines_against_store, cam, cfg))
    bench("  match_lines (1 round)", lambda: matchl(frame, R, t, lstore, 15.0))

    from pli_slam_tpu.solve import gn
    obs = trk._pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_in, ln_idx, ln_in)
    solve = jax.jit(lambda o, R_, t_: gn.solve_pose(cam, o, R_, t_, cfg.opt))
    bench("  gn.solve_pose", lambda: solve(obs, R, t))

    far = jax.jit(partial(trk.far_point_depths, cam, cfg))
    bench("  far_point_depths (V views)", lambda: far(
        frame, R, t, tracker._kf_view_dev, kstore))

    # the REAL per-frame cost: the fused one-dispatch step, no-KF vs KF
    def run_step(allow, fskf):
        return tracker._step(
            (img_l, img_r), 0.35, tracker.R, tracker.t,
            tracker.R_prev, tracker.t_prev, tracker.vel_xi, tracker.has_vel,
            tracker.n_kf, fskf, tracker.last_kf_inliers, allow,
            tracker.pstore, tracker.lstore, tracker.kstore, tracker.bow_db,
            tracker._kf_view_dev, tracker._local_pt,
        )

    bench("fused step (no KF)", lambda: run_step(False, 1))
    bench("fused step (KF forced)", lambda: run_step(True, 10 ** 6))


if __name__ == "__main__":
    main()
