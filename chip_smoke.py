"""On-card smoke run of the point-line SLAM main path.

    python chip_smoke.py               # phases 1-7 on one GPU
    python chip_smoke.py --four-cards  # distributed BA/GBA/PGO: 4 cards vs 1

Phases (one process, which holds the card throughout):
  1. device: a GPU or nothing (no CPU fallback), card name and power limit;
  2. matcher parity: the tracker's gated matcher at N=1200 features against
     P=4096 (tracking's local map) and P=16384 (the whole store), compared
     with the NumPy brute force, and timed;
  3. per-frame program: build_frame + track_step on one 752x480 stereo
     pair, card against the host CPU, from one seeded store;
  4. visual stereo end to end through System.track_stereo;
  5. stereo-inertial end to end (bench.py's flagship) through
     System.track_stereo with IMU;
  6. back end at production shapes: Schur BA and pose-graph optimization;
  7. the `gpu`-marked tests, in this process.

Every timing is printed beside the card's name and power limit. The last
line of standard output is one JSON object
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`,
printed only when every phase passed; otherwise the exit code is 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_FEATURES = 1200
P_LOCAL = 4096
P_STORE = 16384
MATCH_CALLS = 50


def say(msg: str) -> None:
    print(msg, flush=True)


def check_device(devices) -> dict:
    """Phase 1 core: the first device must be a GPU. Returns the device
    record the last line reports; raises on any other platform."""
    from pli_slam_tpu.utils.device import require_gpu

    devices = require_gpu(devices)
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def result_line(device: dict) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": device["count"]}})


def _median_ms(fn, calls: int) -> float:
    import jax

    jax.block_until_ready(fn())  # warm-up (compiles)
    jax.block_until_ready(fn())
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


# ---------------------------------------------------------------------------
# Phase 2: matcher parity and timing
# ---------------------------------------------------------------------------


def phase_matcher(card: str, n=N_FEATURES, p_local=P_LOCAL, p_store=P_STORE, calls=MATCH_CALLS) -> dict:
    import jax
    import jax.numpy as jnp

    from pli_slam_tpu.frontend import match_reference as mr
    from pli_slam_tpu.frontend.tracker import _match_points_against_store
    from pli_slam_tpu.utils.config import SlamConfig

    cfg = SlamConfig.euroc_stereo()
    out = {}
    # tracking: a C-row local map inside the full store; fuse-width: every row
    for name, case in (
        (f"P={p_local} (local map of {p_store})", mr.planted_case(n, p_store, seed=1, n_local=p_local)),
        (f"P={p_store} (whole store)", mr.planted_case(n, p_store, seed=2)),
    ):
        fn = jax.jit(partial(_match_points_against_store, case.cam, cfg))
        local = None if case.local_ids is None else jnp.asarray(case.local_ids)
        for radius in (cfg.match.search_radius_px, max(cfg.match.search_radius_px * 0.4, 4.0)):
            idx, ok, _ = fn(case.frame, case.R, case.t, case.pstore, radius, local)
            ref = mr.brute_force_match(case, radius, cfg.match.orb_th_high, cfg.match.nn_ratio)
            cmp = mr.compare(case, ref, idx, ok)
            recall = mr.planted_recall(case, idx, ok)
            say(f"  matcher {name} r={radius:g}: {cmp} planted recall {recall:.4f}")
            assert cmp["ok_mismatch"] == 0 and cmp["idx_mismatch"] == 0 and cmp["best_mismatch"] == 0, cmp
            assert cmp["exempt"] <= 0.1 * cmp["rows"], cmp
            assert recall >= 0.95, recall
        ms = _median_ms(lambda: fn(case.frame, case.R, case.t, case.pstore,
                                   cfg.match.search_radius_px, local)[:2], calls)
        key = "match_ms_local" if local is not None else "match_ms_store"
        out[key] = ms
        say(f"  matcher {name}: median {ms:.4f} ms over {calls} calls [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 3: one frame, card against CPU
# ---------------------------------------------------------------------------


def seed_stores(cam, cfg, frame, R_wc, p_w):
    """Point and line stores seeded from one frame's stereo features
    (host arrays; world = the frame's camera placed at (R_wc, p_w))."""
    import dataclasses

    from pli_slam_tpu.worldmap import stores as st

    f = {k: np.asarray(v) for k, v in (
        ("uv", frame.feats.uv), ("desc", frame.feats.desc), ("valid", frame.feats.valid),
        ("depth", frame.depth), ("p0", frame.lines.p0), ("p1", frame.lines.p1),
        ("ldesc", frame.lines.desc), ("lvalid", frame.lines.valid & frame.line_ok),
        ("disp", frame.line_disp))}
    fx, fy, cx, cy, bf = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf))

    def to_world(uv, z):
        xc = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
        return (xc @ np.asarray(R_wc, np.float64).T + p_w).astype(np.float32)

    ok = f["valid"] & (f["depth"] > 0)
    n = len(ok)
    ps = st.PointStore.empty(cfg.map.max_points)
    x = np.zeros((cfg.map.max_points, 3), np.float32)
    x[:n] = to_world(f["uv"], np.where(ok, f["depth"], 1.0))
    desc = np.zeros((cfg.map.max_points, 256), np.int8)
    desc[:n] = f["desc"]
    valid = np.zeros(cfg.map.max_points, bool)
    valid[:n] = ok
    ps = dataclasses.replace(ps, x=x, desc=desc, valid=valid)

    lok = f["lvalid"] & (f["disp"][:, 0] > 0.5) & (f["disp"][:, 1] > 0.5)
    nl = len(lok)
    ls = st.LineStore.empty(cfg.map.max_lines)
    seg = np.zeros((cfg.map.max_lines, 6), np.float32)
    d = np.where(lok[:, None], f["disp"], 1.0)
    seg[:nl] = np.concatenate([to_world(f["p0"], bf / d[:, 0]), to_world(f["p1"], bf / d[:, 1])], -1)
    ldesc = np.zeros((cfg.map.max_lines, 256), np.int8)
    ldesc[:nl] = f["ldesc"]
    lvalid = np.zeros(cfg.map.max_lines, bool)
    lvalid[:nl] = lok
    ls = dataclasses.replace(ls, seg=seg, desc=ldesc, valid=lvalid)
    return ps, ls, int(ok.sum()), int(lok.sum())


def _rot_deg(Ra, Rb) -> float:
    """Angle between two rotations; the chordal form stays exact for the
    tiny angles compared here, where arccos of the trace does not."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0))))


def _frame_run(cam, cfg, dev, imgs, R0, t0, ps, ls) -> dict:
    """build_frame + track_step (wide first window, as right after
    initialisation) of the second frame on `dev`."""
    import jax

    from pli_slam_tpu.frontend.frame import build_frame
    from pli_slam_tpu.frontend.tracker import track_step

    (il, ir), R_in, t_in, ps_d, ls_d = jax.device_put((imgs, R0, t0, ps, ls), dev)
    frame = jax.jit(partial(build_frame, cam, cfg))(il, ir)
    R, t, _, _, _, _, n_in, _, _ = jax.jit(partial(track_step, cam, cfg))(
        frame, R_in, t_in, ps_d, ls_d, True)
    return {
        "uv": np.concatenate([np.asarray(frame.feats.uv),
                              1e4 * np.asarray(frame.feats.octave)[:, None]], -1),
        "valid": np.asarray(frame.feats.valid),
        "desc": np.asarray(frame.feats.desc), "R": np.asarray(R), "t": np.asarray(t),
        "n_in": int(n_in), "n_lines": int(np.asarray(frame.lines.valid).sum()),
    }


def phase_frame_card(card: str, cfg=None, cam=None) -> dict:
    """Card half of phase 3: two rendered frames, stores seeded from the
    first, the card's run on the second; the host CPU's run on the same
    inputs starts in a thread (an XLA:CPU compile at full size) and is
    compared by `phase_frame_compare` once it is done."""
    import jax
    from concurrent.futures import ThreadPoolExecutor

    from pli_slam_tpu.frontend.frame import build_frame
    from pli_slam_tpu.utils import synthetic
    from pli_slam_tpu.utils.config import SlamConfig

    cfg = cfg or SlamConfig.euroc_stereo()
    cam = cam or _euroc_cam()
    fr = list(synthetic.make_sequence(cam, 2, fps=cfg.fps))
    imgs = [(np.asarray(f["img_l"]), np.asarray(f["img_r"])) for f in fr]
    f0 = jax.jit(partial(build_frame, cam, cfg))(*imgs[0])
    ps, ls, n_pts, n_lns = seed_stores(cam, cfg, f0, fr[0]["R_wc"], fr[0]["p_w"])
    R0 = fr[0]["R_wc"].T
    t0 = -R0 @ fr[0]["p_w"]
    args = (cam, cfg, imgs[1], R0, t0, ps, ls)
    pool = ThreadPoolExecutor(max_workers=1)
    cpu = pool.submit(_frame_run, cam, cfg, jax.devices("cpu")[0], *args[2:])
    pool.shutdown(wait=False)
    say(f"  seeded store: {n_pts} points, {n_lns} lines; CPU run started beside the card's phases")
    return {"gpu": _frame_run(cam, cfg, jax.devices()[0], *args[2:]), "cpu": cpu,
            "R_gt": fr[1]["R_wc"].T, "t_gt": -fr[1]["R_wc"].T @ fr[1]["p_w"]}


def phase_frame_compare(card: str, state: dict) -> dict:
    """Tolerances: the keypoint sets overlap >= 98% and shared keypoints
    agree on >= 99% of descriptor bits (a FAST score, a steering angle or
    a BRIEF comparison that lands within float rounding of its threshold
    may go either way on two backends); the solved poses agree within
    1 mm and 0.05 deg (a few flipped matches move a ~1000-match GN solve
    far less than that)."""
    return compare_frames(state, {"cpu": state["cpu"].result(), "gpu": state["gpu"]})


def compare_frames(inp: dict, res: dict) -> dict:
    R_gt, t_gt = inp["R_gt"], inp["t_gt"]
    c, g = res["cpu"], res["gpu"]
    uc, ug = c["uv"][c["valid"]], g["uv"][g["valid"]]
    dc, dg = c["desc"][c["valid"]], g["desc"][g["valid"]]
    # shared keypoints: same level-0 position to 1e-3 px, same octave
    d2 = ((ug[:, None, :] - uc[None, :, :]) ** 2).sum(-1)
    j = np.argmin(d2, axis=1)
    shared = d2[np.arange(len(ug)), j] <= 1e-6
    overlap = shared.sum() / max(len(uc), len(ug), 1)
    bits = float((dg[shared] == dc[j[shared]]).mean()) if shared.any() else 0.0
    dt_mm = float(np.linalg.norm(c["t"] - g["t"]) * 1e3)
    dr_deg = _rot_deg(c["R"], g["R"])
    err_mm = {k: float(np.linalg.norm(v["t"] - t_gt) * 1e3) for k, v in res.items()}
    err_deg = {k: _rot_deg(v["R"], R_gt) for k, v in res.items()}
    say(f"  keypoints cpu {len(uc)} gpu {len(ug)} shared {int(shared.sum())} "
        f"(overlap {overlap:.4f}); descriptor bit agreement {bits:.5f}; "
        f"lines cpu {c['n_lines']} gpu {g['n_lines']}; inliers cpu {c['n_in']} gpu {g['n_in']}")
    say(f"  pose card-vs-cpu: {dt_mm:.4f} mm, {dr_deg:.5f} deg; "
        f"vs truth: cpu {err_mm['cpu']:.2f} mm / {err_deg['cpu']:.3f} deg, "
        f"gpu {err_mm['gpu']:.2f} mm / {err_deg['gpu']:.3f} deg")
    assert overlap >= 0.98, overlap
    assert bits >= 0.99, bits
    assert dt_mm <= 1.0 and dr_deg <= 0.05, (dt_mm, dr_deg)
    return {"kp_overlap": float(overlap), "desc_bits": bits, "pose_dt_mm": dt_mm, "pose_dr_deg": dr_deg}


def _euroc_cam():
    from pli_slam_tpu.frontend.match_reference import euroc_camera

    return euroc_camera()


# ---------------------------------------------------------------------------
# Phases 4-5: end to end through System.track_stereo
# ---------------------------------------------------------------------------


def _count_calls(obj, name: str) -> list:
    """Wrap obj.<name> to count calls and keep the last call's args."""
    orig = getattr(obj, name)
    rec = [0, None]

    def wrapped(*a, **k):
        rec[0] += 1
        rec[1] = (a, k)
        return orig(*a, **k)

    setattr(obj, name, wrapped)
    rec.append(orig)
    return rec


def _percentiles(ms: np.ndarray) -> str:
    return f"p50 {np.percentile(ms, 50):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms, max {ms.max():.2f} ms"


def phase_visual(card: str, n_frames=60, cfg=None, cam=None, warm=10) -> dict:
    from pli_slam_tpu.system import System
    from pli_slam_tpu.utils import synthetic
    from pli_slam_tpu.utils.config import SlamConfig

    cfg = cfg or SlamConfig.euroc_stereo()
    cam = cam or _euroc_cam()
    frames = list(synthetic.make_sequence(cam, n_frames, fps=cfg.fps))
    sysm = System(cam, cfg)
    fused = _count_calls(sysm.tracker, "_process_fused")
    step = _count_calls(sysm.tracker, "_step")
    states = []
    t_start = time.perf_counter()
    for fr in frames:
        states.append(sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"])["state"])
    wall = time.perf_counter() - t_start
    est = sysm.tracker.positions()
    gt = np.stack([fr["p_w"] for fr in frames])
    ate = synthetic.ate_rmse(est, gt)
    ms = np.asarray(sysm._frame_times[warm:]) * 1e3
    tracked = float(np.mean([s == "OK" for s in states[1:]]))
    a, k = step[1]
    step_ms = _median_ms(lambda: step[2](*a, **k), 20)
    tr = sysm.tracker
    say(f"  visual: {n_frames} frames, {fused[0]} through the fused step; tracked {tracked:.4f}; "
        f"ATE {ate:.4f} m; KFs {tr.n_kf}, points {int(tr.pstore.valid.sum())}, "
        f"lines {int(tr.lstore.valid.sum())}")
    say(f"  visual timing [{card}]: {1e3 / ms.mean():.2f} fps over frames {warm}..{n_frames - 1} "
        f"({_percentiles(ms)}); wall incl. compile {wall:.1f} s; "
        f"fused step back-to-back median {step_ms:.3f} ms")
    assert fused[0] >= n_frames - 2, fused[0]
    assert tracked >= 0.9, tracked
    assert ate <= 0.10, ate
    assert np.isfinite(est).all()
    return {"visual_ate_m": float(ate), "visual_tracked": tracked,
            "visual_p50_ms": float(np.percentile(ms, 50)), "fused_step_ms": step_ms}


def phase_inertial(card: str, n_frames=100, setup=None) -> dict:
    from pli_slam_tpu.system import System
    from pli_slam_tpu.utils import synthetic

    if setup is None:
        sys.path.insert(0, REPO)
        import bench

        setup = bench.flagship_setup()
    cfg, cam, traj = setup
    frames = list(synthetic.make_sequence(
        cam, n_frames, fps=cfg.fps, traj=traj, imu_noise=synthetic.ImuNoiseModel.euroc()))
    sysm = System(cam, cfg)
    tr = sysm.tracker
    vi = _count_calls(tr, "_process_fused_vi")
    step = _count_calls(tr, "_step_vi")
    states, poses_ok = [], True
    for fr in frames:
        imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
        info = sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"], imu_batch=imu)
        states.append(info["state"])
        poses_ok &= bool(np.isfinite(info["p_w"]).all() and np.isfinite(info["R_wc"]).all())
    sysm.shutdown()
    est = tr.positions()
    gt = np.stack([fr["p_w"] for fr in frames])
    ate = synthetic.ate_rmse(est, gt)
    tracked = float(np.mean([s == "OK" for s in states[1:]]))
    loops = tr.loop_closer.n_loops_closed if tr.loop_closer else 0
    ms = np.asarray(sysm._frame_times) * 1e3
    say(f"  stereo-inertial: {n_frames} frames, imu_ready {tr.imu_ready}, {vi[0]} through the "
        f"fused VI step; tracked {tracked:.4f}; ATE {ate:.4f} m (not bounded here); loops {loops}; "
        f"KFs {tr.n_kf}")
    say(f"  stereo-inertial timing [{card}]: p50 {np.percentile(ms, 50):.2f} ms over all frames "
        f"(compiles included)")
    assert tr.imu_ready, f"IMU never initialised: {[r['reason'] for r in tr.imu_init_log]}"
    assert vi[0] >= 1, "no frame reached the fused stereo-inertial step"
    assert poses_ok and np.isfinite(est).all(), "non-finite pose"
    a, k = step[1]
    mem = step[2].lower(*a, **k).compile().memory_analysis()
    say(f"  fused VI step memory_analysis: {mem}")
    return {"vi_ate_m": float(ate), "vi_tracked": tracked, "vi_frames_fused": vi[0], "loops": loops}


# ---------------------------------------------------------------------------
# Phase 6: back end at production shapes
# ---------------------------------------------------------------------------


def phase_backend(card: str, ba_problem=None, pgo_problem=None) -> dict:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    from pli_slam_tpu.solve import ba, pgo
    from pli_slam_tpu.utils.config import OptimizerConfig

    cam, prob, _ = ba_problem or ge.build_production_ba_problem(1)
    cfg = OptimizerConfig(local_ba_window=int(prob.R.shape[0]))
    c_init = float(ba.evaluate_cost(cam, prob, prob.R, prob.t, prob.pts, prob.lns, cfg)[0])
    solve = jax.jit(partial(ba.solve_ba, cam), static_argnames=("cfg", "iters"))
    cost0 = float(solve(prob, cfg=cfg, iters=0).cost)
    res = jax.block_until_ready(solve(prob, cfg=cfg, iters=6))
    t0 = time.perf_counter()
    jax.block_until_ready(solve(prob, cfg=cfg, iters=6))
    dt = time.perf_counter() - t0
    cost1 = float(res.cost)
    say(f"  Schur BA W={prob.R.shape[0]} P={prob.pts.shape[0]} L={prob.lns.shape[0]} "
        f"obs={prob.po_pose.shape[0] + prob.lo_pose.shape[0]}: initial {c_init:.2f}, "
        f"cost {cost0:.2f} -> {cost1:.4f}; 6 iterations {dt * 1e3:.1f} ms after compile [{card}]")
    assert np.isfinite(np.asarray(res.t)).all()
    assert cost0 > 1.0 and cost1 < 0.5 * cost0, (cost0, cost1)

    graph, t_gt, drift = pgo_problem or ge.build_production_pgo()
    opt = jax.jit(pgo.optimize, static_argnames=("iters", "mode"))
    t_err0 = float(jnp.linalg.norm(drift, axis=-1).mean())
    out = {"ba_cost": cost1}
    for mode in ("se3", "sim3"):
        g = jax.block_until_ready(opt(graph, iters=12, mode=mode))
        t_err = float(jnp.linalg.norm(g.t - t_gt, axis=-1).mean())
        say(f"  PGO {mode} K={graph.R.shape[0]} E={graph.e_i.shape[0]}: mean t-err "
            f"{t_err0:.4f} -> {t_err:.4f} m")
        assert np.isfinite(np.asarray(g.t)).all()
        assert t_err < 0.3 * t_err0, (mode, t_err0, t_err)
        out[f"pgo_{mode}_t_err"] = t_err
    return out


# ---------------------------------------------------------------------------
# Phase 7: gpu-marked tests, in this process
# ---------------------------------------------------------------------------


def phase_tests(card: str) -> dict:
    """`pytest -m gpu` over the test files that declare the marker (other
    files are not imported: an unrelated installed `tests` package would
    shadow their `tests.` imports)."""
    import glob

    import pytest

    files = [f for f in sorted(glob.glob(os.path.join(REPO, "tests", "test_*.py")))
             if "mark.gpu" in open(f).read()]
    assert files, "no gpu-marked test files"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly", *files])
    assert rc == 0, f"pytest -m gpu exited {rc}"
    return {}


# ---------------------------------------------------------------------------
# --four-cards: distributed back end, 4 cards against 1
# ---------------------------------------------------------------------------

FOUR_CARD_COST_TOL = 1e-2  # |cost_4 - cost_1| <= tol * initial cost
FOUR_CARD_POSE_TOL_M = 1e-3  # max |t_4 - t_1| over poses


def phase_four_cards(card: str, n: int = 4, **shapes) -> dict:
    """A mesh of n cards against a mesh of one, on the same problems.
    The psum over shards reorders float sums, so results agree to the
    stated tolerances, not bit for bit."""
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    assert len(jax.devices()) >= n, f"{len(jax.devices())} devices, need {n}"
    many = ge.dryrun_multichip(n, **shapes)
    one = ge.dryrun_multichip(1, **shapes)
    for name, ds in many["device_sets"].items():
        say(f"  device_set {name}: devices {ds['devices']} shard {ds['shard_shape']}")
        assert len(ds["devices"]) == n, (name, ds)
    for key in ("ba_cost", "gba_cost"):
        diff = abs(many[key] - one[key])
        say(f"  {key}: {n} cards {many[key]:.6f}, 1 card {one[key]:.6f} (|diff| {diff:.3g})")
        assert diff <= FOUR_CARD_COST_TOL * many["c_init"], (key, diff)
    for key in ("ba_t", "gba_t", "pgo_t"):
        d = float(np.abs(many[key] - one[key]).max())
        say(f"  {key}: max |t_{n} - t_1| {d * 1e3:.4f} mm")
        assert d <= FOUR_CARD_POSE_TOL_M, (key, d)
    say(f"  pgo mean t-err: {n} cards {many['pgo_t_err']:.5f}, 1 card {one['pgo_t_err']:.5f}")
    return {}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed back end on 4 cards against 1")
    ap.add_argument("--phases", default="2,3,4,5,6,7",
                    help="comma-separated subset of phases 2-7 (phase 1 always runs)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cuda,cpu")
    try:
        from pli_slam_tpu.utils.compile_cache import enable_compile_cache
        from pli_slam_tpu.utils.device import card_label

        cache = enable_compile_cache()
        device = check_device(jax.devices())
        card = card_label()
    except Exception as e:  # no card, no CUDA plugin, or not inside the repo
        print(f"chip_smoke: phase 1 (device) FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    say(f"phase 1 device: {device['platform']} / {device['kind']} x{device['count']}; "
        f"compile cache {cache}")
    say(card)
    label = card.splitlines()[0]

    if args.four_cards:
        phases = [("four-cards", partial(phase_four_cards, label))]
    else:
        table = {"2": ("matcher", phase_matcher), "3": ("frame (card)", phase_frame_card),
                 "4": ("visual", phase_visual), "5": ("inertial", phase_inertial),
                 "6": ("backend", phase_backend), "7": ("tests", phase_tests)}
        keys = [k for k in args.phases.split(",") if k]
        phases = [(f"{k} {table[k][0]}", partial(table[k][1], label)) for k in keys]
        if "3" in keys:
            # the CPU half of phase 3 runs in a thread beside the card's
            # phases; its comparison comes last, before the tests
            state = {}
            phases[keys.index("3")] = (
                "3 frame (card)", lambda: state.update(phase_frame_card(label)))
            phases.insert(len(phases) - ("7" in keys),
                          ("3 frame (compare)", lambda: phase_frame_compare(label, state)))
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        say(f"phase {name}: start")
        try:
            fn()
            say(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            say(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
    if failed:
        say(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    say(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
