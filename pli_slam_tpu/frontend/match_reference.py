"""NumPy brute-force reference for the tracker's gated point matcher.

`_match_points_against_store` (frontend/tracker.py) matches N frame
features against P store rows: project the rows with the pose, gate by
frustum and a pixel window, take the Hamming nearest neighbour, apply
the distance cap and the Lowe ratio, then keep one row per store column.
This module restates those semantics independently (popcount Hamming on
packed bits, projection and window in float64) and builds seeded cases
with planted near-copies, so the XLA matcher can be checked against it
on any backend and at production widths.

Comparison tolerance. Hamming distances are integers, so `best` and the
ratio test are exact on every backend. The window test is not: the
matcher evaluates |a|^2 + |b|^2 - 2 a.b in float32, and at 752x480-pixel
coordinates those terms reach ~8e5 px^2, where one float32 ulp is
0.06 px^2; the few roundings involved stay below EDGE_PX2. A row is
therefore exempt from the index/ok comparison when a candidate within
EDGE_PX2 of the window edge (or within FRUSTUM_EDGE_PX of the frustum
border) could change its best or second-best, when its winner is tied or
sits exactly on the ratio boundary, or when it shares a store column
with such a row (the one-row-per-column step couples them).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.frontend.frame import FrameData
from pli_slam_tpu.ops.camera import Camera
from pli_slam_tpu.ops.lines import LineFeatures
from pli_slam_tpu.ops.orb import Features
from pli_slam_tpu.worldmap import stores as st

BIG = 1e9
EDGE_PX2 = 1.0  # |d^2 - r^2| band, px^2, in which the f32 window test may flip
FRUSTUM_EDGE_PX = 1e-2  # image-border band, px, in which the frustum test may flip


@dataclasses.dataclass
class MatchCase:
    cam: Camera
    frame: FrameData
    pstore: st.PointStore
    R: np.ndarray  # [3,3] world->camera rotation (float32 values)
    t: np.ndarray  # [3]
    local_ids: np.ndarray | None  # [C] int32, -1 padded
    planted: np.ndarray  # [N] store row planted for each feature, -1 none


def euroc_camera() -> Camera:
    return Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2,
                          width=752, height=480)


def _rotation(rng, scale):
    w = rng.normal(size=3) * scale
    a = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(a, 1e-12)
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def planted_case(n: int, p: int, seed: int = 0, n_local: int | None = None,
                 planted_frac: float = 0.6, max_flips: int = 24, radius: float = 15.0) -> MatchCase:
    """N features vs a P-row store (optionally a C=`n_local` local map).

    A `planted_frac` share of the features are near-copies (up to
    `max_flips` flipped bits, ~1 px of position noise) of distinct
    visible store rows; the rest are random. Some store rows are
    invalid, behind the camera or outside the image."""
    rng = np.random.default_rng(seed)
    cam = euroc_camera()
    W, H = cam.width, cam.height
    fx, fy, cx, cy = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    R = _rotation(rng, 0.05).astype(np.float32)
    t = (rng.normal(size=3) * 0.1).astype(np.float32)

    uv_s = np.stack([rng.uniform(-40, W + 40, p), rng.uniform(-40, H + 40, p)], -1)
    z = rng.uniform(1.5, 8.0, p)
    z[rng.random(p) < 0.03] *= -1.0
    xc = np.stack([(uv_s[:, 0] - cx) / fx * z, (uv_s[:, 1] - cy) / fy * z, z], -1)
    x_w = ((xc - t.astype(np.float64)) @ R.astype(np.float64)).astype(np.float32)
    s_valid = rng.random(p) < 0.92
    s_desc = rng.choice(np.array([-1, 1], np.int8), size=(p, 256))

    local_ids = None
    pool = np.arange(p)
    if n_local is not None:
        n_pad = n_local // 32
        pool = np.sort(rng.choice(p, n_local - n_pad, replace=False))
        local_ids = np.concatenate([pool, -np.ones(n_pad, np.int64)]).astype(np.int32)

    uv_ref, z_ref = _project(cam, R, t, x_w)
    visible = s_valid & (z_ref > 0.1) & (uv_ref[:, 0] >= 0) & (uv_ref[:, 0] < W) \
        & (uv_ref[:, 1] >= 0) & (uv_ref[:, 1] < H)
    cands = pool[visible[pool]]
    n_plant = min(int(planted_frac * n), len(cands))
    rows = rng.choice(cands, n_plant, replace=False)
    slots = rng.choice(n, n_plant, replace=False)

    f_desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    f_uv = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    planted = -np.ones(n, np.int64)
    for slot, row in zip(slots, rows):
        d = s_desc[row].copy()
        d[rng.choice(256, rng.integers(0, max_flips + 1), replace=False)] *= -1
        f_desc[slot] = d
        f_uv[slot] = uv_ref[row] + np.clip(rng.normal(size=2), -0.5 * radius, 0.5 * radius) / 2 ** 0.5
        planted[slot] = row
    f_valid = rng.random(n) < 0.97

    feats = Features(
        uv=jnp.asarray(f_uv, jnp.float32), response=jnp.ones(n), angle=jnp.zeros(n),
        octave=jnp.zeros(n, jnp.int32), scale=jnp.ones(n),
        desc=jnp.asarray(f_desc), valid=jnp.asarray(f_valid),
    )
    lines = LineFeatures(
        p0=jnp.zeros((1, 2)), p1=jnp.zeros((1, 2)), angle=jnp.zeros(1), length=jnp.zeros(1),
        response=jnp.zeros(1), desc=jnp.zeros((1, 256), jnp.int8), valid=jnp.zeros(1, bool),
    )
    frame = FrameData(
        feats=feats, u_right=jnp.full(n, -1.0), stereo_ok=jnp.zeros(n, bool),
        depth=jnp.full(n, -1.0), lines=lines, line_disp=jnp.zeros((1, 2)),
        line_ok=jnp.zeros(1, bool), sigma2=jnp.ones(n),
    )
    empty = st.PointStore.empty(p)
    pstore = dataclasses.replace(
        empty, x=jnp.asarray(x_w), desc=jnp.asarray(s_desc), valid=jnp.asarray(s_valid)
    )
    return MatchCase(cam, frame, pstore, R, t, local_ids, planted)


def _project(cam: Camera, R, t, x_w):
    xc = np.asarray(x_w, np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    z = xc[:, 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uv = np.stack([float(cam.fx) * xc[:, 0] / zs + float(cam.cx),
                   float(cam.fy) * xc[:, 1] / zs + float(cam.cy)], -1)
    return uv, z


def _pack(d) -> np.ndarray:
    """±1 descriptor rows [M,256] -> [M,4] uint64 bit words."""
    return np.packbits(np.asarray(d) > 0, axis=1).view(np.uint64)


def hamming(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Popcount Hamming distance between ±1 descriptor rows -> [N1,N2] int."""
    b1, b2 = _pack(d1), _pack(d2)
    out = np.empty((b1.shape[0], b2.shape[0]), np.int64)
    for i in range(0, b1.shape[0], 64):  # row blocks bound the [n,P,4] temporary
        out[i:i + 64] = np.bitwise_count(b1[i:i + 64, None, :] ^ b2[None, :, :]).sum(-1)
    return out


def brute_force_match(case: MatchCase, radius: float, max_dist: float, ratio: float) -> dict:
    """Reference result: `idx` (global store slots, as the tracker returns
    them), `best`, `ok`, the raw winning column `col` and the `exempt`
    rows (see the module docstring)."""
    frame, ps = case.frame, case.pstore
    f_uv = np.asarray(frame.feats.uv, np.float64)
    f_valid = np.asarray(frame.feats.valid)
    x = np.asarray(ps.x)
    desc = np.asarray(ps.desc)
    valid = np.asarray(ps.valid)
    if case.local_ids is None:
        rows = np.arange(x.shape[0])
        row_ok = np.ones(x.shape[0], bool)
    else:
        rows = np.maximum(case.local_ids, 0)
        row_ok = case.local_ids >= 0
    uv, z = _project(case.cam, case.R, case.t, x[rows])
    W, H, r = case.cam.width, case.cam.height, float(radius)
    frustum = valid[rows] & row_ok & (z > 0.1) & (uv[:, 0] >= -r) & (uv[:, 0] < W + r) \
        & (uv[:, 1] >= -r) & (uv[:, 1] < H + r)
    ham = hamming(np.asarray(frame.feats.desc), desc[rows])
    d2 = ((f_uv[:, None, :] - uv[None, :, :]) ** 2).sum(-1)
    D = np.where((d2 <= r * r) & frustum[None, :], ham, BIG)
    n = D.shape[0]
    ar = np.arange(n)
    col = np.argmin(D, axis=1)
    best = D[ar, col]
    D2 = D.copy()
    D2[ar, col] = BIG
    second = D2.min(axis=1)
    ok = f_valid & (best <= max_dist)
    if ratio < 1.0:
        ok &= best < ratio * second
    d = np.where(ok, best, BIG)
    col_min = np.full(D.shape[1], BIG)
    np.minimum.at(col_min, col, d)
    ok &= d <= col_min[col]

    border = np.min(np.abs(np.stack([uv[:, 0] + r, uv[:, 0] - W - r,
                                     uv[:, 1] + r, uv[:, 1] - H - r], -1)), -1)
    flippable = (np.abs(d2 - r * r) <= EDGE_PX2) | (
        (border <= FRUSTUM_EDGE_PX)[None, :] & (d2 <= r * r + EDGE_PX2)
    )
    flippable &= (valid[rows] & row_ok & (z > 0.1))[None, :]
    exempt = np.any(flippable & (ham <= second[:, None]), axis=1)
    exempt |= (best < BIG) & (second == best)
    if ratio < 1.0:
        exempt |= (best < BIG) & (np.abs(best - ratio * second) <= 1e-6 * best)
    idx = col if case.local_ids is None else np.where(ok, case.local_ids[col], -1)
    return {"idx": idx, "best": best, "ok": ok, "col": col, "exempt": exempt}


def compare(case: MatchCase, ref: dict, idx, ok) -> dict:
    """Device result (idx, ok from `_match_points_against_store`) against
    the reference. Returns counts; every `*_mismatch` must be 0."""
    idx = np.asarray(idx)
    ok = np.asarray(ok)
    cols = ref["col"] if case.local_ids is None else case.local_ids[ref["col"]]
    ex = ref["exempt"]
    # only an accepted row takes part in the one-row-per-column step
    bad_cols = np.union1d(cols[ex & ref["ok"]], idx[ex & ok])
    ex = ex | np.isin(cols, bad_cols) | (np.isin(idx, bad_cols) & (idx >= 0))
    keep = ~ex
    both = keep & ok & ref["ok"]
    got_best = hamming_rows(case, idx, both)
    return {
        "rows": int(len(ok)),
        "exempt": int(ex.sum()),
        "accepted": int((keep & ref["ok"]).sum()),
        "ok_mismatch": int((ok[keep] != ref["ok"][keep]).sum()),
        "idx_mismatch": int((idx[both] != ref["idx"][both]).sum()),
        "best_mismatch": int((got_best[both] != ref["best"][both]).sum()),
    }


def hamming_rows(case: MatchCase, idx: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Hamming distance of each selected feature to its matched store row."""
    out = np.full(len(idx), -1, np.int64)
    sel = np.nonzero(rows)[0]
    if len(sel):
        f = _pack(np.asarray(case.frame.feats.desc)[sel])
        s = _pack(np.asarray(case.pstore.desc)[idx[sel]])
        out[sel] = np.bitwise_count(f ^ s).sum(-1)
    return out


def planted_recall(case: MatchCase, idx, ok) -> float:
    """Share of planted features matched to their planted store row."""
    idx = np.asarray(idx)
    ok = np.asarray(ok)
    m = (case.planted >= 0) & np.asarray(case.frame.feats.valid)
    return float(((idx == case.planted) & ok)[m].mean())
