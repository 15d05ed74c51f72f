"""The tracker's gated point matcher against the NumPy brute force.

`_match_points_against_store` is the only matcher the tracker uses: one
XLA program of int8 Hamming product, window/frustum gate, nearest
neighbour, ratio test and one-row-per-column dedup. Every case runs
with the whole store and through a local-map subset (`local_ids`).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pli_slam_tpu.frontend import match_reference as mr
from pli_slam_tpu.frontend.tracker import _match_points_against_store
from pli_slam_tpu.utils.config import SlamConfig

CFG = SlamConfig.euroc_stereo()
MAX_DIST = CFG.match.orb_th_high
RATIO = CFG.match.nn_ratio


def run(case, radius):
    fn = jax.jit(partial(_match_points_against_store, case.cam, CFG))
    local = None if case.local_ids is None else jnp.asarray(case.local_ids)
    idx, ok, _ = fn(case.frame, case.R, case.t, case.pstore, radius, local)
    return np.asarray(idx), np.asarray(ok)


@pytest.mark.parametrize("p,n_local", [(4096, None), (8192, 4096)], ids=["store", "local"])
def test_parity_at_tracking_width(p, n_local):
    """N=1200 features against 4096 candidate rows, the tracker's
    local-map width: a 4096-row store, or a 4096-row local map of an
    8192-row store."""
    case = mr.planted_case(1200, p, seed=5, n_local=n_local)
    for radius in (15.0, 6.0):
        idx, ok = run(case, radius)
        ref = mr.brute_force_match(case, radius, MAX_DIST, RATIO)
        cmp = mr.compare(case, ref, idx, ok)
        assert cmp["ok_mismatch"] == 0, cmp
        assert cmp["idx_mismatch"] == 0, cmp
        assert cmp["best_mismatch"] == 0, cmp
        assert cmp["accepted"] > 600, cmp
        assert cmp["exempt"] < 0.1 * cmp["rows"], cmp


@pytest.mark.parametrize("n_local", [None, 256], ids=["store", "local"])
def test_planted_recall(n_local):
    case = mr.planted_case(300, 1024, seed=6, n_local=n_local, max_flips=40)
    idx, ok = run(case, 15.0)
    assert mr.planted_recall(case, idx, ok) >= 0.98
    # random (unplanted) features essentially never pass the distance cap
    rand = (case.planted < 0) & np.asarray(case.frame.feats.valid)
    assert ok[rand].mean() < 0.02


def place(case, rows, uv, z=4.0):
    """Move store rows so they project to pixel `uv` at depth z; every
    other store row becomes invalid."""
    R = case.R.astype(np.float64)
    fx, fy, cx, cy = (float(v) for v in (case.cam.fx, case.cam.fy, case.cam.cx, case.cam.cy))
    xc = np.array([(uv[0] - cx) / fx * z, (uv[1] - cy) / fy * z, z])
    x = np.asarray(case.pstore.x).copy()
    x[rows] = ((xc - case.t) @ R).astype(np.float32)
    valid = np.zeros(x.shape[0], bool)
    valid[rows] = True
    return dataclasses.replace(case, pstore=dataclasses.replace(
        case.pstore, x=jnp.asarray(x), valid=jnp.asarray(valid)))


def with_feature_desc(case, i, desc, uv):
    f = case.frame.feats
    feats = dataclasses.replace(
        f, desc=f.desc.at[i].set(jnp.asarray(desc)),
        uv=f.uv.at[i].set(jnp.asarray(uv, jnp.float32)), valid=f.valid.at[i].set(True))
    return dataclasses.replace(case, frame=dataclasses.replace(case.frame, feats=feats))


def flipped(desc, k, offset):
    d = np.asarray(desc).copy()
    d[offset:offset + k] *= -1
    return d


@pytest.mark.parametrize("n_local", [None, 64], ids=["store", "local"])
def test_ratio_test_rejects_ties_and_accepts_clear_winner(n_local):
    case = mr.planted_case(4, 128, seed=7, n_local=n_local, planted_frac=0.0)
    a, b = (case.local_ids[:2] if n_local else (10, 20))
    uv = np.array([300.0, 200.0])
    case = place(case, [a, b], uv)
    base = np.asarray(case.frame.feats.desc)[0]
    sdesc = np.asarray(case.pstore.desc).copy()

    # tie: both rows at Hamming 8 from the feature -> best == second
    sdesc[a] = flipped(base, 8, 0)
    sdesc[b] = flipped(base, 8, 100)
    tie = dataclasses.replace(case, pstore=dataclasses.replace(case.pstore, desc=jnp.asarray(sdesc)))
    tie = with_feature_desc(tie, 0, base, uv + 1.0)
    idx, ok = run(tie, 15.0)
    assert not ok[0]

    # clear winner: 2 bits against 60 bits
    sdesc[a] = flipped(base, 2, 0)
    sdesc[b] = flipped(base, 60, 100)
    win = dataclasses.replace(case, pstore=dataclasses.replace(case.pstore, desc=jnp.asarray(sdesc)))
    win = with_feature_desc(win, 0, base, uv + 1.0)
    idx, ok = run(win, 15.0)
    assert ok[0] and idx[0] == a


@pytest.mark.parametrize("n_local", [None, 64], ids=["store", "local"])
def test_dedup_keeps_closer_row_per_column(n_local):
    """Two features whose nearest store row is the same column: only the
    one at the smaller Hamming distance keeps the match."""
    case = mr.planted_case(4, 128, seed=8, n_local=n_local, planted_frac=0.0)
    a = case.local_ids[0] if n_local else 10
    uv = np.array([400.0, 150.0])
    case = place(case, [a], uv)
    sd = np.asarray(case.pstore.desc)[a]
    case = with_feature_desc(case, 0, flipped(sd, 12, 0), uv + 2.0)
    case = with_feature_desc(case, 1, flipped(sd, 3, 50), uv - 2.0)
    idx, ok = run(case, 15.0)
    assert ok[1] and idx[1] == a
    assert not ok[0]
    ref = mr.brute_force_match(case, 15.0, MAX_DIST, RATIO)
    np.testing.assert_array_equal(ok, ref["ok"])


def test_parity_check_detects_a_wrong_window():
    """The comparison is not vacuous: a matcher run with a window 4 px too
    narrow disagrees with the reference."""
    case = mr.planted_case(1200, 4096, seed=9)
    idx, ok = run(case, 2.0)
    ref = mr.brute_force_match(case, 6.0, MAX_DIST, RATIO)
    cmp = mr.compare(case, ref, idx, ok)
    assert cmp["ok_mismatch"] + cmp["idx_mismatch"] > 0, cmp
