"""The gated matcher on the card, at production widths, against the NumPy
brute force (phase 2 of chip_smoke.py as a test).

Marked `gpu`: it needs a card and skips without one. Whether a card is
present is decided inside the fixture, never at import.
"""

from functools import partial

import jax
import jax.numpy as jnp
import pytest

from pli_slam_tpu.frontend import match_reference as mr
from pli_slam_tpu.frontend.tracker import _match_points_against_store
from pli_slam_tpu.utils.config import SlamConfig

pytestmark = pytest.mark.gpu

CFG = SlamConfig.euroc_stereo()


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.mark.parametrize("n_local", [4096, None], ids=["local-4096", "store-16384"])
def test_matcher_parity_on_card(gpu, n_local):
    case = mr.planted_case(1200, 16384, seed=11, n_local=n_local)
    fn = jax.jit(partial(_match_points_against_store, case.cam, CFG))
    local = None if n_local is None else jnp.asarray(case.local_ids)
    for radius in (CFG.match.search_radius_px, 6.0):
        idx, ok, _ = fn(case.frame, case.R, case.t, case.pstore, radius, local)
        assert idx.devices() == {gpu}
        ref = mr.brute_force_match(case, radius, CFG.match.orb_th_high, CFG.match.nn_ratio)
        cmp = mr.compare(case, ref, idx, ok)
        assert cmp["ok_mismatch"] == 0 and cmp["idx_mismatch"] == 0, cmp
        assert cmp["best_mismatch"] == 0, cmp
        assert cmp["exempt"] < 0.1 * cmp["rows"], cmp
        assert mr.planted_recall(case, idx, ok) >= 0.95
