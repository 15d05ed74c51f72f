"""Entry-point plumbing: the compile-cache helper and chip_smoke.py's
device refusal and result line."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    code = ("from pli_slam_tpu.utils.compile_cache import enable_compile_cache; "
            "print(enable_compile_cache())")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    target = str(tmp_path / "elsewhere")
    assert _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": target}) == target


def test_compile_cache_default_is_fixed_path_in_checkout():
    first = _cache_dir_in_child({})
    assert first == os.path.join(REPO, ".jax_cache")
    # no process id or time in the path: a second process gets the same one
    assert _cache_dir_in_child({}) == first


def test_chip_smoke_refuses_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device(jax.devices("cpu"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line_has_exactly_the_contract_keys():
    import chip_smoke

    line = chip_smoke.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                   "count": 1, "extra": "dropped"})
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
