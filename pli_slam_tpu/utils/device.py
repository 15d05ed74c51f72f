"""Which card a measurement ran on, and a refusal when there is none.

Every timing this repository prints names its device: a number taken on
the CPU is never reported as a device number.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu(devices=None) -> list:
    """Return `devices` (default: `jax.devices()`) if the first is a GPU,
    else raise — measurement paths never fall back to the CPU."""
    devices = list(jax.devices() if devices is None else devices)
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise RuntimeError(f"no GPU visible to JAX (first device platform: {platform})")
    return devices


def card_label() -> str:
    """`name, power.limit` of each card, one line per card, exactly as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them. Raises if the card cannot be read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out
