"""What a measurement names: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess

import jax


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s "name, power.limit" for the cards, read by a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device record of a measurement; raises unless JAX runs on a
    GPU, so a timing is never taken on a fallback platform."""
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {platform!r}")
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}
