"""Test harness config: force a CPU backend with 8 virtual devices.

The suite runs on the CPU with XLA's virtual-device trick, so the
multi-device sharding logic is exercised without several cards — the
strategy SURVEY.md §4 prescribes. The platform is set in-process, before
any test module touches a device.

Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them here; `python chip_smoke.py` runs their checks
on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    # Backend already initialized (a plugin touched a device first); the
    # XLA_FLAGS fallback above then decides the device count.
    pass

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices (set jax_num_cpu_devices=8)")
    return jax.devices()[:8]


@pytest.fixture
def gpu_device():
    """A GPU device, or a skip: decided here, never at import time."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
    return gpus[0]
