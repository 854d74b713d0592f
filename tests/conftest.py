"""Test configuration: run on CPU with 8 virtual devices.

Fast core: ``pytest -m "not slow"`` deselects the >12 s tests (golden
image comparisons, multi-frame animation equivalence, PSNR measurements)
for quick iteration; the default run includes everything.

Multi-device sharding tests use XLA's host-platform device-count flag, so
meshes of up to 8 devices run without accelerators.

The suite pins the CPU platform before any backend is touched, so it gives
the same results on any machine.  The tests marked ``gpu`` need the card:
run them there with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``
(they skip, with a reason, wherever JAX finds no GPU).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never at import, so every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
