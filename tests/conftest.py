"""Test configuration: JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU: Pallas kernels in interpret mode, sharding tests
on 8 virtual devices.  The platform is forced here, before any backend
initializes.  Tests that need a GPU carry the ``gpu`` marker and skip here
(a fixture decides when the test runs); ``python chip_smoke.py`` runs the
same checks on the card.
"""
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")
