"""Test configuration: an 8-device virtual CPU mesh, set before JAX import.

Mirrors the reference CI strategy of exercising the parallel path on a single
machine (``.github/workflows/CI.yml:42-43`` runs the same suite under
``mpirun -np 3``); here the multi-chip path is validated on a virtual device
mesh instead.

The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise.  Tests
marked ``gpu`` need the card and skip without one; run them there with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU device, for tests marked ``gpu``; skips without one.

    Decided here, at run time, so every worker collects the same tests."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return devices[0]
