"""Test configuration: two tiers.

Default tier — everything on a virtual 8-device CPU mesh: multi-device
sharding is validated without accelerators via
``xla_force_host_platform_device_count`` (SURVEY.md §4).  Must run before
the first ``import jax`` anywhere in the test session.

GPU tier — tests marked ``gpu`` compile the Pallas anneal kernel for the
card and compare it with the XLA samplers and the exact oracle.  They take
the ``gpu`` fixture, which skips them when JAX finds no GPU.  On a machine
with a card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""

import os

if not any(p in os.environ.get("JAX_PLATFORMS", "") for p in ("cuda", "gpu")):
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)",
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, at
    run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)
