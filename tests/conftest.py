"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``) over a virtual 8-device mesh,
so sharding logic is exercised without several cards.  What needs a card
is marked ``gpu`` and skips here; ``chip_smoke.py`` runs those checks on
the card itself.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from tnsh.core.params import setup_params  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips where JAX has none"
    )


@pytest.fixture
def gpu():
    """Skip the requesting test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")


@pytest.fixture(scope="session")
def params3():
    return setup_params(3)


@pytest.fixture(scope="session")
def params4():
    return setup_params(4)
