"""Test configuration: CPU backend with a faked 8-device mesh.

The reference tests on a single Metal device; here the suite runs without
a GPU: the CPU backend with ``--xla_force_host_platform_device_count=8``
so sharding / ring-attention tests exercise real mesh code paths
(SURVEY.md §4), and the Pallas kernels in interpret mode, which the suite
asks for through ``FLASH_ATTENTION_INTERPRET=1``.

Tests marked ``gpu`` need an NVIDIA GPU: they skip here and run on the
card from ``chip_smoke.py``, which sets ``JAX_PLATFORMS=cuda`` before
calling pytest; this file then leaves the backend alone.
"""

import os

ON_CARD = os.environ.get("JAX_PLATFORMS") == "cuda"

if not ON_CARD:
    # Must be set before jax initializes its backends.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLASH_ATTENTION_INTERPRET"] = "1"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
    assert len(jax.devices()) == 8, "tests expect an 8-device virtual mesh"

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _card_only(request):
    """``gpu``-marked tests run only where JAX's backend is the GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


@pytest.fixture
def rng_key():
    # Seed 42 mirrors the reference's mt19937(42) fixture (main.mm:25).
    return jax.random.PRNGKey(42)
