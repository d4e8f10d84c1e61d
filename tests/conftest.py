"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Must set env vars before jax is first imported (sharding tests use the
virtual device mesh; float64 lets parity oracles run at numpy precision).
``JAX_PLATFORMS=cuda,cpu`` keeps the GPU for the ``-m gpu`` tests, which
find the card through the ``gpu`` fixture and skip without one.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: on the card run "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
