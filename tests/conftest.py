import os

import pytest

# Tests run on the CPU backend with 8 virtual devices, so the mesh tests
# shard over a real (virtual) multi-device mesh. JAX_PLATFORMS set by the
# caller wins: `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs the
# card-only tests on a GPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from twenty_first_tpu.config import enable_compilation_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
enable_compilation_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU. Decided when the test
    runs, never at import, so every xdist worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return jax.devices()[0]
