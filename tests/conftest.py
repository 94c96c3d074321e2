import os

import pytest

# The suite runs on the CPU backend, with a virtual 8-device mesh for
# the sharding tests.  Tests that need the card carry the ``gpu``
# marker and run on it through ``python chip_smoke.py``, which starts
# JAX on the GPU before pytest imports this file (these defaults then
# change nothing).
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU
    (decided per test, never at import)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (run: python chip_smoke.py)")
