"""Test configuration: CPU backend with a virtual 8-device mesh.

Tests run on the CPU (measurements run on the GPU through
``chip_smoke.py``; tests that need the card carry the ``gpu`` marker)
with:
  * 8 virtual devices so multi-device sharding paths are exercised;
  * XLA backend optimization disabled — XLA:CPU's LLVM pipeline has
    pathological compile times on some scatter/gather graphs (order of
    minutes for our step function).
"""

import os

# Force CPU even when the environment selects an accelerator backend:
# tests must be hermetic.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (
    flags
    + " --xla_force_host_platform_device_count=8"
    + " --xla_backend_optimization_level=0"
)

import jax  # noqa: E402

# Also set in JAX's config after import, which wins over any platform
# list set in code before the tests start.
jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    XLA:CPU segfaults in backend_compile_and_load once a single process
    has accumulated a few hundred live compiled programs (reproducible
    at the same spot in a full-suite run; the same test passes in a
    fresh process). Releasing executables bounds the JIT state and
    keeps the one-process suite stable.
    """
    yield
    jax.clear_caches()
