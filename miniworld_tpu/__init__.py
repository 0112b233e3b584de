"""miniworld_tpu: a batched MiniWorld engine in JAX.

Brand-new implementation of the NomanTrips/Miniworld environment suite
for accelerators: fixed-shape array worlds, pure jitted physics, a software
raycaster replacing OpenGL, vectorized thousands-of-envs stepping with
on-device auto-reset, and a gymnasium-compatible adapter.
"""

__version__ = "0.1.0"

from miniworld_tpu.envs import ENV_IDS, make_spec  # noqa: F401
from miniworld_tpu.vector import MiniWorldVec  # noqa: F401


def register_gym(prefix: str = ""):
    """Register all env IDs with gymnasium (lazy import)."""
    from miniworld_tpu.gym_env import register_gym as _impl

    return _impl(prefix)
