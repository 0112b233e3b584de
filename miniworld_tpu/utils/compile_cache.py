"""JAX's persistent compilation cache, for the entry-point scripts.

Compiling the fused rollout and the train steps is most of a cold run's
set-up time. Entry points call ``enable()`` before they compile
anything; importing the package enables nothing, so tests and library
users keep JAX's own behaviour.
"""

from __future__ import annotations

import os

import jax

# Fixed and inside the checkout (git-ignored): the directory is part of
# what makes a later run find the entries, so it never varies by
# process, user or time.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed; a directory configured in code is kept too.
    Otherwise the cache goes to ``DEFAULT_DIR``.
    """
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
