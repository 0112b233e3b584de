"""Counter-based cheap uniforms for per-env reset randomness.

jax.random primitives lowered threefry as a ROLLED while-loop on the
chip this was tuned for; vmapped over thousands of envs inside the
auto-reset path, the loop latency dominated the draw cost (not yet
measured on the GPU). Reset-time randomness
(spawn rejection sampling, variant picks, maze DFS choices) does not
need cryptographic-strength streams, so it is derived instead from a
Wang/lowbias32-style integer mix keyed on (seed, counter) — pure
elementwise work, no loop. The same construction already drives
per-episode texture-variant draws (raycast.hash01, round 1) and is
distribution-tested there and in tests/test_procgen.py.

The per-env ``seed`` comes from the env's reset key's underlying data
words (cheap_seed) — the key itself is produced by an upstream
jax.random.split, so its words are already uniform; no extra threefry
is spent. Purposes are separated by deriving a subseed per purpose
(sub), then counting within it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hash01(key: jax.Array, ids: jax.Array) -> jax.Array:
    """Uniform in [0, 1) keyed on (key, id); 24-bit resolution.

    Wang/lowbias32-style integer mix — same id under the same key gives
    the same draw (counter-based, stateless).
    """
    x = ids.astype(jnp.uint32) * jnp.uint32(0x9E3779B9) ^ key
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def hash_u32(key: jax.Array, ids: jax.Array) -> jax.Array:
    """Full-width u32 mix of (key, id) — subseed derivation."""
    x = ids.astype(jnp.uint32) * jnp.uint32(0x9E3779B9) ^ key
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def cheap_seed(key: jax.Array) -> jax.Array:
    """() u32 seed from a typed PRNG key's data words (no threefry).

    The key's words are themselves outputs of an upstream threefry
    split, i.e. already uniform; mixing them preserves that. Works for
    any impl (threefry 2 words, rbg 4): fold first and last.
    """
    kd = jax.random.key_data(key).astype(jnp.uint32)
    return kd[..., 0] ^ (kd[..., -1] * jnp.uint32(0x9E3779B9))


def sub(seed: jax.Array, purpose: int) -> jax.Array:
    """Purpose-separated subseed."""
    return hash_u32(seed, jnp.uint32(purpose))


def uniforms(seed: jax.Array, purpose: int, shape) -> jax.Array:
    """Uniform [0, 1) tensor keyed on (seed, purpose)."""
    n = 1
    for s in shape:
        n *= int(s)
    return hash01(sub(seed, purpose),
                  jnp.arange(n, dtype=jnp.uint32)).reshape(shape)
