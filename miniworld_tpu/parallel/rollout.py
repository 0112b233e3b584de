"""Rollout-only sharding: experience generation over a device mesh
with no learner attached.

The deployment shape for dataset generation / evaluation / actor-side
of a disaggregated learner: env state lives sharded over the ``data``
mesh axis, every device steps and renders its own shard, and — because
envs are independent — the compiled program must contain ZERO
cross-device collectives (checked by ``compiled_has_collectives``; the
weak-scaling test in tests/test_multichip.py asserts it per mesh
size). Collectives belong to the learner (parallel/train.py gradient
psum) only.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from miniworld_tpu.parallel.mesh import (
    DATA_AXIS, local_rows, replicate, shard_env_batch,
)

_COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "all-to-all", "collective-permute",
    "reduce-scatter", "collective-broadcast",
)


def replicated_tables(env, mesh):
    """``get() -> (bank, atlas)``: the env's tables replicated over
    ``mesh``, copied once per bank the env installs (refresh_layouts
    swaps it). Passing the env's single-device arrays to a mesh program
    would copy them to every device on every call."""
    held = []  # [source pair, replicated pair]

    def get():
        src = (env._bank, env._atlas)
        if not held or held[0][0] is not src[0] or held[0][1] is not src[1]:
            held[:] = [src, replicate(mesh, src)]
        return held[1]

    return get


def make_sharded_rollout(env, mesh, horizon: int, *, policy=None):
    """Build a sharded fused rollout over ``mesh``'s data axis.

    Returns a namespace with:
      init(key) -> (state, obs, depth)     sharded reset
      step(state, obs, depth, key) -> (state, obs, depth, outs)
        outs leaves are per-step metrics, stacked per shard along
        axis 0: shape (n_shards * horizon,), reshapeable to
        (n_shards, horizon)
      compiled_has_collectives(*args) -> bool   HLO inspection hook

    The default random policy draws each env's action by its global
    index (``local_rows``), so results do not depend on the mesh size.
    A custom ``policy(obs, depth, key)`` receives the per-step key
    unchanged on every shard.

    (Learners that need stacked per-env observations/actions shard
    through make_train_step/make_ppo_step instead — their rollouts run
    inside the sharded train step.)
    """

    def random_policy(obs, depth, key):
        n_local = jax.tree.leaves(obs)[0].shape[0]
        return local_rows(env.sample_actions, key, env.num_envs, n_local)

    base = env.rollout_fn(horizon, policy=policy or random_policy)

    sharded = shard_map(
        base, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    fn = jax.jit(sharded)
    tables = replicated_tables(env, mesh)

    def init(key):
        keys = jax.random.split(key, env.num_envs)
        state = env._reset_jit(env._bank, keys)
        obs, depth = env._render_jit(env._bank, env._atlas, state)
        state = shard_env_batch(mesh, state)
        obs = shard_env_batch(mesh, obs)
        depth = shard_env_batch(mesh, depth)
        return state, obs, depth

    def step(state, obs, depth, key):
        return fn(*tables(), state, obs, depth, key)

    def compiled_has_collectives(state, obs, depth, key) -> bool:
        txt = fn.lower(*tables(), state, obs, depth, key).compile().as_text()
        return any(op in txt for op in _COLLECTIVE_OPS)

    return SimpleNamespace(
        init=init, step=step, fn=fn,
        compiled_has_collectives=compiled_has_collectives,
    )
