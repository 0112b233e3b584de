"""Multi-device sharding contracts on the virtual 8-device CPU mesh.

Weak scaling across 2/4/8 devices with the SAME per-device batch, and
collective placement: the rollout-only program must compile with zero
cross-device collectives (the env axis is embarrassingly parallel),
while the train step must contain the learner's gradient all-reduce —
exactly the layout the scaling recipe prescribes (collectives appear
only where state is logically shared).
"""

import jax
import numpy as np
import pytest

from miniworld_tpu import MiniWorldVec
from miniworld_tpu.parallel import (
    make_mesh, make_sharded_rollout, make_train_step,
)

PER_DEVICE = 2
W, H = 32, 24


@pytest.fixture(autouse=True)
def _eight_devices():
    """Decided per test, not at import: every xdist worker must collect
    the same tests."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual mesh (tests/conftest.py)")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_rollout_weak_scaling_no_collectives(n_dev):
    mesh = make_mesh(n_dev)
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0",
                       num_envs=PER_DEVICE * n_dev,
                       obs_width=W, obs_height=H)
    roll = make_sharded_rollout(env, mesh, horizon=2)
    state, obs, depth = roll.init(jax.random.key(0))
    # every shard really lives on its own device
    assert len(state.pos.sharding.device_set) == n_dev
    state, obs, depth, outs = roll.step(state, obs, depth, jax.random.key(1))
    sums = np.asarray(outs["obs_sum"])
    assert sums.shape == (n_dev * 2,) and np.isfinite(sums).all()
    # collectives appear ONLY in the learner — never in pure rollout
    assert not roll.compiled_has_collectives(state, obs, depth,
                                             jax.random.key(1))


def test_shards_step_independently():
    """Same per-device envs + same fold-in keys => shard 0 of a 2-dev
    mesh computes the same metrics as device 0 of a 4-dev mesh (weak
    scaling leaves per-shard work untouched)."""
    outs = {}
    for n_dev in (2, 4):
        mesh = make_mesh(n_dev)
        env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0",
                           num_envs=PER_DEVICE * n_dev,
                           obs_width=W, obs_height=H)
        roll = make_sharded_rollout(env, mesh, horizon=3)
        state, obs, depth = roll.init(jax.random.key(7))
        *_, o = roll.step(state, obs, depth, jax.random.key(8))
        outs[n_dev] = np.asarray(o["reward"]).reshape(n_dev, 3)
    # NOTE: shard 0's envs are reset from the same per-env keys in both
    # meshes (split(key, num_envs) gives the first PER_DEVICE keys to
    # shard 0) and stepped with the same folded key
    np.testing.assert_allclose(outs[2][0], outs[4][0], rtol=1e-6)


def test_train_step_has_learner_collective():
    mesh = make_mesh(4)
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0",
                       num_envs=PER_DEVICE * 4, obs_width=W, obs_height=H)
    step, init = make_train_step(env, mesh, horizon=2)
    tstate, state, obs, depth = init(jax.random.key(0))
    from miniworld_tpu.parallel import shard_env_batch

    state = shard_env_batch(mesh, state)
    obs = shard_env_batch(mesh, obs)
    depth = shard_env_batch(mesh, depth)
    txt = step.lower(
        tstate, state, obs, depth, jax.random.key(1)
    ).compile().as_text()
    assert "all-reduce" in txt


def test_refresh_layouts_under_sharding():
    """Recompile-free bank refresh on a sharded env: swapping in a regenerated layout bank mid-rollout must
    not retrace the sharded program (banks are jit ARGUMENTS) and the
    new geometry must be visible on every shard."""
    from miniworld_tpu.envs.nav import MazeS3
    from miniworld_tpu.parallel import make_mesh, make_sharded_rollout

    n_dev = 4
    mesh = make_mesh(n_dev)
    env = MiniWorldVec(MazeS3(num_layouts=4), num_envs=PER_DEVICE * n_dev,
                       obs_width=W, obs_height=H, procgen=False)
    roll = make_sharded_rollout(env, mesh, horizon=2)
    state, obs, depth = roll.init(jax.random.key(0))
    state, obs, depth, outs = roll.step(state, obs, depth, jax.random.key(1))
    n_compiles = roll.fn._cache_size()
    assert len(state.pos.sharding.device_set) == n_dev

    old_verts = env._bank_np.tri_verts.copy()
    rgb0, _ = env._render_jit(env._bank, env._atlas, state)
    env.refresh_layouts(31337)
    # same shapes (jit-argument swap), different geometry
    assert env._bank_np.tri_verts.shape == old_verts.shape
    assert np.any(env._bank_np.tri_verts != old_verts)
    # the refreshed geometry shows up in-place on EVERY shard: the same
    # sharded states render different pixels against the new bank
    rgb1, _ = env._render_jit(env._bank, env._atlas, state)
    changed = (np.asarray(rgb0) != np.asarray(rgb1)).reshape(
        n_dev, PER_DEVICE, -1).any(axis=(1, 2))
    assert changed.all(), changed

    # the sharded rollout keeps running on its ORIGINAL compiled
    # program (no retrace) with the swapped bank
    state, obs, depth, outs = roll.step(state, obs, depth, jax.random.key(2))
    assert np.isfinite(np.asarray(outs["obs_sum"])).all()
    assert roll.fn._cache_size() == n_compiles
