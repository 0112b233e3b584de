"""Trainer tests: sharded A2C and PPO steps run, update, and emit
finite metrics on a virtual multi-device CPU mesh.

The reference ships no learner (SURVEY.md §2.11); these cover the
framework's deployment shape — sharded env batches feeding a sharded
learner over mesh collectives (parallel/train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from miniworld_tpu import MiniWorldVec
from miniworld_tpu.parallel import make_mesh, make_ppo_step, make_train_step
from miniworld_tpu.parallel.train import discounted_returns, gae


def _params_delta(a, b):
    return max(
        float(jnp.max(jnp.abs(x - y)))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.fixture(scope="module")
def env():
    return MiniWorldVec("MiniWorld-OneRoomS6Fast-v0", num_envs=8,
                        obs_width=32, obs_height=24)


def test_a2c_step_updates_params(env):
    mesh = make_mesh(2)
    step, init = make_train_step(env, mesh, horizon=3)
    tstate, state, obs, depth = init(jax.random.key(0))
    tstate2, state2, obs2, depth2, m = step(
        tstate, state, obs, depth, jax.random.key(1)
    )
    assert np.isfinite(float(m["loss"]))
    assert _params_delta(tstate["params"], tstate2["params"]) > 0
    # env state advanced
    assert not np.array_equal(
        np.asarray(state.pos), np.asarray(state2.pos)
    )


def test_ppo_step_updates_params(env):
    mesh = make_mesh(2)
    step, init = make_ppo_step(env, mesh, horizon=4, epochs=2,
                               minibatches=2)
    tstate, state, obs, depth = init(jax.random.key(0))
    tstate2, _, _, _, m = step(tstate, state, obs, depth, jax.random.key(1))
    for k in ("loss", "approx_kl", "clip_frac", "return_mean"):
        assert np.isfinite(float(m[k])), k
    # first PPO update: ratios start at 1, so nothing should clip in
    # the very first minibatch — but across epochs some clipping may
    # appear; just require a sane range
    assert 0.0 <= float(m["clip_frac"]) <= 1.0
    assert _params_delta(tstate["params"], tstate2["params"]) > 0


def test_discounted_returns_cut_at_done():
    rewards = jnp.array([[1.0], [1.0], [1.0]])
    dones = jnp.array([[False], [True], [False]])
    boot = jnp.array([10.0])
    ret = discounted_returns(rewards, dones, boot, gamma=0.5)
    # t=2: 1 + 0.5*10 = 6 ; t=1: done -> 1 ; t=0: 1 + 0.5*1 = 1.5
    np.testing.assert_allclose(np.asarray(ret[:, 0]), [1.5, 1.0, 6.0])


def test_gae_matches_direct_recursion():
    key = jax.random.key(3)
    T, B = 5, 4
    kr, kd, kv, kb = jax.random.split(key, 4)
    rewards = jax.random.uniform(kr, (T, B))
    dones = jax.random.bernoulli(kd, 0.3, (T, B))
    values = jax.random.uniform(kv, (T, B))
    boot = jax.random.uniform(kb, (B,))
    gamma, lam = 0.9, 0.8
    adv = np.asarray(gae(rewards, dones, values, boot, gamma, lam))

    v_next = np.concatenate(
        [np.asarray(values[1:]), np.asarray(boot)[None]], axis=0
    )
    nonterm = 1.0 - np.asarray(dones).astype(np.float32)
    delta = np.asarray(rewards) + gamma * nonterm * v_next - np.asarray(values)
    want = np.zeros((T, B), np.float32)
    acc = np.zeros(B, np.float32)
    for t in reversed(range(T)):
        acc = delta[t] + gamma * lam * nonterm[t] * acc
        want[t] = acc
    np.testing.assert_allclose(adv, want, rtol=1e-5, atol=1e-6)


def test_multihost_init_fail_fast(monkeypatch):
    """Failure injection (SURVEY.md §5): with a coordinator address
    configured, init gets the configured address/count/id and its error
    RAISES instead of degrading to a silent single-process run; without
    one, distributed init is not attempted at all."""
    from miniworld_tpu.parallel import mesh as pmesh

    calls = []

    def boom(**kwargs):
        calls.append(kwargs)
        raise RuntimeError("injected: coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="injected"):
        pmesh.init_multihost()
    assert calls == [{"coordinator_address": "10.0.0.1:1234",
                      "num_processes": 2, "process_id": 1}]

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    pmesh.init_multihost()  # must not raise, nor call initialize
    assert len(calls) == 1


def test_continuous_gaussian_head():
    """Envs without a discrete action table train through the diagonal-
    Gaussian head: actions are 6-D Box vectors (the reference's raw
    continuous convention, miniworld.py:616-652), the log-prob/entropy
    terms are finite, and both A2C and PPO update every param including
    log_std's gradient path."""
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0", num_envs=8,
                       obs_width=32, obs_height=24)
    env.set_discrete_actions(None)  # force the continuous Box(6) space
    mesh = make_mesh(2)

    step, init = make_train_step(env, mesh, horizon=3)
    tstate, state, obs, depth = init(jax.random.key(0))
    assert "log_std" in tstate["params"]
    tstate2, state2, obs2, depth2, m = step(
        tstate, state, obs, depth, jax.random.key(1)
    )
    assert np.isfinite(float(m["loss"]))
    assert _params_delta(tstate["params"], tstate2["params"]) > 0

    pstep, pinit = make_ppo_step(env, mesh, horizon=4, epochs=2,
                                 minibatches=2)
    tstate, state, obs, depth = pinit(jax.random.key(2))
    tstate2, _, _, _, m = pstep(tstate, state, obs, depth, jax.random.key(3))
    for k in ("loss", "approx_kl", "clip_frac", "return_mean"):
        assert np.isfinite(float(m[k])), k
    assert _params_delta(tstate["params"], tstate2["params"]) > 0
