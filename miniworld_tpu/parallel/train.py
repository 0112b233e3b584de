"""Sharded train step: env rollout + A2C learner over a device mesh.

One jitted program per call: under ``shard_map`` each device steps its
shard of the env batch (rollout with the current policy), computes
learner gradients locally, and joins a single ``pmean`` — sharded envs
feeding a data-parallel learner. ``__graft_entry__.dryrun_multichip``
and ``chip_smoke.py --gpus 4`` run it across devices.

The gradient is computed on the transitions the policy itself produced:
``rollout_fn(return_obs=True, return_actions=True)`` records the
acted-on observations, the sampled actions, per-env rewards and done
flags; returns are n-step discounted sums bootstrapped from the critic
at the post-rollout observation, cut at auto-reset boundaries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from miniworld_tpu.parallel import learner as L
from miniworld_tpu.parallel.mesh import DATA_AXIS, local_rows
from miniworld_tpu.parallel.rollout import replicated_tables


def discounted_returns(rewards, dones, bootstrap, gamma: float):
    """(T, B) rewards/dones + (B,) bootstrap -> (T, B) n-step returns.

    ``R_t = r_t + gamma * (1 - done_t) * R_{t+1}`` with
    ``R_T = V(obs_T)``; done cuts the tail because auto-reset makes
    ``obs_{t+1}`` the first observation of a NEW episode.
    """

    def back(ret_next, x):
        r, d = x
        ret = r + gamma * jnp.where(d, 0.0, ret_next)
        return ret, ret

    _, returns = jax.lax.scan(back, bootstrap, (rewards, dones), reverse=True)
    return returns


def gae(rewards, dones, values, bootstrap, gamma: float, lam: float):
    """Generalized advantage estimation over a rollout.

    (T, B) rewards/dones/values + (B,) bootstrap value of the
    post-rollout observation -> (T, B) advantages.

        delta_t = r_t + gamma * (1 - done_t) * V_{t+1} - V_t
        A_t     = delta_t + gamma * lam * (1 - done_t) * A_{t+1}

    done cuts both terms because auto-reset makes ``obs_{t+1}`` the
    first observation of a new episode.
    """

    def back(carry, x):
        adv_next, v_next = carry
        r, d, v = x
        nonterm = 1.0 - d.astype(jnp.float32)
        delta = r + gamma * nonterm * v_next - v
        adv = delta + gamma * lam * nonterm * adv_next
        return (adv, v), adv

    _, advs = jax.lax.scan(
        back, (jnp.zeros_like(bootstrap), bootstrap),
        (rewards, dones, values), reverse=True,
    )
    return advs


def _policy_spec(env) -> tuple[int, bool]:
    """(action_dim, continuous) for the env's action space: categorical
    over a discrete table / spec.num_actions when present, otherwise a
    diagonal-Gaussian head over the raw Box space (2-D click coords or
    the reference's 6-D action vector, miniworld.py:616-652)."""
    if env._action_table is not None:
        return env._action_table.shape[0], False
    if getattr(env.spec, "num_actions", 0):
        return env.spec.num_actions, False
    if getattr(env.spec, "click_action", False):
        return 2, True
    return 6, True


def _policy_factory(params, continuous: bool, n_global: int):
    """Policy for the sharded rollout. Its noise is drawn per env by
    global index (``local_rows``), so a step samples the same actions
    whatever the mesh size."""

    def policy(obs, depth, key):
        # the IMAGE leaf (dict-obs envs like Sign put a scalar goal
        # leaf first in tree.leaves order)
        rgb = obs["obs"] if isinstance(obs, dict) else obs
        out, _ = L.forward(params, rgb, depth)
        n_local, width = out.shape
        if continuous:
            eps = local_rows(
                lambda k, n: jax.random.normal(k, (n, width), out.dtype),
                key, n_global, n_local,
            )
            return L.gaussian_sample(params, out, eps)
        # Gumbel-max: the draw jax.random.categorical makes
        gumbel = local_rows(
            lambda k, n: jax.random.gumbel(k, (n, width), out.dtype),
            key, n_global, n_local,
        )
        return jnp.argmax(out + gumbel, axis=-1)
    return policy


def _flat_actions(actions, n: int, continuous: bool):
    """(T, B[, A]) rollout actions -> the loss's flat batch layout."""
    if continuous:
        return actions.reshape(n, actions.shape[-1])
    return actions.reshape(n).astype(jnp.int32)


def make_train_step(env, mesh, horizon: int = 4, lr: float = 3e-4,
                    gamma: float = 0.99):
    """Build ``train_step(bank, atlas, tstate, state, obs, depth, key)``.

    ``env`` is a MiniWorldVec whose ``num_envs`` is the GLOBAL batch;
    each chip runs ``num_envs / n_devices`` envs. Returns the jitted
    step and an ``init(key)`` helper producing the train state
    ``{"params", "opt"}`` and sharded env state.
    """
    n_dev = mesh.devices.size
    assert env.num_envs % n_dev == 0, (env.num_envs, n_dev)
    num_actions, continuous = _policy_spec(env)

    def local_train(bank, atlas, tstate, state, obs, depth, key):
        params = tstate["params"]
        rollout = env.rollout_fn(
            horizon, policy=_policy_factory(params, continuous, env.num_envs),
            return_obs=True, return_actions=True)
        state, obs, depth, outs = rollout(bank, atlas, state, obs, depth, key)

        # transitions the policy actually produced: obs[t] -> actions[t]
        rgb_t = jax.tree.leaves(outs["obs"])[0]  # (T, B, H, W, 3)
        T, B = rgb_t.shape[0], rgb_t.shape[1]
        dep_t = outs.get(
            "depth", jnp.zeros(rgb_t.shape[:4] + (1,), jnp.float32)
        )
        # bootstrap the tail from the critic at the post-rollout obs
        _, v_boot = L.forward(
            params, obs["obs"] if isinstance(obs, dict) else obs, depth
        )
        returns = discounted_returns(
            outs["rewards"], outs["done_mask"],
            jax.lax.stop_gradient(v_boot), gamma,
        )

        params, opt, loss = L.grad_step(
            params, tstate["opt"],
            rgb_t.reshape(T * B, *rgb_t.shape[2:]),
            dep_t.reshape(T * B, *dep_t.shape[2:]),
            _flat_actions(outs["actions"], T * B, continuous),
            returns.reshape(T * B),
            lr=lr, axis_name=DATA_AXIS,
        )
        metrics = {
            "loss": loss,
            "reward": jax.lax.psum(outs["reward"].sum(), DATA_AXIS),
            "dones": jax.lax.psum(outs["dones"].sum(), DATA_AXIS),
            "return_mean": jax.lax.pmean(returns.mean(), DATA_AXIS),
        }
        return {"params": params, "opt": opt}, state, obs, depth, metrics

    pspec_env = P(DATA_AXIS)
    pspec_rep = P()
    train = shard_map(
        local_train, mesh=mesh,
        in_specs=(pspec_rep, pspec_rep, pspec_rep, pspec_env, pspec_env,
                  pspec_env, pspec_rep),
        out_specs=(pspec_rep, pspec_env, pspec_env, pspec_env, pspec_rep),
        check_vma=False,
    )
    train_jit = jax.jit(train)
    tables = replicated_tables(env, mesh)

    def step(tstate, state, obs, depth, key):
        return train_jit(*tables(), tstate, state, obs, depth, key)

    # HLO-inspection hook (tests assert the gradient all-reduce exists)
    step.lower = lambda *a: train_jit.lower(*tables(), *a)
    return step, _make_init(env, num_actions, continuous)


def _make_init(env, num_actions: int, continuous: bool = False):
    """``init(key) -> (tstate, state, obs, depth)`` for a fresh run."""

    def init(key):
        k_env, k_par = jax.random.split(key)
        keys = jax.random.split(k_env, env.num_envs)
        state = env._reset_jit(env._bank, keys)
        obs, depth = env._render_jit(env._bank, env._atlas, state)
        params = L.init_params(
            k_par, (env.obs_height, env.obs_width, 3), num_actions,
            continuous=continuous,
        )
        tstate = {"params": params, "opt": L.adam_init(params)}
        return tstate, state, obs, depth

    return init


def make_ppo_step(env, mesh, horizon: int = 16, lr: float = 3e-4,
                  gamma: float = 0.99, lam: float = 0.95,
                  clip_eps: float = 0.2, epochs: int = 2,
                  minibatches: int = 4, vf_coef: float = 0.5,
                  ent_coef: float = 0.01):
    """Build a sharded PPO train step (same calling shape as
    ``make_train_step``).

    Per call: one on-device rollout of ``horizon`` steps with the
    current policy, then ``epochs`` passes of ``minibatches`` clipped-
    surrogate updates over the T*B transition set, all inside ONE jitted
    shard_map program (rollout, GAE, and every minibatch update run on
    device; gradients pmean over the mesh per minibatch).

    Deviation from the textbook shuffle: minibatches are CONTIGUOUS
    slices of the time-major (T*B) transition set, with a random
    rotation (``jnp.roll``) per epoch. A true per-epoch permutation
    would row-gather the whole observation stack, which was slow on the
    chip this was written for (not yet measured on the GPU); the roll
    is two dynamic slices and still varies minibatch composition
    across epochs. Transitions within a slice come from many different
    envs (B-major inner order), so minibatches are already decorrelated
    across episodes.
    """
    n_dev = mesh.devices.size
    assert env.num_envs % n_dev == 0, (env.num_envs, n_dev)
    num_actions, continuous = _policy_spec(env)
    b_loc = env.num_envs // n_dev
    n_loc = horizon * b_loc
    assert n_loc % minibatches == 0, (n_loc, minibatches)
    mb = n_loc // minibatches

    def local_train(bank, atlas, tstate, state, obs, depth, key):
        k_roll, k_sgd = jax.random.split(key)
        # minibatch rotations are per shard
        k_sgd = jax.random.fold_in(k_sgd, jax.lax.axis_index(DATA_AXIS))
        params = tstate["params"]
        rollout = env.rollout_fn(
            horizon, policy=_policy_factory(params, continuous, env.num_envs),
            return_obs=True, return_actions=True)
        state, obs, depth, outs = rollout(
            bank, atlas, state, obs, depth, k_roll
        )

        rgb_t = jax.tree.leaves(outs["obs"])[0]  # (T, B, H, W, 3)
        T, B = rgb_t.shape[0], rgb_t.shape[1]
        dep_t = outs.get(
            "depth", jnp.zeros(rgb_t.shape[:4] + (1,), jnp.float32)
        )
        flat_rgb = rgb_t.reshape(T * B, *rgb_t.shape[2:])
        flat_dep = dep_t.reshape(T * B, *dep_t.shape[2:])
        actions = _flat_actions(outs["actions"], T * B, continuous)

        # Behavior-policy stats under the PRE-update params: log-prob of
        # the taken actions and V(obs_t) in one batched forward (the
        # rollout doesn't record them; recomputing costs one extra
        # forward and keeps the rollout output contract unchanged).
        old_out, values = L.forward(params, flat_rgb, flat_dep)
        if continuous:
            old_logp = L.gaussian_logp(params, old_out, actions)
        else:
            old_logp_all = jax.nn.log_softmax(old_out)
            old_logp = jnp.take_along_axis(
                old_logp_all, actions[:, None], axis=1
            )[:, 0]
        _, v_boot = L.forward(
            params, obs["obs"] if isinstance(obs, dict) else obs, depth
        )
        adv = gae(
            outs["rewards"], outs["done_mask"], values.reshape(T, B),
            v_boot, gamma, lam,
        )
        returns = adv + values.reshape(T, B)
        adv = adv.reshape(T * B)
        # advantage normalization with GLOBAL (cross-chip) moments so
        # every shard optimizes the same objective
        g_mean = jax.lax.pmean(adv.mean(), DATA_AXIS)
        g_sq = jax.lax.pmean(jnp.mean(adv * adv), DATA_AXIS)
        g_var = jnp.maximum(g_sq - g_mean * g_mean, 0.0)
        adv = (adv - g_mean) * jax.lax.rsqrt(g_var + 1e-8)

        data = jax.tree.map(
            jax.lax.stop_gradient,
            (flat_rgb, flat_dep, actions, old_logp, adv,
             returns.reshape(T * B)),
        )

        def epoch_body(carry, k_e):
            params, opt = carry
            off = jax.random.randint(k_e, (), 0, n_loc)
            rolled = jax.tree.map(
                lambda x: jnp.roll(x, off, axis=0), data
            )

            def mb_body(carry, i):
                params, opt = carry
                sl = jax.tree.map(
                    lambda x: jax.lax.dynamic_slice_in_dim(
                        x, i * mb, mb, axis=0
                    ),
                    rolled,
                )
                params, opt, loss, aux = L.ppo_grad_step(
                    params, opt, *sl, lr=lr, clip_eps=clip_eps,
                    vf_coef=vf_coef, ent_coef=ent_coef,
                    axis_name=DATA_AXIS,
                )
                return (params, opt), (loss, aux)

            (params, opt), out = jax.lax.scan(
                mb_body, (params, opt),
                jnp.arange(minibatches, dtype=jnp.int32),
            )
            return (params, opt), out

        (params, opt), (losses, auxs) = jax.lax.scan(
            epoch_body, (params, tstate["opt"]),
            jax.random.split(k_sgd, epochs),
        )
        metrics = {
            "loss": losses.mean(),
            "approx_kl": auxs["approx_kl"].mean(),
            "clip_frac": auxs["clip_frac"].mean(),
            "reward": jax.lax.psum(outs["reward"].sum(), DATA_AXIS),
            "dones": jax.lax.psum(outs["dones"].sum(), DATA_AXIS),
            "return_mean": jax.lax.pmean(returns.mean(), DATA_AXIS),
        }
        return {"params": params, "opt": opt}, state, obs, depth, metrics

    pspec_env = P(DATA_AXIS)
    pspec_rep = P()
    train = shard_map(
        local_train, mesh=mesh,
        in_specs=(pspec_rep, pspec_rep, pspec_rep, pspec_env, pspec_env,
                  pspec_env, pspec_rep),
        out_specs=(pspec_rep, pspec_env, pspec_env, pspec_env, pspec_rep),
        check_vma=False,
    )
    train_jit = jax.jit(train)
    tables = replicated_tables(env, mesh)

    def step(tstate, state, obs, depth, key):
        return train_jit(*tables(), tstate, state, obs, depth, key)

    # HLO-inspection hook (tests assert the gradient all-reduce exists)
    step.lower = lambda *a: train_jit.lower(*tables(), *a)
    return step, _make_init(env, num_actions, continuous)
