"""A compact actor-critic learner for sharded RGB-D observations.

The reference ships no learner (its experiments/ are stale torch demos,
SURVEY.md §2.11); this module exists to exercise the framework's
stated deployment shape — sharded env batches feeding a data-parallel
learner — and to serve as the multi-device dry-run model.

Pure-JAX (no flax): params are a dict pytree, the network is a small
bf16 CNN torso + policy/value heads, and the update is advantage
actor-critic over on-device rollouts. Under ``shard_map`` the gradient
is ``pmean``-averaged over the ``data`` mesh axis — the only cross-device
communication in the system (env stepping itself is embarrassingly
parallel over the batch).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from miniworld_tpu.parallel.mesh import DATA_AXIS


def init_params(key: jax.Array, obs_shape, num_actions: int,
                channels=(16, 32, 32), hidden: int = 256,
                continuous: bool = False) -> dict:
    """He-init CNN torso (stride-2 convs) + policy/value heads.

    ``continuous=True`` makes the pi head emit ``num_actions`` Gaussian
    MEANS and adds a state-independent ``log_std`` vector — the policy
    for raw Box action spaces (the reference's default 6-D continuous
    convention, miniworld.py:616-652); out-of-range samples are clipped
    by the env's own clip_action like any other caller's."""
    h, w, c = obs_shape
    params = {}
    ks = jax.random.split(key, len(channels) + 3)
    in_c = c + 1  # RGB + depth
    for i, out_c in enumerate(channels):
        fan_in = 3 * 3 * in_c
        params[f"conv{i}"] = {
            "w": jax.random.normal(ks[i], (3, 3, in_c, out_c), jnp.float32)
            * math.sqrt(2.0 / fan_in),
            "b": jnp.zeros((out_c,), jnp.float32),
        }
        in_c = out_c
        h, w = -(-h // 2), -(-w // 2)
    flat = h * w * in_c
    params["fc"] = {
        "w": jax.random.normal(ks[-3], (flat, hidden), jnp.float32)
        * math.sqrt(2.0 / flat),
        "b": jnp.zeros((hidden,), jnp.float32),
    }
    params["pi"] = {
        "w": jax.random.normal(ks[-2], (hidden, num_actions), jnp.float32) * 0.01,
        "b": jnp.zeros((num_actions,), jnp.float32),
    }
    params["v"] = {
        "w": jax.random.normal(ks[-1], (hidden, 1), jnp.float32) * 0.01,
        "b": jnp.zeros((1,), jnp.float32),
    }
    if continuous:
        params["log_std"] = jnp.full((num_actions,), -0.5, jnp.float32)
    return params


_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_sample(params, mean, eps):
    """Sample the diagonal-Gaussian policy from standard-normal noise
    ``eps``: mean + exp(log_std) * eps."""
    return mean + jnp.exp(params["log_std"]) * eps


def gaussian_logp(params, mean, actions):
    """(B, A) mean + actions -> (B,) joint log-density."""
    log_std = params["log_std"]
    z = (actions - mean) * jnp.exp(-log_std)
    return -0.5 * jnp.sum(z * z + 2.0 * log_std + _LOG_2PI, axis=-1)


def gaussian_entropy(params):
    """() closed-form entropy of the diagonal Gaussian head."""
    return 0.5 * jnp.sum(2.0 * params["log_std"] + _LOG_2PI + 1.0)


def forward(params: dict, rgb: jax.Array, depth: jax.Array):
    """(B,H,W,3) u8 + (B,H,W,1) f32 -> (logits (B,A), value (B,))."""
    x = jnp.concatenate(
        [rgb.astype(jnp.bfloat16) / 255.0, (depth / 100.0).astype(jnp.bfloat16)],
        axis=-1,
    )
    n_convs = sum(1 for k in params if k.startswith("conv"))
    for i in range(n_convs):
        p = params[f"conv{i}"]
        x = jax.lax.conv_general_dilated(
            x, p["w"].astype(jnp.bfloat16),
            window_strides=(2, 2), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.bfloat16,
        ) + p["b"].astype(jnp.bfloat16)
        x = jax.nn.relu(x)
    x = x.reshape(x.shape[0], -1)
    x = jax.nn.relu(
        jnp.dot(x, params["fc"]["w"].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
        + params["fc"]["b"]
    )
    logits = jnp.dot(x.astype(jnp.bfloat16), params["pi"]["w"].astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32) + params["pi"]["b"]
    value = (jnp.dot(x.astype(jnp.bfloat16), params["v"]["w"].astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32) + params["v"]["b"])[:, 0]
    return logits, value


def a2c_loss(params, rgb, depth, actions, returns):
    """Advantage actor-critic loss for one batch of transitions.

    Branches statically on the head type: categorical (int actions)
    without a ``log_std`` param, diagonal Gaussian (float action
    vectors) with one."""
    out, value = forward(params, rgb, depth)
    if "log_std" in params:
        act_logp = gaussian_logp(params, out, actions)
        ent = gaussian_entropy(params)
    else:
        logp = jax.nn.log_softmax(out)
        act_logp = jnp.take_along_axis(logp, actions[:, None], axis=1)[:, 0]
        ent = -jnp.mean(jnp.sum(jnp.exp(logp) * logp, axis=1))
    adv = returns - jax.lax.stop_gradient(value)
    pg = -jnp.mean(act_logp * adv)
    vf = 0.5 * jnp.mean((returns - value) ** 2)
    return pg + vf - 0.01 * ent


def sgd_update(params, grads, lr: float = 3e-4):
    return jax.tree.map(lambda p, g: p - lr * g, params, grads)


def adam_init(params) -> dict:
    return {
        "m": jax.tree.map(jnp.zeros_like, params),
        "v": jax.tree.map(jnp.zeros_like, params),
        "t": jnp.zeros((), jnp.int32),
    }


def adam_update(params, grads, opt, *, lr: float = 3e-4, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    t = opt["t"] + 1
    m = jax.tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g, opt["m"], grads)
    v = jax.tree.map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, opt["v"], grads)
    scale = lr * jnp.sqrt(1 - b2 ** t.astype(jnp.float32)) / (
        1 - b1 ** t.astype(jnp.float32)
    )
    params = jax.tree.map(
        lambda p, m_, v_: p - scale * m_ / (jnp.sqrt(v_) + eps), params, m, v
    )
    return params, {"m": m, "v": v, "t": t}


def grad_step(params, opt, rgb, depth, actions, returns, *, lr: float = 3e-4,
              axis_name: str | None = DATA_AXIS):
    """One A2C Adam step on a batch of (obs, action, return) transitions;
    grads psum-averaged over the mesh axis when ``axis_name`` is set
    (i.e. inside shard_map/pmap)."""
    loss, grads = jax.value_and_grad(a2c_loss)(params, rgb, depth, actions, returns)
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        loss = jax.lax.pmean(loss, axis_name)
    params, opt = adam_update(params, grads, opt, lr=lr)
    return params, opt, loss


def ppo_loss(params, rgb, depth, actions, old_logp, adv, returns, *,
             clip_eps: float = 0.2, vf_coef: float = 0.5,
             ent_coef: float = 0.01):
    """Clipped-surrogate PPO loss (Schulman et al. 2017) on one
    minibatch of transitions.

    ``old_logp`` is the behavior policy's log-prob of ``actions`` and
    ``adv`` the (normalized) GAE advantage — both stop-gradiented by
    the caller. Returns (loss, aux) with ``approx_kl`` (the simple
    E[old_logp - logp] estimator) and ``clip_frac`` diagnostics.
    """
    out, value = forward(params, rgb, depth)
    if "log_std" in params:
        logp = gaussian_logp(params, out, actions)
        ent = gaussian_entropy(params)
    else:
        logp_all = jax.nn.log_softmax(out)
        logp = jnp.take_along_axis(logp_all, actions[:, None], axis=1)[:, 0]
        ent = -jnp.mean(jnp.sum(jnp.exp(logp_all) * logp_all, axis=1))
    ratio = jnp.exp(logp - old_logp)
    clipped = jnp.clip(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    pg = -jnp.mean(jnp.minimum(ratio * adv, clipped * adv))
    vf = 0.5 * jnp.mean((returns - value) ** 2)
    aux = {
        "approx_kl": jnp.mean(old_logp - logp),
        "clip_frac": jnp.mean((jnp.abs(ratio - 1.0) > clip_eps).astype(
            jnp.float32)),
    }
    return pg + vf_coef * vf - ent_coef * ent, aux


def ppo_grad_step(params, opt, rgb, depth, actions, old_logp, adv, returns,
                  *, lr: float = 3e-4, clip_eps: float = 0.2,
                  vf_coef: float = 0.5, ent_coef: float = 0.01,
                  axis_name: str | None = DATA_AXIS):
    """One PPO Adam step on a minibatch; grads/diagnostics
    pmean-reduced over the mesh axis when set."""
    (loss, aux), grads = jax.value_and_grad(ppo_loss, has_aux=True)(
        params, rgb, depth, actions, old_logp, adv, returns,
        clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef,
    )
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        loss = jax.lax.pmean(loss, axis_name)
        aux = jax.lax.pmean(aux, axis_name)
    params, opt = adam_update(params, grads, opt, lr=lr)
    return params, opt, loss, aux
