"""Observation/action wrappers (reference: miniworld/wrappers.py:7-69).

Two families:
  * gymnasium wrappers for the single-env adapter — drop-in parity with
    the reference classes (same names, same math);
  * pure functions for the vectorized path (apply under jit to the
    batched obs), since gymnasium wrappers can't wrap a jitted batch.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces

# luma weights (wrappers.py:37-41)
_LUMA = (0.30, 0.59, 0.11)


class PyTorchObsWrapper(gym.ObservationWrapper):
    """HWC uint8 -> CWH transpose (wrappers.py:7-24)."""

    def __init__(self, env):
        super().__init__(env)
        obs_shape = self.observation_space.shape
        self.observation_space = spaces.Box(
            self.observation_space.low.flatten()[0],
            self.observation_space.high.flatten()[0],
            [obs_shape[2], obs_shape[1], obs_shape[0]],
            dtype=self.observation_space.dtype,
        )

    def observation(self, observation):
        return observation.transpose(2, 1, 0)


class GreyscaleWrapper(gym.ObservationWrapper):
    """RGB -> single-channel greyscale (wrappers.py:27-46)."""

    def __init__(self, env):
        super().__init__(env)
        obs_shape = self.observation_space.shape
        self.observation_space = spaces.Box(
            self.observation_space.low.flatten()[0],
            self.observation_space.high.flatten()[0],
            [obs_shape[0], obs_shape[1], 1],
            dtype=self.observation_space.dtype,
        )

    def observation(self, obs):
        obs = (
            _LUMA[0] * obs[:, :, 0]
            + _LUMA[1] * obs[:, :, 1]
            + _LUMA[2] * obs[:, :, 2]
        )
        return np.expand_dims(obs, axis=2).astype(self.observation_space.dtype)


class StochasticActionWrapper(gym.ActionWrapper):
    """epsilon-random action substitution (wrappers.py:48-69).

    With probability ``prob`` the agent's action passes through;
    otherwise ``random_action`` is executed when given, else a sample
    from the action space. Draws come from the env's seeded
    ``np_random`` so trajectories reproduce under a fixed seed.
    """

    def __init__(self, env, prob: float = 0.9, random_action=None):
        super().__init__(env)
        self.prob = prob
        self.random_action = random_action

    def action(self, action):
        if self.np_random.uniform() < self.prob:
            return action
        if self.random_action is None:
            return self.action_space.sample()
        return self.random_action


# -- vectorized (device-side) counterparts -------------------------------


def pytorch_obs(obs):
    """(B,H,W,C) -> (B,C,W,H); same transpose as PyTorchObsWrapper."""
    return obs.transpose(0, 3, 2, 1)


def greyscale_obs(obs):
    """(B,H,W,3) u8 -> (B,H,W,1) u8 with the reference luma weights."""
    import jax.numpy as jnp

    f = obs.astype(jnp.float32)
    g = _LUMA[0] * f[..., 0] + _LUMA[1] * f[..., 1] + _LUMA[2] * f[..., 2]
    return g[..., None].astype(obs.dtype)


def stochastic_actions(key, actions, sample_fn, prob: float = 0.9):
    """With prob keep ``actions``, else substitute random ones."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(key)
    keep = jax.random.uniform(k1, (actions.shape[0],)) < prob
    rand = sample_fn(k2)
    bshape = (actions.shape[0],) + (1,) * (actions.ndim - 1)
    return jnp.where(keep.reshape(bshape), actions, rand)
