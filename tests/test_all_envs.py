"""Whole-suite smoke: every registered env id builds, resets, steps.

Vectorized-path analog of tests/test_miniworld.py:107-128 (test_all_envs runs
15 resets x 20 random steps on every id; here budgets are tighter since
XLA compiles per env class)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from miniworld_tpu import ENV_IDS, MiniWorldVec
from miniworld_tpu.envs import make_spec

W, H = 24, 18


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_vector_env_smoke(env_id):
    spec = make_spec(env_id)
    n_layouts_cap = 4 if spec.num_layouts > 4 else spec.num_layouts
    if spec.num_layouts > 4:
        spec.num_layouts = n_layouts_cap  # cap bank size for test speed
    env = MiniWorldVec(spec, num_envs=2, obs_width=W, obs_height=H)
    state, obs = env.reset(jax.random.key(0))
    key = jax.random.key(1)
    for i in range(3):
        key, k = jax.random.split(key)
        acts = env.sample_actions(k)
        state, obs, r, d, info = env.step(state, acts)
    img = obs[0]["obs"] if isinstance(obs[0], dict) else obs[0]
    assert img.shape == (2, H, W, 3)
    assert np.isfinite(np.asarray(r)).all()
    # agent stays inside the floorplan extents (+ margin for open envs)
    ext = env._bank_np.extents
    if ext.ndim == 2:
        ext = ext[0]
    pos = np.asarray(state.pos)
    assert np.all(pos[:, 0] >= ext[0] - 1) and np.all(pos[:, 0] <= ext[1] + 1)


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_gym_adapter_smoke(env_id):
    from miniworld_tpu.gym_env import MiniWorldGym

    env = MiniWorldGym(env_id.replace("MiniWorld-", "").replace("-v0", ""),
                       obs_width=W, obs_height=H)
    obs, info = env.reset(seed=3)
    img = obs["obs"] if isinstance(obs, dict) else obs
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert "agent" in info
    for _ in range(3):
        a = env.action_space.sample()
        obs, r, term, trunc, info = env.step(a)
        if term or trunc:
            obs, info = env.reset()
    # spawn not intersecting (test_miniworld.py:120-127 analog); the
    # CameraControl family mounts the "agent" flush to a wall by design
    obs, info = env.reset(seed=11)
    if not env.spec_def.override_physics:
        hit = env.intersect(None, env.agent_pos, env.agent_radius - 1e-5)
        assert hit is None or hit is False
