"""Vectorized env engine tests: shapes, determinism, invariants,
auto-reset, fused rollout. Mirrors the reference test strategy
(tests/test_miniworld.py:19-128) on the vectorized execution path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from miniworld_tpu import MiniWorldVec

W, H, B = 32, 24, 4


@pytest.fixture(scope="module")
def hallway():
    return MiniWorldVec("MiniWorld-Hallway-v0", num_envs=B, obs_width=W,
                        obs_height=H)


def test_reset_step_shapes(hallway):
    env = hallway
    state, (obs, depth) = env.reset(jax.random.key(0))
    assert obs.shape == (B, H, W, 3) and obs.dtype == jnp.uint8
    assert depth.shape == (B, H, W, 1) and depth.dtype == jnp.float32
    acts = env.sample_actions(jax.random.key(1))
    state, (obs, depth), r, d, info = env.step(state, acts)
    assert obs.shape == (B, H, W, 3)
    assert r.shape == (B,) and d.shape == (B,)
    assert info["agent_pos"].shape == (B, 3)
    # observations are non-degenerate (something rendered)
    assert 10 < float(obs.astype(jnp.float32).mean()) < 245


def test_determinism(hallway):
    env = hallway
    s1, (o1, _) = env.reset(jax.random.key(7))
    s2, (o2, _) = env.reset(jax.random.key(7))
    assert np.array_equal(np.asarray(o1), np.asarray(o2))
    acts = env.sample_actions(jax.random.key(3))
    s1b, (o1b, _), r1, d1, _ = env.step(s1, acts)
    s2b, (o2b, _), r2, d2, _ = env.step(s2, acts)
    assert np.array_equal(np.asarray(o1b), np.asarray(o2b))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))


def test_never_escape_room(hallway):
    """Collision invariant from tests/test_miniworld.py:89-104: pushing
    forward forever never exits the floorplan."""
    env = hallway
    state, _ = env.reset(jax.random.key(1))
    fwd = jnp.full((B,), 2, dtype=jnp.int32)  # discrete action: forward
    for _ in range(40):
        state, obs, r, d, info = env.step(state, fwd)
    pos = np.asarray(state.pos)
    # Hallway extents (hallway.py:55-60): x in [-1, 11], z in [-2, 2]
    r_a = 0.4 - 1e-5
    assert np.all(pos[:, 0] >= -1 + r_a) and np.all(pos[:, 0] <= 11 - r_a)
    assert np.all(pos[:, 2] >= -2 + r_a) and np.all(pos[:, 2] <= 2 - r_a)


def test_auto_reset():
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0", num_envs=8,
                       obs_width=W, obs_height=H)
    state, _ = env.reset(jax.random.key(0))
    saw_done = False
    acts_key = jax.random.key(1)
    for i in range(60):
        acts_key, k = jax.random.split(acts_key)
        acts = env.sample_actions(k)
        state, obs, r, d, info = env.step(state, acts)
        if bool(jnp.any(d)):
            saw_done = True
            # auto-reset: step_count of done envs back to 0
            assert int(state.step_count[np.argmax(np.asarray(d))]) == 0
            break
    assert saw_done, "OneRoomS6Fast (50-step cap) must finish within 60 steps"


def test_rollout_fused(hallway):
    env = hallway
    state, obs = env.reset(jax.random.key(0))
    state, obs, outs = env.rollout(state, obs, jax.random.key(1), 5)
    assert outs["reward"].shape == (5,)
    assert outs["dones"].shape == (5,)
    assert int(outs["obs_sum"][0]) > 0


def test_reward_range_and_termination():
    """Termination pays the sparse reward shape (miniworld.py:1095-1100)."""
    env = MiniWorldVec("MiniWorld-OneRoomS6Fast-v0", num_envs=16,
                       obs_width=W, obs_height=H)
    state, _ = env.reset(jax.random.key(0))
    key = jax.random.key(1)
    rewards = []
    for _ in range(55):
        key, k = jax.random.split(key)
        state, obs, r, d, info = env.step(state, env.sample_actions(k))
        got = np.asarray(r)[np.asarray(d) & (np.asarray(r) > 0)]
        rewards.extend(got.tolist())
    for rv in rewards:
        assert 0.0 < rv <= 1.0


def test_domain_rand_changes_obs():
    env = MiniWorldVec("MiniWorld-Hallway-v0", num_envs=2, obs_width=W,
                       obs_height=H, domain_rand=True)
    s1, (o1, _) = env.reset(jax.random.key(0))
    s2, (o2, _) = env.reset(jax.random.key(99))
    # sky/light randomization must change pixels between seeds
    assert not np.array_equal(np.asarray(o1), np.asarray(o2))
    # params sampled within ranges
    fov = np.asarray(s1.cam_fov_y)
    assert np.all(fov >= 55.0) and np.all(fov <= 65.0)


def test_pickup_scores_and_removes():
    """Face an object point-blank and press pickup: +1 reward, entity
    removed (pickupobjects.py:94-101)."""
    env = MiniWorldVec("MiniWorld-PickupObjects-v0", num_envs=1,
                       obs_width=W, obs_height=H)
    state, _ = env.reset(jax.random.key(5))
    e0 = np.asarray(state.ent_pos[0, 0])
    agent_p = e0 + np.array([-1.0, 0.0, 0.0])
    state = state.replace(
        pos=jnp.asarray([agent_p], jnp.float32),
        dir=jnp.asarray([0.0], jnp.float32),
    )
    state2, obs, r, d, info = env.step(state, jnp.asarray([4], jnp.int32))
    assert float(r[0]) == 1.0
    assert not bool(d[0])
    assert not bool(state2.ent_alive[0, 0])


def test_dict_obs_fused_rollout():
    """Dict-obs envs (Sign) through the fused rollout: the obs-checksum
    and any learner-side image pick must use the IMAGE leaf, not
    tree.leaves()[0] (dict key order puts the scalar 'goal' first —
    this crashed the first-ever Sign bench, round 5)."""
    import numpy as np

    env = MiniWorldVec("MiniWorld-Sign-v0", num_envs=2, obs_width=32,
                       obs_height=24)
    state, obs = env.reset(jax.random.key(0))
    state, obs, outs = env.rollout(state, obs, jax.random.key(1), 2)
    o, d = obs
    assert set(o.keys()) == {"obs", "goal"}
    assert o["obs"].shape == (2, 24, 32, 3)
    s = np.asarray(outs["obs_sum"])
    assert s.shape == (2,) and (s > 0).all()
