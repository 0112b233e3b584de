"""Trajectory parity against the ACTUAL reference implementation.

The reference engine (/root/reference/miniworld) runs in-process under
the fake-pyglet shim (tests/ref_shim) with rendering stubbed; its real
physics, np_random consumption, rewards and terminations are compared
step-by-step against the float64 host adapter (gym_env.py) — the
"bit-exact trajectories/rewards/terminations vs reference, fixed seed"
correctness target, verified against the reference itself rather
than our own transcription.

Golden fixtures recorded from the reference are also checked in
(tests/golden_ref/, regenerate with tests/make_ref_goldens.py) so the
parity contract survives environments without /root/reference.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ref_loader import load_reference  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_ref")

# (spec name, reference gym id, seed, max steps, domain_rand)
CASES = [
    ("Hallway", "MiniWorld-Hallway-v0", 123, 200, False),
    ("OneRoomS6Fast", "MiniWorld-OneRoomS6Fast-v0", 3, 120, False),
    ("FourRooms", "MiniWorld-FourRooms-v0", 8, 200, False),
    ("MazeS2", "MiniWorld-MazeS2-v0", 99, 200, False),
    ("MazeS3", "MiniWorld-MazeS3-v0", 31, 150, False),
    ("YMazeLeft", "MiniWorld-YMazeLeft-v0", 17, 150, False),
    ("TMazeRight", "MiniWorld-TMazeRight-v0", 11, 150, False),
    ("PutNext", "MiniWorld-PutNext-v0", 5, 150, False),
    ("PickupObjects", "MiniWorld-PickupObjects-v0", 21, 200, False),
    ("Sidewalk", "MiniWorld-Sidewalk-v0", 13, 120, False),
    ("WallGap", "MiniWorld-WallGap-v0", 29, 120, False),
    ("NavigateWallGap", "MiniWorld-NavigateWallGap-v0", 37, 150, False),
    ("RoomObjects", "MiniWorld-RoomObjects-v0", 97, 120, False),
    ("Maze", "MiniWorld-Maze-v0", 101, 150, False),
    # CollectHealth is excluded: the reference env cannot execute ANY
    # legal action (collecthealth.py:83 compares the Box(6) vector to
    # an enum scalar -> ValueError, and scalar actions are rejected by
    # miniworld.py:760-763 since it sets no discrete mapping).
    ("Sign", "MiniWorld-Sign-v0", 41, 120, False),
    ("ThreeRooms", "MiniWorld-ThreeRooms-v0", 43, 100, False),
    ("GreenKey", "MiniWorld-GreenKey-v0", 47, 120, False),
    ("CameraControl", "MiniWorld-CameraControl-v0", 53, 100, False),
    ("CameraControlClick", "MiniWorld-CameraControlClick-v0", 59, 100, False),
    # domain randomization ON: every np_random draw (reset param
    # sampling, texture variants, per-step forward/drift/turn samples)
    # must land in the reference's order for these to stay bit-exact
    ("Hallway", "MiniWorld-Hallway-v0", 61, 120, True),
    ("FourRooms", "MiniWorld-FourRooms-v0", 67, 120, True),
    ("MazeS2", "MiniWorld-MazeS2-v0", 71, 120, True),
    ("PickupObjects", "MiniWorld-PickupObjects-v0", 73, 120, True),
    ("Sidewalk", "MiniWorld-Sidewalk-v0", 79, 100, True),
    ("ThreeRooms", "MiniWorld-ThreeRooms-v0", 83, 100, True),
]

_IDS = [f"{c[0]}-s{c[2]}{'-dr' if c[4] else ''}" for c in CASES]


def scripted_actions(space, seed: int, steps: int) -> np.ndarray:
    """Deterministic action script shared by recorder and tests.

    Discrete spaces get index scripts; Box spaces (PutNext's raw 6-D
    actions, CameraControlClick's click coords) get uniform vectors
    within (clamped) bounds.
    """
    rng = np.random.default_rng(seed)
    if hasattr(space, "n"):
        return rng.integers(0, space.n, size=steps)
    lo = np.where(np.isfinite(space.low), space.low, -1.0)
    hi = np.where(np.isfinite(space.high), space.high, 1.0)
    return rng.uniform(lo, hi, size=(steps,) + space.shape).astype(np.float32)


def case_actions(name, space, seed: int, steps: int) -> np.ndarray:
    if name == "Sign":
        # avoid the end-episode action (index 3) so the script actually
        # walks the maze; episode end is covered by the final step
        return np.random.default_rng(seed).integers(0, 3, size=steps)
    return scripted_actions(space, seed, steps)


def _step_action(a):
    a = np.asarray(a)
    return int(a) if a.ndim == 0 else a


def _agent_pose(env):
    """(pos f64 (3,), dir, cam_pitch) from either implementation."""
    if hasattr(env, "agent"):  # reference
        return (np.asarray(env.agent.pos, np.float64), float(env.agent.dir),
                float(env.agent.cam_pitch))
    return (np.asarray(env.agent_pos, np.float64), float(env.agent_dir),
            float(env.cam_pitch))


def run_our_adapter(name, seed, steps, domain_rand, actions=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from miniworld_tpu.gym_env import MiniWorldGym

    env = MiniWorldGym(name, obs_width=24, obs_height=18,
                       domain_rand=domain_rand, skip_obs=True)
    env.reset(seed=seed)
    if actions is None:
        actions = case_actions(name, env.action_space, seed, steps)
    return _record(env, actions)


def run_reference(gym_id, seed, steps, domain_rand, actions=None, name=None):
    assert load_reference() is not None
    import gymnasium as gym

    try:
        env = gym.make(gym_id, domain_rand=domain_rand).unwrapped
    except TypeError:
        # Sign hardcodes domain_rand=False in its constructor
        # (reference sign.py:88)
        assert not domain_rand
        env = gym.make(gym_id).unwrapped
    env.reset(seed=seed)
    if actions is None:
        actions = case_actions(name, env.action_space, seed, steps)
    traj = _record(env, actions)
    env.close()
    return traj


def _record(env, actions):
    traj = {"pos": [], "dir": [], "pitch": [], "reward": [], "term": [],
            "trunc": []}
    pos, d, _ = _agent_pose(env)
    traj["spawn_pos"], traj["spawn_dir"] = pos, d
    for a in actions:
        _, rew, term, trunc, _ = env.step(_step_action(a))
        pos, d, pitch = _agent_pose(env)
        traj["pos"].append(pos)
        traj["dir"].append(d)
        traj["pitch"].append(pitch)
        traj["reward"].append(float(rew))
        traj["term"].append(bool(term))
        traj["trunc"].append(bool(trunc))
        if term or trunc:
            break
    return {k: np.asarray(v) for k, v in traj.items()}


def assert_traj_equal(ref, ours, context=""):
    np.testing.assert_array_equal(ref["spawn_pos"], ours["spawn_pos"],
                                  err_msg=f"{context} spawn_pos")
    assert ref["spawn_dir"] == ours["spawn_dir"], context
    assert ref["pos"].shape == ours["pos"].shape, (
        f"{context}: episode lengths differ "
        f"({ref['pos'].shape[0]} vs {ours['pos'].shape[0]})"
    )
    for key in ("pos", "dir", "pitch", "reward", "term", "trunc"):
        np.testing.assert_array_equal(ref[key], ours[key],
                                      err_msg=f"{context} {key}")


@pytest.mark.parametrize("name,gym_id,seed,steps,dr", CASES, ids=_IDS)
def test_adapter_matches_reference_live(name, gym_id, seed, steps, dr):
    """Bit-exact trajectory vs the reference, executed live."""
    if load_reference() is None:
        pytest.skip("/root/reference not available")
    ref = run_reference(gym_id, seed, steps, dr, name=name)
    ours = run_our_adapter(name, seed, steps, dr)
    assert_traj_equal(ref, ours, context=f"{name} seed={seed}")


@pytest.mark.parametrize("name,gym_id,seed,steps,dr", CASES, ids=_IDS)
def test_adapter_matches_reference_fixture(name, gym_id, seed, steps, dr):
    """Bit-exact trajectory vs the recorded reference fixture."""
    tag = f"{name}_s{seed}{'_dr' if dr else ''}"
    path = os.path.join(GOLDEN_DIR, f"{tag}.npz")
    if not os.path.exists(path):
        pytest.skip(f"fixture {tag}.npz not recorded")
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    ours = run_our_adapter(name, seed, steps, dr, actions=ref["actions"])
    assert_traj_equal(ref, ours, context=f"{name} seed={seed} (fixture)")
