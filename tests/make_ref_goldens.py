#!/usr/bin/env python3
"""Record golden trajectories from the ACTUAL reference engine.

Runs /root/reference/miniworld under the fake-pyglet shim and saves
per-case trajectories (poses, rewards, terminations, the action script)
to tests/golden_ref/*.npz. These fixtures pin reference behavior for
environments where /root/reference is unavailable; regenerate only if
the parity CASES list changes.

    python tests/make_ref_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")  # never claim an accelerator

import numpy as np

from test_ref_parity import CASES, GOLDEN_DIR, case_actions, run_reference
from ref_loader import load_reference


def main():
    assert load_reference() is not None, "/root/reference required to record"
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    import gymnasium as gym

    for name, gym_id, seed, steps, dr in CASES:
        space = gym.make(gym_id).unwrapped.action_space
        actions = case_actions(name, space, seed, steps)
        traj = run_reference(gym_id, seed, steps, dr, actions=actions)
        traj["actions"] = actions[: traj["pos"].shape[0]]
        tag = f"{name}_s{seed}{'_dr' if dr else ''}"
        np.savez(os.path.join(GOLDEN_DIR, f"{tag}.npz"), **traj)
        print(f"{tag}: {traj['pos'].shape[0]} steps, "
              f"return {traj['reward'].sum():.4f}")


if __name__ == "__main__":
    main()
