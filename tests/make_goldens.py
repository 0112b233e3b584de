#!/usr/bin/env python3
"""Regenerate golden trajectory fixtures (tests/golden/*.npz).

Each fixture records the float64 host adapter's exact behavior — agent
poses, rewards, terminations — for a fixed seed and scripted actions.
The host adapter transcribes the reference's op order (gym_env.py), so
these goldens pin reference-equivalent physics against refactors; the
device path is checked against them with f32 tolerance.

Run from the repo root after INTENTIONAL physics changes only:
    python tests/make_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")  # never claim an accelerator

import numpy as np

from miniworld_tpu.gym_env import MiniWorldGym

CASES = [
    ("Hallway", 123, 40),
    ("FourRooms", 7, 40),
    ("MazeS2", 99, 40),
    ("PutNext", 5, 30),
    ("Sidewalk", 11, 30),
]


def main():
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    os.makedirs(out_dir, exist_ok=True)
    for name, seed, steps in CASES:
        env = MiniWorldGym(name, obs_width=24, obs_height=18)
        obs, info = env.reset(seed=seed)
        rng = np.random.default_rng(seed)
        if hasattr(env.action_space, "n"):
            actions = rng.integers(0, env.action_space.n, size=steps)
        else:
            actions = rng.uniform(-1, 1, size=(steps, 6)).astype(np.float32)
            actions[:, 4:] = np.abs(actions[:, 4:])
        poses, dirs, rewards, terms = [], [], [], []
        spawn = env.agent_pos.copy()
        for a in actions:
            obs, r, term, trunc, info = env.step(
                int(a) if np.ndim(a) == 0 else a
            )
            poses.append(env.agent_pos.copy())
            dirs.append(env.agent_dir)
            rewards.append(r)
            terms.append(term)
            if term or trunc:
                break
        np.savez(
            os.path.join(out_dir, f"{name}_s{seed}.npz"),
            actions=actions[: len(poses)],
            spawn=spawn,
            spawn_dir=env.world.agent_slot.dir,
            poses=np.asarray(poses),
            dirs=np.asarray(dirs),
            rewards=np.asarray(rewards),
            terms=np.asarray(terms),
        )
        print(f"{name} seed={seed}: {len(poses)} steps recorded")


if __name__ == "__main__":
    main()
