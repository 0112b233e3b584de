#!/usr/bin/env python3
"""Single-env head-to-head: the ACTUAL
reference running under tests/ref_shim vs the gym adapter, identical
protocol (Hallway, single env, 80x60, random discrete policy, 1k
steps, CPU; reference benchmark recipe scripts/benchmark.py:10-48).

The shim stubs rendering (no GL on this machine), so the reference
number includes a FREE renderer; the apples-to-apples comparison is
the adapter's skip_obs=True mode (physics + task logic only).

    python scripts/ref_headtohead.py ref|ours|noobs

Measured on a CPU-only development machine:
    ref   (physics only, render stubbed):  load 226 ms, reset 3.1 ms,  2,285 FPS
    noobs (ours, physics only):            load  58 ms, reset 1.1 ms, 12,942 FPS
    ours  (ours, REAL 80x60 rendering):    load 8.6 s,  reset 54 ms,      91 FPS
"""

import sys, time
import os
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np

def bench_reference():
    from ref_loader import load_reference
    mini = load_reference()
    assert mini is not None
    import gymnasium as gym
    t0 = time.perf_counter()
    env = gym.make("MiniWorld-Hallway-v0", obs_width=80, obs_height=60)
    env.reset(seed=0)
    load_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(50):
        env.reset(seed=i)
    reset_t = (time.perf_counter() - t0) / 50
    rng = np.random.default_rng(0)
    env.reset(seed=0)
    t0 = time.perf_counter()
    n = 0
    for _ in range(1000):
        a = int(rng.integers(env.action_space.n))
        obs, r, term, trunc, info = env.step(a)
        n += 1
        if term or trunc:
            env.reset()
    dt = time.perf_counter() - t0
    env.close()
    return load_t, reset_t, n / dt

def bench_ours():
    import jax
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    from miniworld_tpu.gym_env import MiniWorldGym
    env = MiniWorldGym("Hallway", obs_width=80, obs_height=60)
    env.reset(seed=0)
    load_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(50):
        env.reset(seed=i)
    reset_t = (time.perf_counter() - t0) / 50
    rng = np.random.default_rng(0)
    env.reset(seed=0)
    t0 = time.perf_counter()
    n = 0
    for _ in range(1000):
        a = int(rng.integers(env.action_space.n))
        obs, r, term, trunc, info = env.step(a)
        n += 1
        if term or trunc:
            env.reset()
    dt = time.perf_counter() - t0
    return load_t, reset_t, n / dt

def bench_ours_noobs():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from miniworld_tpu.gym_env import MiniWorldGym
    t0 = time.perf_counter()
    env = MiniWorldGym("Hallway", obs_width=80, obs_height=60, skip_obs=True)
    env.reset(seed=0)
    load_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(50):
        env.reset(seed=i)
    reset_t = (time.perf_counter() - t0) / 50
    rng = np.random.default_rng(0)
    env.reset(seed=0)
    t0 = time.perf_counter()
    n = 0
    for _ in range(1000):
        a = int(rng.integers(env.action_space.n))
        obs, r, term, trunc, info = env.step(a)
        n += 1
        if term or trunc:
            env.reset()
    dt = time.perf_counter() - t0
    return load_t, reset_t, n / dt

which = sys.argv[1]
lt, rt, fps = bench_reference() if which == "ref" else (bench_ours_noobs() if which == "noobs" else bench_ours())
print(f"{which}: load {lt*1000:.0f} ms, reset {rt*1000:.1f} ms, {fps:.1f} FPS")
