#!/usr/bin/env python3
"""Benchmark harness (reference: scripts/benchmark.py:10-48, extended).

Two modes:
  * ``--mode single``: reference-parity measurement — env load time,
    mean reset time, per-frame render time, FPS of the single gym env.
  * ``--mode vector`` (default): fused rollout env-steps/s at a given
    batch size, RGB-D observations.

Both run on JAX's default backend (set ``JAX_PLATFORMS=cpu`` to force
the CPU).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


import argparse
import json
import time


def bench_single(args):
    t0 = time.perf_counter()
    from miniworld_tpu.gym_env import MiniWorldGym

    env = MiniWorldGym(
        args.env_name.replace("MiniWorld-", "").replace("-v0", ""),
        obs_width=args.obs_width, obs_height=args.obs_height,
    )
    env.reset(seed=0)
    load_time = time.perf_counter() - t0
    print(f"load time: {load_time * 1000:.0f} ms")

    t0 = time.perf_counter()
    for i in range(args.num_resets):
        env.reset(seed=i)
    reset_time = (time.perf_counter() - t0) / args.num_resets
    print(f"reset time: {reset_time * 1000:.1f} ms")

    t0 = time.perf_counter()
    for _ in range(args.num_frames):
        env.step(env.action_space.sample())
    frame_time = (time.perf_counter() - t0) / args.num_frames
    print(f"frame time: {frame_time * 1000:.1f} ms")
    print(f"frame rate: {1 / frame_time:.0f} FPS")


def bench_vector(args):
    import jax

    from miniworld_tpu import MiniWorldVec
    from miniworld_tpu.utils import compile_cache

    compile_cache.enable()
    print(f"device: {jax.devices()[0].platform} "
          f"({jax.devices()[0].device_kind})")
    env = MiniWorldVec(args.env_name, num_envs=args.num_envs,
                       obs_width=args.obs_width, obs_height=args.obs_height,
                       domain_rand=args.domain_rand,
                       procgen=getattr(args, "procgen", False))
    state, obs = env.reset(jax.random.key(0))
    t0 = time.perf_counter()
    state, obs, outs = env.rollout(state, obs, jax.random.key(1), args.horizon)
    jax.block_until_ready(outs)
    print(f"compile+first rollout: {time.perf_counter() - t0:.1f} s")

    best = 0.0
    for trial in range(args.trials):
        t0 = time.perf_counter()
        state, obs, outs = env.rollout(
            state, obs, jax.random.key(2 + trial), args.horizon
        )
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        sps = args.horizon * args.num_envs / dt
        best = max(best, sps)
        print(f"trial {trial}: {sps:,.0f} env-steps/s "
              f"({dt / args.horizon * 1e3:.2f} ms/step)")
    print(json.dumps({
        "env": args.env_name, "num_envs": args.num_envs,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "obs": f"{args.obs_width}x{args.obs_height} RGB-D",
        "env_steps_per_s": round(best),
    }))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("env_name", nargs="?", default="MiniWorld-Maze-v0")
    p.add_argument("--mode", choices=["single", "vector"], default="vector")
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--num-resets", type=int, default=10)
    p.add_argument("--num-frames", type=int, default=100)
    p.add_argument("--obs-width", type=int, default=80)
    p.add_argument("--obs-height", type=int, default=60)
    p.add_argument("--domain-rand", action="store_true")
    p.add_argument("--procgen", action="store_true",
                   help="maze-grid envs: device-side per-reset "
                        "generation instead of a layout bank")
    args = p.parse_args()
    if args.mode == "single":
        bench_single(args)
    else:
        bench_vector(args)


if __name__ == "__main__":
    main()
