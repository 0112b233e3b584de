#!/usr/bin/env python3
"""Multi-device scaling benchmark of the sharded train step.

Measures env-steps/s of the sharded train step (rollout + A2C learner,
gradients pmean'd over the data axis) at 1..N devices and reports
scaling efficiency. On a single-chip machine, run with a virtual device
mesh to validate the sharding (the collectives run on the CPU backend):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_bench.py --envs-per-device 8 --obs 32x24

On a multi-GPU host it measures scaling over the cards' NVLink.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


import argparse
import json
import time

import jax


def measure(n_devices: int, envs_per_device: int, obs_w: int, obs_h: int,
            horizon: int, env_id: str) -> float:
    from miniworld_tpu import MiniWorldVec
    from miniworld_tpu.parallel import make_mesh, make_train_step, shard_env_batch

    mesh = make_mesh(n_devices)
    env = MiniWorldVec(env_id, num_envs=envs_per_device * n_devices,
                       obs_width=obs_w, obs_height=obs_h)
    step, init = make_train_step(env, mesh, horizon=horizon)
    tstate, state, obs, depth = init(jax.random.key(0))
    state = shard_env_batch(mesh, state)
    obs = shard_env_batch(mesh, obs)
    depth = shard_env_batch(mesh, depth)

    tstate, state, obs, depth, m = step(tstate, state, obs, depth,
                                        jax.random.key(1))
    float(jax.device_get(m["loss"]))  # fence
    t0 = time.perf_counter()
    trials = 3
    for i in range(trials):
        tstate, state, obs, depth, m = step(tstate, state, obs, depth,
                                            jax.random.key(2 + i))
    float(jax.device_get(m["loss"]))  # fence
    dt = time.perf_counter() - t0
    return trials * horizon * env.num_envs / dt


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="MiniWorld-FourRooms-v0")
    p.add_argument("--envs-per-device", type=int, default=64)
    p.add_argument("--obs", default="80x60")
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--metrics", default=None,
                   help="write the scaling result as one JSON line")
    args = p.parse_args()
    obs_w, obs_h = map(int, args.obs.split("x"))

    n_max = len(jax.devices())
    results = {}
    for n in [1, n_max] if n_max > 1 else [1]:
        sps = measure(n, args.envs_per_device, obs_w, obs_h, args.horizon,
                      args.env)
        results[n] = sps
        print(f"{n} device(s): {sps:,.0f} env-steps/s")
    row = {
        "devices": n_max,
        "env_steps_per_s": round(results[n_max]),
        "env_steps_per_s_per_device": round(results[n_max] / n_max),
        "scaling_efficiency": (
            round(results[n_max] / (results[1] * n_max), 3) if n_max > 1 else 1.0
        ),
        "env": args.env,
        "envs_per_device": args.envs_per_device,
    }
    print(json.dumps(row))
    if args.metrics:
        with open(args.metrics, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
