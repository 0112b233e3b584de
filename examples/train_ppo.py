#!/usr/bin/env python3
"""PPO training on the vectorized engine.

The clipped-surrogate companion to examples/train_a2c.py: one jitted
shard_map program per iteration runs the on-device rollout, GAE, and
every epoch/minibatch update (see parallel/train.make_ppo_step). The
reference ships no learner at all (its experiments/ are stale torch
demos, SURVEY.md §2.11).

    python examples/train_ppo.py --env MiniWorld-OneRoomS6Fast-v0 \
        --num-envs 512 --iters 200

On a multi-chip/multi-host platform the same script scales by the
device count (the env batch is sharded over the full mesh; gradients
pmean over the data axis per minibatch).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


import argparse
import json
import time

import jax


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="MiniWorld-OneRoomS6Fast-v0")
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--obs", default="64x48")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--lam", type=float, default=0.95)
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--checkpoint", default=None,
                   help="orbax path to save params+env state each 50 iters")
    p.add_argument("--metrics", default=None,
                   help="path for per-iteration JSONL metrics")
    p.add_argument("--log-every", type=int, default=50,
                   help="iterations between metric fetches (each fetch "
                        "syncs the device pipeline)")
    args = p.parse_args()
    obs_w, obs_h = map(int, args.obs.split("x"))

    from miniworld_tpu import MiniWorldVec
    from miniworld_tpu.parallel import (
        init_multihost, make_mesh, make_ppo_step, shard_env_batch,
    )

    from miniworld_tpu.utils import compile_cache

    compile_cache.enable()
    init_multihost()
    mesh = make_mesh()
    n_dev = mesh.devices.size
    num_envs = (args.num_envs // n_dev) * n_dev
    print(f"devices: {n_dev} x {mesh.devices.flat[0].platform}, envs: {num_envs}")

    env = MiniWorldVec(args.env, num_envs=num_envs, obs_width=obs_w,
                       obs_height=obs_h)
    step, init = make_ppo_step(
        env, mesh, horizon=args.horizon, lr=args.lr, gamma=args.gamma,
        lam=args.lam, clip_eps=args.clip_eps, epochs=args.epochs,
        minibatches=args.minibatches, ent_coef=args.ent_coef,
    )
    tstate, state, obs, depth = init(jax.random.key(args.seed))
    state = shard_env_batch(mesh, state)
    obs = shard_env_batch(mesh, obs)
    depth = shard_env_batch(mesh, depth)

    metrics_f = open(args.metrics, "w") if args.metrics else None
    key = jax.random.key(args.seed + 1)
    t0 = time.perf_counter()
    steps_done = 0
    last_t, last_steps = t0, 0
    pending = []  # (iter, metrics pytree) — fetched in batches: a
    # per-iteration float() sync drains the async dispatch pipeline

    def drain(now):
        nonlocal last_t, last_steps
        if not pending:
            return
        span = max(now - last_t, 1e-9)
        span_steps = steps_done - last_steps
        pending[:] = [
            (it_, m) for (it_, _), m in zip(
                pending, jax.device_get([m for _, m in pending])
            )
        ]
        for it_, m in pending:
            row = {
                "iter": it_,
                "loss": float(m["loss"]),
                "approx_kl": float(m["approx_kl"]),
                "clip_frac": float(m["clip_frac"]),
                "reward": float(m["reward"]),
                "reward_per_step": float(m["reward"]) / (args.horizon * num_envs),
                "return_mean": float(m["return_mean"]),
                "episodes": int(m["dones"]),
                "env_steps": (it_ + 1) * args.horizon * num_envs,
                "env_steps_per_s": span_steps / span,
                "env_steps_per_s_per_chip": span_steps / span / n_dev,
                "resets_per_s": int(m["dones"]) * len(pending) / span,
            }
            if metrics_f:
                metrics_f.write(json.dumps(row) + "\n")
        if metrics_f:
            metrics_f.flush()
        it_, m = pending[-1]
        sps = steps_done / (now - t0)
        print(f"iter {it_:4d}  loss {float(m['loss']):8.4f}  "
              f"kl {float(m['approx_kl']):7.4f}  "
              f"clip {float(m['clip_frac']):5.3f}  "
              f"reward/iter {float(m['reward']):8.1f}  "
              f"episodes {int(m['dones']):5d}  {sps:,.0f} env-steps/s")
        pending.clear()
        last_t, last_steps = now, steps_done

    for it in range(args.iters):
        key, k = jax.random.split(key)
        tstate, state, obs, depth, metrics = step(tstate, state, obs, depth, k)
        steps_done += args.horizon * num_envs
        pending.append((it, metrics))
        if it % args.log_every == args.log_every - 1 or it == args.iters - 1:
            drain(time.perf_counter())
        if args.checkpoint and it and it % 50 == 0:
            from miniworld_tpu.utils import checkpoint

            checkpoint.save(f"{args.checkpoint}/it{it:06d}",
                            {"train_state": tstate, "env_state": state})
            print(f"checkpointed at iter {it}")
    if metrics_f:
        metrics_f.close()


if __name__ == "__main__":
    main()
