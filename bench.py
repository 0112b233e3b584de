"""Benchmark: env-steps/s of the fused rollout on one GPU, RGB-D obs.

Runs the fused on-device rollout (lax.scan over step+render) and prints
ONE JSON line naming the device it ran on:

    {"metric": ..., "value": N, "unit": "env-steps/s",
     "platform": "gpu", "device_kind": ..., "device_count": N, "card": ...}

Exits non-zero when JAX's first device is not a GPU: a CPU rate is no
measurement of the card.

Usage: python bench.py [env_id] [num_envs] [horizon] [--procgen|--bank]

The Maze family DEFAULTS to device-side per-reset maze generation
(reference reset semantics; envs/nav.py Maze.procgen_default).
``--procgen`` forces that mode on, ``--bank`` forces the compiled
layout-bank fast path; without either the spec's default applies.
"""

from __future__ import annotations

import json
import sys
import time

import jax


def main():
    from miniworld_tpu.utils import compile_cache
    from miniworld_tpu.utils.device import card_name_power, require_gpu

    dev = require_gpu()
    compile_cache.enable()
    args = [a for a in sys.argv[1:] if a not in ("--procgen", "--bank")]
    procgen = True if "--procgen" in sys.argv[1:] else (
        False if "--bank" in sys.argv[1:] else None
    )
    env_id = args[0] if len(args) > 0 else "MiniWorld-Hallway-v0"
    num_envs = int(args[1]) if len(args) > 1 else 1024
    horizon = int(args[2]) if len(args) > 2 else 50

    from miniworld_tpu import MiniWorldVec

    env = MiniWorldVec(env_id, num_envs=num_envs, obs_width=80, obs_height=60,
                       with_depth=True, procgen=procgen)
    state, obs = env.reset(jax.random.key(0))

    # compile + warmup
    state, obs, outs = env.rollout(state, obs, jax.random.key(1), horizon)
    jax.block_until_ready(outs)

    best = 0.0
    checksums = []
    for trial in range(3):
        t0 = time.perf_counter()
        state, obs, outs = env.rollout(
            state, obs, jax.random.key(2 + trial), horizon
        )
        jax.block_until_ready(outs)
        checksums.append(float(jax.device_get(outs["obs_sum"]).sum()))
        dt = time.perf_counter() - t0
        best = max(best, horizon * num_envs / dt)
    # sanity: varying inputs must produce varying renders (guards
    # against any result-caching or constant-folding shortcut)
    assert len(set(checksums)) > 1, checksums

    print(json.dumps({
        "metric": f"env-steps/s ({env_id}, B={num_envs}, 80x60 RGB-D, "
                  + ("procgen, " if env.procgen else "") + "fused rollout)",
        "value": round(best),
        "unit": "env-steps/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": 1,
        "card": card_name_power(),
    }))


if __name__ == "__main__":
    main()
