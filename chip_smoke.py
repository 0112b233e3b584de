#!/usr/bin/env python3
"""Bring-up check on NVIDIA GPUs: the env engine and its trainer, end to end.

    python chip_smoke.py            # P0-P3 on one card
    python chip_smoke.py --gpus 4   # P0 + P4 only: 4-card sharding vs 1 card

Everything runs in this one process: a JAX process reserves most of a
card's memory, so a second one would fail.

  P0  device: card name and power limit (nvidia-smi), device kind, JAX
      version and the memory JAX may use.
  P1  GPU-vs-CPU parity: seven envs that together cover every render
      path, B=16 at 80x60 RGB-D, reset + 8 steps with fixed keys and
      actions on the GPU against the same code compiled by XLA:CPU in
      f32 (the plain reference; the tier-1 tests hold it to the float64
      host adapter). Renders are compared on the SAME input state (the
      GPU state copied to the CPU), so physics drift is not counted as
      render error.
  P2  fused rollout at deployment sizes: compile seconds, env-steps/s,
      peak device memory and the compiled program's memory analysis.
  P3  trainer: A2C and PPO train steps; loss finite, params move,
      env-steps/s with the learner.
  P4  (--gpus N only) sharded rollout and A2C step on an N-device mesh
      against a 1-device mesh of the same global batch in this process.

There is no CPU fallback: without a GPU the script raises before any
phase runs. Any failed check raises. The last line of stdout is one
JSON object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# The CPU backend is the parity reference; keep it available when the
# platform list is pinned to the GPU.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# --- P1 tolerances (reasons in PERF.md, "P1 parity") -------------------
STATE_ATOL = 5e-4  # pos/dir/ent_pos: the f32-vs-f64 bound of test_golden
RGB_MEAN_MAX = 1.0  # mean |delta| per channel, u8 levels
RGB_BIG_LEVELS = 8  # a pixel "differs" when a channel moves more than this
RGB_BIG_FRAC = 0.01  # share of pixels allowed to differ (silhouette ties)
DEPTH_RTOL = 1e-3  # where both renders hit and RGB agrees
FAR = 100.0  # raycast.FAR: the depth of sky pixels

PARITY_ENVS = (  # (env id, procgen, render path covered)
    ("MiniWorld-Hallway-v0", None, "box-only"),
    ("MiniWorld-FourRooms-v0", None, "chunk-vis / packed PVS"),
    ("MiniWorld-PutNext-v0", None, "box entities"),
    ("MiniWorld-PickupObjects-v0", None, "mesh-entity pass"),
    ("MiniWorld-MazeS3-v0", True, "procgen paired super bank"),
    ("MiniWorld-Sign-v0", None, "Dict obs, K=64 SDF textures"),
    ("MiniWorld-CollectHealth-v0", None, "18 mesh entities"),
)
ROLLOUT_CELLS = (  # (env id, B, horizon, procgen), 80x60 RGB-D
    ("MiniWorld-Hallway-v0", 1024, 50, None),
    ("MiniWorld-PickupObjects-v0", 4096, 50, None),
    ("MiniWorld-MazeS3-v0", 2048, 50, True),
)
TRAIN_ENV = "MiniWorld-OneRoomS6Fast-v0"


class ParityError(AssertionError):
    """A GPU result outside the stated tolerance of the CPU reference."""


def image(obs):
    """The RGB leaf of an observation (Dict-obs envs nest it)."""
    return obs["obs"] if isinstance(obs, dict) else obs


def state_deltas(g, c, rew_g, rew_c, done_g, done_c) -> dict:
    """Worst |GPU - CPU| of the agent and entity state; reward and done
    must match exactly. Raises ParityError beyond STATE_ATOL."""
    out = {k: float(np.max(np.abs(np.asarray(getattr(g, k), np.float64)
                                  - np.asarray(getattr(c, k), np.float64))))
           for k in ("pos", "dir", "ent_pos")}
    bad = {k: v for k, v in out.items() if not v <= STATE_ATOL}
    if bad:
        raise ParityError(f"state beyond atol {STATE_ATOL}: {bad}")
    if not np.array_equal(np.asarray(rew_g), np.asarray(rew_c)):
        raise ParityError(f"reward differs: {rew_g} vs {rew_c}")
    if not np.array_equal(np.asarray(done_g), np.asarray(done_c)):
        raise ParityError(f"done differs: {done_g} vs {done_c}")
    return out


def render_deltas(rgb_g, rgb_c, depth_g, depth_c) -> dict:
    """GPU vs CPU renders of the same states: worst per-channel mean
    |delta| (u8 levels), share of pixels with a channel off by more than
    RGB_BIG_LEVELS, and worst relative depth error where both renders
    hit and RGB agrees. Raises ParityError beyond the tolerances."""
    diff = np.abs(np.asarray(rgb_g, np.int16) - np.asarray(rgb_c, np.int16))
    mean_abs = float(diff.reshape(-1, 3).mean(axis=0).max())
    big = diff.max(axis=-1) > RGB_BIG_LEVELS
    big_frac = float(big.mean())
    dg = np.asarray(depth_g, np.float64)[..., 0]
    dc = np.asarray(depth_c, np.float64)[..., 0]
    both = (dg < FAR) & (dc < FAR) & ~big
    rel = np.abs(dg - dc) / np.maximum(np.abs(dc), 1e-6)
    depth_rel = float(rel[both].max()) if both.any() else 0.0
    out = {"rgb_mean_abs": mean_abs, "rgb_big_frac": big_frac,
           "depth_rel": depth_rel}
    if not (mean_abs <= RGB_MEAN_MAX and big_frac <= RGB_BIG_FRAC
            and depth_rel <= DEPTH_RTOL):
        raise ParityError(f"render beyond tolerance: {out}")
    return out


def _worst(acc: dict, new: dict):
    for k, v in new.items():
        acc[k] = max(acc.get(k, 0.0), v)


def parity_env(env_id, procgen, dev, cpu, num_envs=16, width=80,
               height=60, steps=8, seed=0) -> dict:
    """P1 for one env: worst state and render deltas over reset + steps."""
    from miniworld_tpu import MiniWorldVec

    kw = dict(num_envs=num_envs, obs_width=width, obs_height=height,
              procgen=procgen)
    with jax.default_device(dev):
        env_g = MiniWorldVec(env_id, **kw)
    with jax.default_device(cpu):
        env_c = MiniWorldVec(env_id, **kw)
        actions = [np.asarray(env_c.sample_actions(jax.random.key(1000 + t)))
                   for t in range(steps)]

    def gpu_traj():
        with jax.default_device(dev):
            s, (o, d) = env_g.reset(jax.random.key(seed))
            out = [(s, o, d, None, None)]
            for a in actions:
                s, (o, d), r, dn, _ = env_g.step(s, jnp.asarray(a))
                out.append((s, o, d, r, dn))
            return jax.device_get(out)

    def cpu_traj():
        with jax.default_device(cpu):
            s, _ = env_c.reset(jax.random.key(seed))
            out = [(s, None, None)]
            for a in actions:
                s, _, r, dn, _ = env_c.step(s, jnp.asarray(a))
                out.append((s, r, dn))
            return jax.device_get(out)

    t0 = time.perf_counter()
    traj_g = gpu_traj()
    t1 = time.perf_counter()
    traj_c = cpu_traj()
    worst = {"gpu_s": t1 - t0, "cpu_s": time.perf_counter() - t1}
    with jax.default_device(cpu):
        for (s_g, o_g, d_g, r_g, dn_g), (s_c, r_c, dn_c) in zip(traj_g, traj_c):
            if r_g is None:  # reset: no reward/done yet
                r_g = r_c = dn_g = dn_c = np.zeros(())
            _worst(worst, state_deltas(s_g, s_c, r_g, r_c, dn_g, dn_c))
            s_on_cpu = jax.device_put(s_g, cpu)
            o_c, d_c = env_c._render_jit(env_c._bank, env_c._atlas, s_on_cpu)
            if isinstance(o_g, dict) and not np.array_equal(
                    np.asarray(o_g["goal"]), np.asarray(o_c["goal"])):
                raise ParityError(f"{env_id}: Dict-obs goal differs")
            _worst(worst, render_deltas(image(o_g), image(o_c), d_g, d_c))
    return worst


def phase_parity(dev, card, envs=PARITY_ENVS, workers=None, **kw) -> float:
    """P1 over ``envs``; returns its wall seconds."""
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    # one thread per env, so the CPU reference's compiles (which release
    # the GIL) overlap the GPU's; the GPU compiles themselves were seen
    # to run one at a time (PERF.md section 5)
    with ThreadPoolExecutor(workers or len(envs)) as pool:
        futs = [pool.submit(parity_env, e, pg, dev, cpu, **kw)
                for e, pg, _ in envs]
        results = [f.result() for f in futs]
    for (env_id, _, path), w in zip(envs, results):
        print(f"P1 {env_id} [{path}] PASS worst: "
              + ", ".join(f"{k}={v:.3g}" for k, v in w.items()))
    wall = time.perf_counter() - t0
    print(f"P1 parity: {len(envs)} envs passed in {wall:.1f} s [{card}]")
    return wall


def _memory_analysis(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k) for k in keys if hasattr(m, k)}


def phase_rollout(dev, card, cells=ROLLOUT_CELLS, width=80, height=60,
                  trials=3) -> float:
    """P2: returns the seconds spent compiling."""
    from miniworld_tpu import MiniWorldVec

    compile_s = 0.0
    for env_id, num_envs, horizon, procgen in cells:
        t0 = time.perf_counter()
        env = MiniWorldVec(env_id, num_envs=num_envs, obs_width=width,
                           obs_height=height, procgen=procgen)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, (obs, depth) = env.reset(jax.random.key(0))
        jax.block_until_ready(obs)
        reset_s = time.perf_counter() - t0  # reset + render compile + run
        args = (env._bank, env._atlas, state, obs, depth)
        t0 = time.perf_counter()
        compiled = jax.jit(env.rollout_fn(horizon)).lower(
            *args, jax.random.key(1)).compile()
        comp_s = time.perf_counter() - t0
        compile_s += comp_s + reset_s
        state, obs, depth, outs = compiled(*args, jax.random.key(1))
        jax.block_until_ready(outs)  # warm-up
        rates, sums = [], []
        for trial in range(trials):
            t0 = time.perf_counter()
            state, obs, depth, outs = compiled(
                env._bank, env._atlas, state, obs, depth,
                jax.random.key(2 + trial))
            jax.block_until_ready(outs)
            sums.append(int(jax.device_get(outs["obs_sum"]).sum()))
            rates.append(horizon * num_envs / (time.perf_counter() - t0))
        # varying inputs must give varying renders
        if len(set(sums)) < 2:
            raise AssertionError(f"{env_id}: checksums do not vary: {sums}")
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
        label = f"{env_id.split('-')[1]} B={num_envs} h={horizon}" + (
            " procgen" if env.procgen else "")
        print(f"P2 {label}: build {build_s:.1f} s, reset+render compile "
              f"{reset_s:.1f} s, rollout compile {comp_s:.1f} s; "
              f"env-steps/s per trial {[round(r) for r in rates]}, "
              f"median {np.median(rates):.0f} [{card}]")
        print(f"P2 {label}: process peak_bytes_in_use {peak}, "
              f"memory_analysis {_memory_analysis(compiled)}")
    return compile_s


def _params_delta(a, b) -> float:
    return float(sum(jnp.abs(x - y).sum() for x, y in zip(
        jax.tree.leaves(a), jax.tree.leaves(b))))


def _train(make, env, mesh, iters, key, **kw):
    """Run ``iters`` (>= 3) train iterations; returns (seconds of the
    first, compiling, iteration; env-steps/s of iterations 3.., after
    one untimed warm iteration; losses; params moved)."""
    from miniworld_tpu.parallel import replicate, shard_env_batch

    step, init = make(env, mesh, **kw)
    tstate, state, obs, depth = init(jax.random.key(key))
    # inputs placed as the step's outputs are, so iteration 2 reuses
    # iteration 1's executable
    tstate = replicate(mesh, tstate)
    state, obs, depth = shard_env_batch(mesh, (state, obs, depth))
    params0 = tstate["params"]
    losses = []
    t0 = time.perf_counter()
    tstate, state, obs, depth, m = step(tstate, state, obs, depth,
                                        jax.random.key(key + 1))
    losses.append(m["loss"])
    jax.block_until_ready(m)
    first_s = time.perf_counter() - t0
    for it in range(1, iters):
        if it == 2:
            jax.block_until_ready(m)
            t0 = time.perf_counter()
        tstate, state, obs, depth, m = step(tstate, state, obs, depth,
                                            jax.random.key(key + 1 + it))
        losses.append(m["loss"])
    jax.block_until_ready(m)
    dt = time.perf_counter() - t0
    losses = [float(x) for x in jax.device_get(losses)]
    rate = (iters - 2) * kw["horizon"] * env.num_envs / dt
    return first_s, rate, losses, _params_delta(params0, tstate["params"])


def phase_train(dev, card, num_envs=1024, width=64, height=48, horizon=16,
                a2c_iters=5, ppo_iters=4) -> float:
    """P3: returns the seconds of the first (compiling) iterations."""
    from miniworld_tpu import MiniWorldVec
    from miniworld_tpu.parallel import make_mesh, make_ppo_step, make_train_step

    env = MiniWorldVec(TRAIN_ENV, num_envs=num_envs, obs_width=width,
                       obs_height=height)
    mesh = make_mesh(1)
    compile_s = 0.0
    for name, make, iters in (("A2C", make_train_step, a2c_iters),
                              ("PPO", make_ppo_step, ppo_iters)):
        first_s, rate, losses, moved = _train(
            make, env, mesh, iters, 10, horizon=horizon)
        compile_s += first_s
        if not (np.isfinite(losses).all() and moved > 0):
            raise AssertionError(f"{name}: losses {losses}, params moved {moved}")
        print(f"P3 {name} {TRAIN_ENV} B={num_envs} {width}x{height} "
              f"h={horizon}: first iteration (compile) {first_s:.1f} s, "
              f"losses {[round(x, 5) for x in losses]}, |dparams| {moved:.4g}, "
              f"{rate:.0f} env-steps/s with the learner [{card}]")
    return compile_s


def phase_multi(n_gpus, card, per_card=1024, width=64, height=48, horizon=4):
    """P4: the sharded rollout and A2C step on n_gpus devices against one
    device running the same global batch."""
    from miniworld_tpu import MiniWorldVec
    from miniworld_tpu.parallel import (
        make_mesh, make_sharded_rollout, make_train_step, replicate,
        shard_env_batch,
    )

    if jax.device_count() < n_gpus:
        raise RuntimeError(f"--gpus {n_gpus}: only {jax.device_count()} devices")
    env = MiniWorldVec(TRAIN_ENV, num_envs=per_card * n_gpus,
                       obs_width=width, obs_height=height)
    res = {}
    for n_dev in (n_gpus, 1):
        mesh = make_mesh(n_dev)
        roll = make_sharded_rollout(env, mesh, horizon)
        state, obs, depth = roll.init(jax.random.key(0))
        keys = replicate(mesh, [jax.random.key(i) for i in range(1, 6)])
        for k in keys[:2]:  # compile, then one untimed warm call
            state, obs, depth, outs = roll.step(state, obs, depth, k)
        jax.block_until_ready(outs)
        # steady steps: no implicit transfer may happen (the bank and
        # atlas are replicated once, the inputs already sharded)
        with jax.transfer_guard("disallow"):
            t0 = time.perf_counter()
            for k in keys[2:]:
                state, obs, depth, outs = roll.step(state, obs, depth, k)
            jax.block_until_ready(outs)
            roll_rate = (len(keys) - 2) * horizon * env.num_envs / (
                time.perf_counter() - t0)
        sums = np.asarray(obs, np.int64).reshape(env.num_envs, -1).sum(axis=1)
        roll_coll = roll.compiled_has_collectives(state, obs, depth, keys[0])

        step, init = make_train_step(env, mesh, horizon=horizon)
        tstate, state, obs, depth = init(jax.random.key(3))
        state, obs, depth = shard_env_batch(mesh, (state, obs, depth))
        tstate = replicate(mesh, tstate)
        keys = replicate(mesh, [jax.random.key(i) for i in range(10, 15)])
        tstate, state, obs, depth, m = step(tstate, state, obs, depth, keys[0])
        loss1 = float(m["loss"])
        tstate, state, obs, depth, m = step(tstate, state, obs, depth, keys[1])
        jax.block_until_ready(m)
        with jax.transfer_guard("disallow"):
            t0 = time.perf_counter()
            for k in keys[2:]:
                tstate, state, obs, depth, m = step(tstate, state, obs,
                                                    depth, k)
            jax.block_until_ready(m)
            train_rate = (len(keys) - 2) * horizon * env.num_envs / (
                time.perf_counter() - t0)
        txt = step.lower(tstate, state, obs, depth, keys[0]).compile().as_text()
        res[n_dev] = dict(sums=sums, roll_coll=roll_coll, loss1=loss1,
                          train_allreduce="all-reduce" in txt,
                          roll_rate=roll_rate, train_rate=train_rate)
        print(f"P4 mesh({n_dev}) B={env.num_envs} {width}x{height} "
              f"h={horizon}, 3 timed calls: rollout {roll_rate:.0f} env-steps/s "
              f"(collectives: {roll_coll}), A2C {train_rate:.0f} env-steps/s "
              f"(all-reduce: {res[n_dev]['train_allreduce']}), first loss "
              f"{loss1:.6g} [{card}]")
    many, one = res[n_gpus], res[1]
    mismatched = int((many["sums"] != one["sums"]).sum())
    rel = abs(many["loss1"] - one["loss1"]) / max(abs(one["loss1"]), 1e-12)
    print(f"P4 per-env obs checksums differing: {mismatched}/{env.num_envs}; "
          f"first-loss rel diff {rel:.3g}")
    if mismatched:
        raise AssertionError(f"{mismatched} per-env checksums differ")
    if not rel <= 1e-3:
        raise AssertionError(f"first-iteration loss rel diff {rel}")
    if many["roll_coll"] or one["roll_coll"]:
        raise AssertionError("the rollout program has collectives")
    if not many["train_allreduce"]:
        raise AssertionError("the sharded train step has no all-reduce")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gpus", type=int, default=1,
                   help="1: phases P0-P3 on one card; N > 1: P0 and the "
                        "N-card sharding check P4 only")
    args = p.parse_args(argv)

    from miniworld_tpu.utils import compile_cache
    from miniworld_tpu.utils.device import card_name_power, require_gpu

    dev = require_gpu()
    t_start = time.perf_counter()
    cache_dir = compile_cache.enable()
    card = card_name_power()
    print(f"P0 card (nvidia-smi name, power.limit): {card}")
    print(f"P0 jax {jax.__version__}: {jax.device_count()} x {dev.platform} "
          f"{dev.device_kind}, bytes_limit "
          f"{(dev.memory_stats() or {}).get('bytes_limit')}, compile cache {cache_dir}")

    if args.gpus > 1:
        phase_multi(args.gpus, card)
        count = args.gpus
    else:
        # P1 runs B=16 for 8 steps: its wall time is compilation
        compile_s = phase_parity(dev, card)
        compile_s += phase_rollout(dev, card)
        compile_s += phase_train(dev, card)
        total = time.perf_counter() - t_start
        print(f"compile share: {compile_s:.1f} s of {total:.1f} s "
              f"({compile_s / total:.0%}; P1 wall + P2 compiles + P3 "
              f"first iterations)")
        count = 1
    sys.stdout.flush()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
