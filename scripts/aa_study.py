#!/usr/bin/env python3
"""Quantify 1-spp rendering vs the reference's 8x MSAA .

The reference's obs framebuffer resolves 8 samples per pixel
(miniworld/miniworld.py:516-519, miniworld/opengl.py:219-261); the
raycaster defaults to 1 spp with frequency-space texture AA, and
supersample=2 adds 2x2 ordered-grid edge AA. This script uses the
supersample=2 render as the geometry-edge ground-truth proxy and
reports, per env over a pose sweep:

  * SSIM and PSNR of the 1-spp frame vs the 2x2-supersampled frame;
  * the same restricted to EDGE pixels (where the depth map has a
    discontinuity > 20 cm) — the only place the two can differ, since
    texture-interior AA is already handled in frequency space;
  * throughput of both modes (fused rollout), so the default can be
    picked with numbers.

    python scripts/aa_study.py [env_id ...] [--num-envs N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np

DEFAULT_ENVS = [
    "MiniWorld-Hallway-v0",
    "MiniWorld-FourRooms-v0",
    "MiniWorld-Maze-v0",
    "MiniWorld-PickupObjects-v0",
]


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Global SSIM on grayscale images in [0, 255] (single window)."""
    a = a.mean(axis=-1).astype(np.float64)
    b = b.mean(axis=-1).astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        (2 * mu_a * mu_b + c1) * (2 * cov + c2)
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )


def edge_mask(depth: np.ndarray, thresh: float = 0.2) -> np.ndarray:
    """Pixels adjacent to a depth discontinuity > thresh meters."""
    d = depth[..., 0]
    m = np.zeros_like(d, dtype=bool)
    m[:-1] |= np.abs(np.diff(d, axis=0)) > thresh
    m[1:] |= np.abs(np.diff(d, axis=0)) > thresh
    m[:, :-1] |= np.abs(np.diff(d, axis=1)) > thresh
    m[:, 1:] |= np.abs(np.diff(d, axis=1)) > thresh
    return m


def bench(env, state, obs, horizon=30, trials=2):
    state, obs, outs = env.rollout(state, obs, jax.random.key(1), horizon)
    float(jax.device_get(outs["obs_sum"]).sum())  # fence
    best = 0.0
    for t in range(trials):
        t0 = time.perf_counter()
        state, obs, outs = env.rollout(state, obs, jax.random.key(2 + t),
                                       horizon)
        float(jax.device_get(outs["obs_sum"]).sum())  # fence
        best = max(best, horizon * env.num_envs / (time.perf_counter() - t0))
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("envs", nargs="*", default=None)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--no-bench", action="store_true")
    args = ap.parse_args()

    from miniworld_tpu import MiniWorldVec

    for env_id in args.envs or DEFAULT_ENVS:
        e1 = MiniWorldVec(env_id, num_envs=args.num_envs, obs_width=80,
                          obs_height=60, supersample=1)
        e2 = MiniWorldVec(env_id, num_envs=args.num_envs, obs_width=80,
                          obs_height=60, supersample=2)
        s1, (o1, d1) = e1.reset(jax.random.key(0))
        s2, (o2, d2) = e2.reset(jax.random.key(0))
        a = np.asarray(o1, np.float64)
        b = np.asarray(o2, np.float64)
        dep = np.asarray(d1)
        ssims, edge_mae, edge_frac = [], [], []
        for i in range(min(args.num_envs, 64)):
            ssims.append(ssim(a[i], b[i]))
            m = edge_mask(dep[i])
            edge_frac.append(m.mean())
            if m.any():
                edge_mae.append(float(np.abs(a[i] - b[i])[m].mean()))
        row = {
            "env": env_id,
            "ssim_1spp_vs_2x2": round(float(np.mean(ssims)), 4),
            "edge_pixel_frac": round(float(np.mean(edge_frac)), 4),
            "edge_mae_u8": round(float(np.mean(edge_mae)), 2),
            "full_mae_u8": round(float(np.abs(a - b).mean()), 2),
        }
        if not args.no_bench:
            row["steps_s_1spp"] = round(bench(e1, s1, (o1, d1)))
            row["steps_s_2x2"] = round(bench(e2, s2, (o2, d2)))
            row["ss2_cost"] = round(
                row["steps_s_1spp"] / max(row["steps_s_2x2"], 1), 2
            )
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
