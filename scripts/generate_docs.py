#!/usr/bin/env python3
"""Generate the environment catalog: docs/environments.md + screenshots.

Renders a live frame from every registered env family (the reference
documents its envs under docs/content/environments/ with hand-placed
images; here both the page and the images regenerate from the engine):

    python scripts/generate_docs.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
from PIL import Image

HEADER = """# Environments

All {n} registered environment IDs of the reference
(NomanTrips/Miniworld) are available, with identical observation and
action contracts, on both execution paths:

* `MiniWorldVec` — the vectorized engine (jit + vmap, on-device
  auto-reset, fused rollouts);
* `miniworld_tpu.register_gym()` + `gym.make(id)` — the single-env
  float64 gymnasium adapter, trajectory-bit-exact against the
  reference under fixed seeds (tests/test_ref_parity.py).

Screenshots are live engine renders (160x120, exact-texture mode,
regenerate with `python scripts/generate_docs.py`).

| Environment | IDs | Actions | Max steps | Screenshot |
|---|---|---|---|---|
"""


def main():
    import dataclasses

    from miniworld_tpu import MiniWorldVec
    from miniworld_tpu.envs import SPEC_CLASSES

    img_dir = "docs/images/envs"
    os.makedirs(img_dir, exist_ok=True)

    # group registered ids by spec family (Maze/MazeS2/... are distinct
    # specs; TMaze/TMazeLeft/... too — one row per spec)
    rows = []
    total_ids = 0
    for cls in SPEC_CLASSES:
        spec = cls()
        name = spec.name
        total_ids += 1
        if spec.num_layouts > 2:
            spec = dataclasses.replace(spec, num_layouts=2)
        env = MiniWorldVec(spec, num_envs=1, obs_width=160, obs_height=120,
                           tex_mode="nearest")
        state, obs = env.reset(jax.random.key(11))
        frame = next(
            leaf for leaf in jax.tree.leaves(obs)
            if getattr(leaf, "ndim", 0) == 4 and leaf.shape[-1] == 3
        )[0]
        path = f"{img_dir}/{name}.png"
        Image.fromarray(np.asarray(frame)).save(path)

        if spec.discrete_actions is not None:
            act = f"Discrete({len(spec.discrete_actions)})"
        elif getattr(spec, "num_actions", 0):
            act = f"Discrete({spec.num_actions})"
        elif getattr(spec, "click_action", False):
            act = "Box(2) click"
        else:
            act = "Box(6)"
        rows.append(
            f"| {name} | `{spec.gym_id}` | {act} | "
            f"{spec.max_episode_steps} | "
            f"![{name}](images/envs/{name}.png) |"
        )
        print(f"rendered {name}")
        del env

    with open("docs/environments.md", "w") as f:
        f.write(HEADER.format(n=total_ids))
        f.write("\n".join(rows) + "\n")
    print(f"wrote docs/environments.md ({len(rows)} families)")


if __name__ == "__main__":
    main()
