"""Env state pytree for the vectorized engine.

The reference's mutable object graph (Agent/Entity instances, room
lists; miniworld/entity.py, miniworld/miniworld.py:558-618) becomes one
fixed-shape ``EnvState`` pytree per environment, so thousands of envs
step in lockstep under jit+vmap and checkpoint trivially.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree whose leaves follow the
    field order, with a functional ``replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


@_pytree_dataclass
class EnvState:
    # --- agent (reference: miniworld/entity.py:455-529) ---
    pos: jax.Array  # (3,) f32, floor-level position
    dir: jax.Array  # () f32 yaw radians
    cam_pitch: jax.Array  # () f32 degrees, clamped to [-89, 89]
    cam_height: jax.Array  # () f32
    cam_fov_y: jax.Array  # () f32 degrees
    cam_fwd_disp: jax.Array  # () f32
    carrying: jax.Array  # () i32 entity index or -1

    # --- entities (padded to the env class's slot count E) ---
    ent_pos: jax.Array  # (E,3) f32
    ent_dir: jax.Array  # (E,) f32
    ent_alive: jax.Array  # (E,) bool
    ent_proto: jax.Array  # (E,) i32 prototype row
    ent_color: jax.Array  # (E,3) f32 (post color-bias)
    ent_size: jax.Array  # (E,3) f32 actual render dims
    ent_radius: jax.Array  # (E,) f32
    ent_height: jax.Array  # (E,) f32

    # --- episode ---
    step_count: jax.Array  # () i32
    rng: jax.Array  # PRNG key
    layout_id: jax.Array  # () i32 index into the layout bank

    # per-episode domain randomization samples
    sky_color: jax.Array  # (3,) f32
    light_pos: jax.Array  # (3,) f32
    light_color: jax.Array  # (3,) f32
    light_ambient: jax.Array  # (3,) f32
    tex_map: jax.Array  # (T,) i32 texture slot -> atlas index
    # () u32 texture-variant key for this episode: the render scan
    # resolves per-triangle atlas indices chunk-wise as
    # base + floor(hash01(key, slot_id) * count) (raycast.hash01) —
    # the same draws as tex_map, with no per-tri episode state. 0 when
    # domain_rand is off (draws are then forced to variant 0).
    tri_slots: jax.Array

    # Procgen episode geometry (device-side per-reset maze generation,
    # ops/mazegen.py): (W,) f32 wall-open bitmask, or None for env
    # classes without procedural wall state. The render scan, physics
    # seg masking and placement weights all derive per-env activity
    # from this one vector (scene/supermaze.py).
    wall_open: Any = None

    # env-specific task state (dict pytree; static structure per class)
    task: Any = dataclasses.field(default_factory=dict)


@_pytree_dataclass
class StepResult:
    """Side-channel outputs of the physics step used by task logic."""

    moved: jax.Array  # () bool agent translation applied
    picked_up: jax.Array  # () i32 entity picked this step, or -1
    dropped: jax.Array  # () i32 entity dropped this step, or -1


def tree_select(pred: jax.Array, a, b):
    """jnp.where over all leaves of two matching pytrees."""
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)
