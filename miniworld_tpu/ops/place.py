"""On-device entity placement (reset-time rejection sampling).

The reference placement loop (MiniWorldEnv.place_entity,
miniworld/miniworld.py:922-992) retries unboundedly; under jit we use a
fixed retry budget and keep the first valid sample — with default room
densities the per-try success probability is high, so failures at
budget 16+ are vanishingly rare (the try is then accepted anyway, which
can only produce a slightly-overlapping spawn, never a crash).

Semantics preserved per try:
  * room sampled proportionally to bbox floor area (miniworld.py:957-963);
  * position uniform over the (possibly overridden) room bbox *expanded
    by the entity radius* (miniworld.py:966-973);
  * rejected unless strictly inside the room outline and free of
    wall/entity overlap;
  * direction sampled uniformly in the rule's range only on acceptance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from miniworld_tpu.ops import geom, rng as rng_ops


def sample_room(u: jax.Array, lay, room_weight=None) -> jax.Array:
    """Room index sampled proportionally to floor bbox area, from a
    uniform draw ``u`` in [0, 1).

    Manual inverse-CDF categorical — jax.random.choice(p=...) compiles
    pathologically slowly under vmap.

    ``room_weight`` ((R,) f32, optional) multiplies the area weights —
    procgen mazes zero out the junction rooms of closed walls, matching
    the reference's choice over rooms that exist
    (miniworld/miniworld.py:957-963).
    """
    probs = jnp.where(lay.room_mask, lay.room_area, 0.0)
    if room_weight is not None:
        probs = probs * room_weight
    cdf = jnp.cumsum(probs)
    return jnp.argmax(u * cdf[-1] < cdf).astype(jnp.int32)


def gate_segs4(segs4, codes, wall_open):
    """Deactivate per-env non-solid segments in a (4, NS) pack.

    ``codes`` ((NS,) i32): -1 = always solid; w = solid iff wall w is
    CLOSED (the closed-wall quads' collision segments,
    scene/supermaze.py). Inactive segments are shifted far away (same
    convention as the pack's SEG_PAD padding) instead of masked — the
    distance test needs no extra operand. The wall lookup is a one-hot
    contract rather than a gather (a choice made for another chip).
    """
    w = wall_open.shape[0]
    oh = (codes[:, None] == jnp.arange(w, dtype=jnp.int32)[None, :]).astype(
        jnp.float32
    )
    openv = oh @ wall_open  # (NS,)
    solid = (codes < 0) | (openv < 0.5)
    return segs4 + jnp.where(solid, 0.0, 1e9)[None, :]


def place_one(
    key: jax.Array,
    lay,
    room_segs: jax.Array,  # (L, R, 4, NS) bank-level room-local segs
    layout_id: jax.Array,  # () i32
    rule_room: jax.Array,  # () i32
    rule_bbox: jax.Array,  # (4,) f32, nan = room bbox
    rule_pos: jax.Array,  # (3,) f32, nan = sample
    rule_dir: jax.Array,  # () f32, nan = sample range
    rule_dir_lo: jax.Array,
    rule_dir_hi: jax.Array,
    radius: jax.Array,
    ent_pos_xz: jax.Array,  # (E,2) positions placed so far
    ent_radius: jax.Array,  # (E,)
    ent_mask: jax.Array,  # (E,) which rows to collide against
    budget: int = 16,
    room_weight=None,  # (R,) f32 per-env room weights (procgen)
    seg_gate=None,  # (room_seg_wall (L,R,NS), wall_open (W,)) (procgen)
):
    """Sample one entity pose. Returns (pos (3,), dir ())."""

    # Counter-based uniforms (ops/rng.py) instead of per-try key
    # splitting: jax.random's threefry lowers as rolled while-loops
    # whose per-iteration latency, vmapped over envs inside auto-reset,
    # profiled at ~14% of the Maze 8x8 step. Row i drives try i
    # ([0] room draw, [1:4] position); the last row drives the
    # budget-exhausted fallback. ``key`` may be a typed PRNG key or a
    # () u32 subseed (the vector reset path passes subseeds directly).
    if getattr(key, "dtype", None) == jnp.uint32:
        seed = key
    else:
        seed = rng_ops.cheap_seed(key)
    us = rng_ops.uniforms(seed, 1, (budget + 2, 4))
    u_dir = us[budget + 1, 1]

    def sample_dir(u):
        return jnp.where(
            jnp.isnan(rule_dir),
            rule_dir_lo + u * (rule_dir_hi - rule_dir_lo),
            rule_dir,
        )

    exact = ~jnp.isnan(rule_pos[0])

    def one_try(u):
        room_idx = jnp.where(
            rule_room >= 0, rule_room, sample_room(u[0], lay, room_weight)
        )
        aabb = lay.room_aabb[room_idx]  # [min_x, max_x, min_z, max_z]
        bbox = jnp.where(jnp.isnan(rule_bbox), aabb, rule_bbox)
        lo = jnp.stack([bbox[0] - radius, 0.0, bbox[2] - radius])
        hi = jnp.stack([bbox[1] + radius, 0.0, bbox[3] + radius])
        pos = lo + u[1:4] * (hi - lo)

        pos_xz = pos[jnp.array([0, 2])]
        inside = geom.point_inside_convex(
            pos_xz,
            lay.room_outline[room_idx],
            lay.room_norms[room_idx],
            lay.room_vmask[room_idx],
        )
        # room-local wall set for the sampled room — a (4, NS) slice
        # instead of an all-walls scan (the candidate and its radius
        # stay within the room's collision REACH; scene/compile.py)
        ns = room_segs.shape[3]
        segs4 = jax.lax.dynamic_slice(
            room_segs, (layout_id, room_idx, 0, 0), (1, 1, 4, ns)
        )[0, 0]
        if seg_gate is not None:
            rsw, wall_open = seg_gate
            codes = jax.lax.dynamic_slice(
                rsw, (layout_id, room_idx, 0), (1, 1, ns)
            )[0, 0]
            segs4 = gate_segs4(segs4, codes, wall_open)
        wall_hit = geom.circle_segs4(pos_xz, radius, segs4)
        ent_hit = (
            geom.circle_vs_entities(pos_xz, radius, ent_pos_xz, ent_radius, ent_mask)
            >= 0
        )
        ok = inside & ~wall_hit & ~ent_hit
        return pos, ok

    def body(carry, u):
        found, best = carry
        pos, ok = one_try(u)
        take = ok & ~found
        best = jnp.where(take, pos, best)
        return (found | ok, best), None

    init_pos, _ = one_try(us[budget])
    # unrolled: the rolled 16-iteration while's per-iteration latency,
    # vmapped over envs in the auto-reset path, profiled at ~14% of the
    # Maze 8x8 step; unrolling lets XLA run the independent per-try
    # work in parallel and keep only the cheap found/best chain
    (found, pos), _ = jax.lax.scan(
        body, (jnp.bool_(False), init_pos), us[:budget], unroll=True
    )

    # Budget exhausted (large radii, e.g. RoomObjects' 1.5 agent, can
    # push per-try success low enough to fire): clamp the fallback
    # into the rule room's bbox inset by the radius, so the worst case
    # is an overlapping-but-in-room spawn — never an out-of-room one
    # the walls would then trap outside.
    room_idx = jnp.where(
        rule_room >= 0, rule_room,
        sample_room(us[budget + 1, 0], lay, room_weight),
    )
    aabb = lay.room_aabb[room_idx]
    ctr = jnp.stack([
        jnp.clip(pos[0], jnp.minimum(aabb[0] + radius, aabb[1] - radius),
                 jnp.maximum(aabb[0] + radius, aabb[1] - radius)),
        pos[1] * 0.0,
        jnp.clip(pos[2], jnp.minimum(aabb[2] + radius, aabb[3] - radius),
                 jnp.maximum(aabb[2] + radius, aabb[3] - radius)),
    ])
    pos = jnp.where(found, pos, ctr)

    pos = jnp.where(exact, jnp.nan_to_num(rule_pos), pos)
    d = sample_dir(u_dir)
    return pos, d
