"""Entity visibility query (get_visible_ents parity).

The reference answers "which entities are visible from the camera"
with GL occlusion queries: it renders the ROOMS ONLY (untextured —
walls/floors/ceilings, no entities) into the obs framebuffer's depth
buffer, then draws a small 0.2 m axis-aligned box at each entity's
base position inside a GL_ANY_SAMPLES_PASSED query
(miniworld/miniworld.py:1576-1670, box extents 1640-1647: pos +- 0.1
in x/z, [y, y+0.2]). An entity is "visible" iff any sample of that
box passes the depth test.

The equivalent here reproduces the query per pixel: one
PVS-culled triangle pass over the room geometry gives the static
depth map, then each entity's query box is intersected analytically
against the same pixel rays — visible iff some pixel hits the box
closer than the static depth. Semantics match GL exactly, including
the quirks the query box implies: a mostly-occluded entity whose base
box is hidden answers invisible even if its top is on screen, and the
box can make a barely-hidden entity answer visible (both directions
oracle-tested against the raycaster in tests/test_visibility.py).
Sample resolution is 1 spp vs GL's 8x MSAA (a sub-pixel sliver of the
box can land between pixel centers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from miniworld_tpu.ops import geom
from miniworld_tpu.render.raycast import FAR, NEAR, camera_rays, matmul_f32

# Query box half-extent / height (miniworld/miniworld.py:1640-1647).
BOX_R = 0.1
BOX_H = 0.2


def _room_depth(bank, layout_id, origin, dirs, tri_chunk: int = 128,
                tri_active=None):
    """Nearest ROOM-triangle hit per ray (HW,) — the depth buffer the
    occlusion queries test against (rooms only: the reference's query
    pass renders `room._render()` and nothing else,
    miniworld/miniworld.py:1627-1629; front faces only, GL_CULL_FACE).

    ``tri_active`` ((S,) f32 0/1, optional): per-env triangle activity
    for procgen super-banks (scene/supermaze.py) — open walls' closed
    quads don't occlude.
    """
    num_tris = bank.tri_verts.shape[-3]
    tri_chunk = min(tri_chunk, num_tris)
    n_chunks = -(-num_tris // tri_chunk)

    def body(t_best, c):
        start = jnp.minimum(c * tri_chunk, num_tris - tri_chunk)
        verts = jax.lax.dynamic_slice(
            bank.tri_verts, (layout_id, start, 0, 0), (1, tri_chunk, 3, 3)
        )[0]
        mask = jax.lax.dynamic_slice(
            bank.tri_mask, (layout_id, start), (1, tri_chunk)
        )[0] & jax.lax.dynamic_slice(
            bank.tri_is_room, (layout_id, start), (1, tri_chunk)
        )[0]
        if tri_active is not None:
            mask = mask & (
                jax.lax.dynamic_slice(tri_active, (start,), (tri_chunk,))
                > 0.5
            )
        kind = jax.lax.dynamic_slice(
            bank.tri_attr, (layout_id, start, 0), (1, tri_chunk, 16)
        )[0, :, 15]
        v0 = verts[:, 0]
        e1 = verts[:, 1] - v0
        e2 = verts[:, 2] - v0
        s = origin[None, :] - v0
        g_det = jnp.cross(e2, e1)
        g_u = jnp.cross(e2, s)
        g_v = jnp.cross(s, e1)
        t_num = jnp.sum(e2 * g_v, axis=-1)
        det = matmul_f32(dirs, g_det.T)
        u_num = matmul_f32(dirs, g_u.T)
        v_num = matmul_f32(dirs, g_v.T)
        inv_det = 1.0 / jnp.where(det > 1e-12, det, 1.0)
        t = t_num[None, :] * inv_det
        # kind-blended coverage (raycast._tri_pass): tri prims need
        # u + v <= det, parallelogram prims max(u, v) <= det
        cov = jnp.maximum(u_num, v_num) + kind[None, :] * jnp.minimum(
            u_num, v_num
        )
        hit = (
            (det > 1e-12)
            & (u_num >= 0.0)
            & (v_num >= 0.0)
            & (cov <= det)
            & (t > NEAR) & (t < FAR)
            & mask[None, :]
        )
        t = jnp.where(hit, t, jnp.inf)
        return jnp.minimum(t_best, jnp.min(t, axis=1)), None

    init = jnp.full(dirs.shape[0], jnp.inf, jnp.float32)
    t_best, _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return t_best


def visible_ents(bank, state, width: int = 80, height: int = 60) -> jax.Array:
    """(E,) bool: entity visible from the agent camera.

    Per-pixel transcription of the GL occlusion query: the 0.2 m query
    box at each alive entity's base position passes iff some pixel ray
    enters it in front of the room depth buffer. Rays/perspective match
    render_obs (same fov/near/far); an entity behind the camera or
    outside the frustum has no pixel ray hitting its box, exactly like
    GL clipping.
    """
    origin = geom.cam_position(
        state.pos, state.dir, state.cam_height, state.cam_fwd_disp
    )
    dirs = camera_rays(state, width, height)  # (HW, 3)
    tri_active = None
    if state.wall_open is not None and bank.tri_wall_onehot is not None:
        tri_active = (
            bank.tri_active_base[0]
            + matmul_f32(state.wall_open, bank.tri_wall_onehot[0])
        )
    d_static = _room_depth(bank, state.layout_id, origin, dirs,
                           tri_active=tri_active)  # (HW,)

    safe_d = jnp.where(jnp.abs(dirs) < 1e-12, 1e-12, dirs)  # (HW, 3)

    def one(pos, alive):
        lo = pos + jnp.asarray([-BOX_R, 0.0, -BOX_R], jnp.float32)
        hi = pos + jnp.asarray([BOX_R, BOX_H, BOX_R], jnp.float32)
        t1 = (lo[None, :] - origin[None, :]) / safe_d
        t2 = (hi[None, :] - origin[None, :]) / safe_d
        t_in = jnp.max(jnp.minimum(t1, t2), axis=1)
        t_out = jnp.min(jnp.maximum(t1, t2), axis=1)
        # GL renders the box's front faces depth-tested with GL_LESS;
        # from inside the box the faces are back-facing (culled)
        hit = (t_in <= t_out) & (t_in > NEAR) & (t_in < FAR)
        return alive & jnp.any(hit & (t_in < d_static))

    return jax.vmap(one)(state.ent_pos, state.ent_alive)
