"""Orthographic top-down map rendering (render_top_view parity).

Jittable counterpart of MiniWorldEnv.render_top_view
(miniworld/miniworld.py:1171-1258): an aspect-fit orthographic camera
looking straight down at the full floorplan, reusing the raycaster's
triangle/entity passes with parallel (instead of perspective) rays. The
agent is drawn as a red triangle at its position/heading like the
reference's Agent.render_top (miniworld/entity.py:532-553).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from miniworld_tpu.render import raycast

TOP_CAM_HEIGHT = 10.0  # above any wall; ortho so the value is arbitrary


def render_top_view(
    bank,
    state,
    tex,
    *,
    width: int,
    height: int,
    extents,
    agent_radius: float = 0.4,
    render_agent: bool = True,
    with_depth: bool = False,
):
    """Render one env's top view. Returns (H, W, 3) u8, or
    ``(rgb, depth)`` with ``with_depth=True`` (depth = vertical hit
    distance from the orthographic camera plane, FAR for sky — the
    analog of reading the depth buffer after a ``view='top'`` render,
    miniworld.py:1305-1318).

    ``extents`` is (min_x, max_x, min_z, max_z) of the floorplan; the
    view is aspect-fit with a 1-unit margin like the reference
    (miniworld.py:1192-1212). ``render_agent`` (static) toggles the
    red agent triangle (miniworld.py:1171, `_render_world`'s
    render_agent flag at miniworld.py:1147-1166).
    """
    min_x, max_x, min_z, max_z = [jnp.asarray(v, jnp.float32) for v in extents]
    min_x, max_x = min_x - 1.0, max_x + 1.0
    min_z, max_z = min_z - 1.0, max_z + 1.0

    width_x = max_x - min_x
    width_z = max_z - min_z
    aspect = width / height
    # aspect-fit: expand one world extent to match the image aspect
    fit_x = jnp.maximum(width_x, width_z * aspect)
    fit_z = fit_x / aspect
    cx = (min_x + max_x) / 2
    cz = (min_z + max_z) / 2

    # Parallel rays straight down (-Y); image +x = world +x, image +y
    # (downward rows) = world +z, matching gluOrtho2D(min_x, max_x,
    # min_z, max_z) with the reference's flip.
    xs = cx + (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * fit_x - fit_x / 2
    zs = cz + (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * fit_z - fit_z / 2
    px = jnp.broadcast_to(xs[None, :], (height, width)).reshape(-1)
    pz = jnp.broadcast_to(zs[:, None], (height, width)).reshape(-1)
    hw = height * width

    origins = jnp.stack(
        [px, jnp.full(hw, TOP_CAM_HEIGHT, jnp.float32), pz], axis=1
    )
    down = jnp.broadcast_to(
        jnp.array([0.0, -1.0, 0.0], jnp.float32), (hw, 3)
    )

    # triangle pass with per-pixel origins: reuse the chunk scan by
    # shifting each ray to a shared origin? Ortho rays differ in origin,
    # not direction — run the scan math with per-pixel origin instead.
    tri_active = None
    if state.wall_open is not None and bank.tri_wall_onehot is not None:
        # procgen super-bank (scene/supermaze.py): open walls' closed
        # quads and closed walls' junction content don't exist this
        # episode (signed activity matvec, scene/compile.Layout)
        tri_active = (
            bank.tri_active_base[0]
            + raycast.matmul_f32(state.wall_open, bank.tri_wall_onehot[0])
        )
    t_tri, attr = _tri_pass_ortho(bank, state.layout_id, origins, down,
                                  tri_active=tri_active)
    t_ent, col_ent, n_ent = _entity_pass_ortho(bank, state, origins, down)

    # UV from the affine texture map at the hit point
    t_uv = jnp.where(jnp.isfinite(t_tri), t_tri, 0.0)
    hit_tri_p = origins + t_uv[:, None] * down
    uv = (
        jnp.stack(
            [
                jnp.sum(attr[:, 0:3] * hit_tri_p, axis=1),
                jnp.sum(attr[:, 3:6] * hit_tri_p, axis=1),
            ],
            axis=1,
        )
        + attr[:, raycast._BMAP]
    )
    if tex["mode"] == "fourier":
        # Vectorized-engine texture pack: the attr slot column already
        # carries atlas indices (variant 0 baked at install when
        # domain_rand is off; per-episode variant overrides are a
        # perspective-scan feature the top view does not apply).
        texel = raycast.eval_fourier(
            tex["coeffs"], attr[:, raycast._SLOT], uv, tex["k"],
            has_gain=tex.get("has_gain", True),
        )
    else:
        texel = raycast.eval_nearest(tex["atlas"], state.tex_map, attr[:, raycast._SLOT], uv)
    tri_color = attr[:, raycast._COL] * texel
    tri_normal = attr[:, raycast._NRM]

    ent_wins = t_ent < t_tri
    t_hit = jnp.where(ent_wins, t_ent, t_tri)
    color = jnp.where(ent_wins[:, None], col_ent, tri_color)
    normal = jnp.where(ent_wins[:, None], n_ent, tri_normal)

    hit = jnp.isfinite(t_hit)
    t_safe = jnp.where(hit, t_hit, raycast.FAR)
    hit_p = origins + t_safe[:, None] * down
    shaded = raycast.shade(color, normal, hit_p, state)
    rgb = jnp.where(hit[:, None], shaded, state.sky_color[None, :])

    if render_agent:
        # agent marker: red triangle, nose along dir_vec, width ~ radius
        # (entity.py:532-553 draws a triangle of half-length r)
        r = agent_radius
        ca, sa = jnp.cos(state.dir), jnp.sin(state.dir)
        fwd = jnp.stack([ca, -sa])
        right = jnp.stack([sa, ca])
        a_xz = jnp.stack([state.pos[0], state.pos[2]])
        p0 = a_xz + fwd * r  # nose
        p1 = a_xz - fwd * r + right * (0.75 * r)
        p2 = a_xz - fwd * r - right * (0.75 * r)
        pix = jnp.stack([px, pz], axis=1)

        def edge(a, b):
            return (pix[:, 0] - a[0]) * (b[1] - a[1]) - (pix[:, 1] - a[1]) * (b[0] - a[0])

        e0, e1, e2 = edge(p0, p1), edge(p1, p2), edge(p2, p0)
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
            (e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        rgb = jnp.where(inside[:, None], jnp.array([1.0, 0.0, 0.0]), rgb)

    rgb_u8 = jnp.clip(rgb * 255.0, 0.0, 255.0).astype(jnp.uint8)
    rgb_u8 = rgb_u8.reshape(height, width, 3)
    if with_depth:
        return rgb_u8, t_safe.reshape(height, width, 1)
    return rgb_u8


def _tri_pass_ortho(bank, layout_id, origins, dirs, tri_active=None):
    """Variant of raycast._tri_pass with per-pixel ray origins.

    ``tri_active`` ((S,) f32 0/1): per-env triangle kill for procgen
    super-banks (open walls' closed quads)."""
    num_tris = bank.tri_verts.shape[-3]
    tri_chunk = min(128, num_tris)
    n_chunks = -(-num_tris // tri_chunk)
    hw = dirs.shape[0]

    def body(carry, c):
        t_best, attr_best = carry
        start = jnp.minimum(c * tri_chunk, num_tris - tri_chunk)
        verts = jax.lax.dynamic_slice(
            bank.tri_verts, (layout_id, start, 0, 0), (1, tri_chunk, 3, 3)
        )[0]
        attrs = jax.lax.dynamic_slice(
            bank.tri_attr, (layout_id, start, 0), (1, tri_chunk, raycast.ATTR_DIM)
        )[0]
        mask = jax.lax.dynamic_slice(
            bank.tri_mask, (layout_id, start), (1, tri_chunk)
        )[0]
        if tri_active is not None:
            mask = mask & (
                jax.lax.dynamic_slice(tri_active, (start,), (tri_chunk,))
                > 0.5
            )

        v0 = verts[:, 0]
        e1 = verts[:, 1] - v0
        e2 = verts[:, 2] - v0
        g_det = jnp.cross(e2, e1)  # (TC,3)

        # per-pixel s = origin - v0 -> expand terms to keep matmul form:
        # u*det = d . (e2 x s) with s per (pixel, tri); for ortho rays
        # d is constant so compute via cross products directly.
        d = dirs[0]  # constant direction
        det = raycast.matmul_f32(g_det, d)  # (TC,)
        # s = origins[p] - v0[t]: u_num = d . (e2 x s) = s . (d x e2)
        dxe2 = jnp.cross(jnp.broadcast_to(d, e2.shape), e2)  # (TC,3)
        e1xd = jnp.cross(e1, jnp.broadcast_to(d, e1.shape))  # (TC,3)
        # (HW,3)@(3,TC) matmuls with per-tri offsets
        u_num = raycast.matmul_f32(origins, dxe2.T) - jnp.sum(v0 * dxe2, axis=1)[None, :]
        v_num = raycast.matmul_f32(origins, e1xd.T) - jnp.sum(v0 * e1xd, axis=1)[None, :]
        n_tri = jnp.cross(e1, e2)  # (TC,3)
        t_num = jnp.sum(v0 * n_tri, axis=1)[None, :] - raycast.matmul_f32(
            origins, n_tri.T)
        denom = raycast.matmul_f32(n_tri, d)  # (TC,) = -det sign convention

        inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
        inv_den = 1.0 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
        t = t_num * inv_den[None, :]
        u = u_num * inv_det[None, :]
        v = v_num * inv_det[None, :]
        # kind-blended coverage (raycast._tri_pass): triangles need
        # u + v <= 1, parallelogram prims max(u, v) <= 1
        kind = attrs[None, :, raycast._KIND]
        cov = jnp.maximum(u, v) + kind * jnp.minimum(u, v)
        hit = (
            (det > 1e-12)
            & (u >= 0.0) & (v >= 0.0) & (cov <= 1.0)
            & (t > 0.0) & (t < raycast.FAR)
            & mask[None, :]
        )
        t = jnp.where(hit, t, jnp.inf)
        t_min = jnp.min(t, axis=1)
        # unique winner (first index at the min): prim kinds repurposed
        # the attr ones column, so tie-sum normalization is no longer
        # available — argmin tie-breaks deterministically instead
        win = jnp.argmin(t, axis=1)
        ohf = (
            jnp.arange(t.shape[1])[None, :] == win[:, None]
        ).astype(jnp.float32)
        sel = raycast.matmul_f32(ohf, attrs)
        closer = t_min < t_best
        return (
            jnp.where(closer, t_min, t_best),
            jnp.where(closer[:, None], sel, attr_best),
        ), None

    init = (
        jnp.full(hw, jnp.inf, jnp.float32),
        jnp.zeros((hw, raycast.ATTR_DIM), jnp.float32),
    )
    (t_best, attr_best), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return t_best, attr_best


def _entity_pass_ortho(bank, state, origins, dirs):
    """Entity pass for per-pixel-origin parallel rays: delegate to the
    perspective pass by shifting to a common origin along -dir."""
    # For parallel rays all origins share the plane y = TOP_CAM_HEIGHT;
    # the perspective entity pass only uses origin + t*d, so shift each
    # pixel's origin into the 'origin' argument via a wrapper: entity
    # pass supports a single origin, so intersect per pixel by moving
    # the world: equivalently pass origin=0 and entity positions
    # relative... simplest correct route: vmap the scalar-origin pass
    # over nothing and inline a custom loop here.
    hw = dirs.shape[0]
    num_ents = state.ent_pos.shape[0]
    t0 = jnp.full(hw, jnp.inf, jnp.float32)
    c0 = jnp.zeros((hw, 3), jnp.float32)
    n0 = jnp.zeros((hw, 3), jnp.float32)
    layout_id = state.layout_id
    proto_shape = bank.proto_shape[layout_id]
    proto_static = bank.proto_static[layout_id]
    d = dirs[0]  # constant (0,-1,0)

    def body(carry, e):
        t_best, col_best, n_best = carry
        shape = proto_shape[state.ent_proto[e]]
        static = proto_static[state.ent_proto[e]]
        active = state.ent_alive[e] & ~static & (shape != 0)
        pos = state.ent_pos[e]
        height = state.ent_height[e]
        size = state.ent_size[e]
        color = state.ent_color[e]

        # seen from straight above, both spheres and boxes reduce to
        # their XZ footprint at the entity's top surface
        dx = origins[:, 0] - pos[0]
        dz = origins[:, 2] - pos[2]
        is_sphere = shape == raycast.SHAPE_SPHERE
        r_vis = jnp.where(is_sphere, 0.5 * height, 0.0)
        sph_hit = dx * dx + dz * dz <= r_vis * r_vis
        # box footprint in local frame
        direction = state.ent_dir[e]
        cd, sd = jnp.cos(direction), jnp.sin(direction)
        lx = dx * cd - dz * sd
        lz = dx * sd + dz * cd
        box_hit = (jnp.abs(lx) <= size[0] * 0.5) & (jnp.abs(lz) <= size[2] * 0.5)
        hit = active & jnp.where(is_sphere, sph_hit, box_hit)
        t_e = origins[:, 1] - height  # top surface
        closer = hit & (t_e < t_best)
        return (
            jnp.where(closer, t_e, t_best),
            jnp.where(closer[:, None], color[None, :], col_best),
            jnp.where(closer[:, None], jnp.array([0.0, 1.0, 0.0])[None, :], n_best),
        ), None

    (t_best, col_best, n_best), _ = jax.lax.scan(
        body, (t0, c0, n0), jnp.arange(num_ents)
    )
    return t_best, col_best, n_best
