"""Pure-JAX geometry ops for the vectorized MiniWorld engine.

These are the jittable equivalents of the reference's math helpers
(reference: miniworld/math.py:11-62, miniworld/miniworld.py:273-285).
Everything here is shape-static, mask-based and jit/vmap friendly.

Conventions (same world frame as the reference):
  * +Y is up; the floor plane is y=0.
  * Agent yaw ``d`` gives forward vector (cos d, 0, -sin d) and right
    vector (sin d, 0, cos d)  (reference: miniworld/entity.py:95-113).
  * Collision geometry lives in the XZ plane: wall segments are 2D
    (x, z) pairs, entities are bounding circles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Axis vectors (reference: miniworld/math.py:6-8)
X_VEC = jnp.array([1.0, 0.0, 0.0])
Y_VEC = jnp.array([0.0, 1.0, 0.0])
Z_VEC = jnp.array([0.0, 0.0, 1.0])


def gen_rot_matrix(axis: jax.Array, angle: jax.Array) -> jax.Array:
    """3x3 matrix for a CCW rotation of ``angle`` radians about ``axis``.

    Matches the quaternion-derived construction of the reference
    (miniworld/math.py:11-27) so that downstream camera math agrees
    numerically. Note the reference applies these as row-vector
    products (``v @ M``).
    """
    axis = axis / jnp.sqrt(jnp.dot(axis, axis))
    a = jnp.cos(angle / 2.0)
    bcd = -axis * jnp.sin(angle / 2.0)
    b, c, d = bcd[0], bcd[1], bcd[2]
    return jnp.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )


def yaw_dir_vec(d: jax.Array) -> jax.Array:
    """Forward movement direction for yaw ``d`` (entity.py:95-103)."""
    return jnp.stack([jnp.cos(d), jnp.zeros_like(d), -jnp.sin(d)], axis=-1)


def yaw_right_vec(d: jax.Array) -> jax.Array:
    """Rightward direction for yaw ``d`` (entity.py:105-113)."""
    return jnp.stack([jnp.sin(d), jnp.zeros_like(d), jnp.cos(d)], axis=-1)


def intersect_circle_segs(
    point_xz: jax.Array,
    radius: jax.Array,
    segs: jax.Array,
    seg_mask: jax.Array,
) -> jax.Array:
    """True if an XZ circle intersects any valid 2D wall segment.

    Jittable variant of miniworld/math.py:30-62: the reference takes a
    ragged list of segments; here ``segs`` is a fixed-shape (S, 2, 2)
    array of (x, z) endpoint pairs with a validity mask (padding rows
    are ignored).

    Args:
      point_xz: (2,) circle center in the XZ plane.
      radius: scalar circle radius.
      segs: (S, 2, 2) segment endpoints [[x0, z0], [x1, z1]].
      seg_mask: (S,) bool validity mask.

    Returns:
      Scalar bool: any valid segment within ``radius`` of the point.
    """
    a = segs[:, 0, :]  # (S, 2)
    b = segs[:, 1, :]
    ab = b - a
    ap = point_xz[None, :] - a

    dot_ap_ab = jnp.sum(ap * ab, axis=1)
    dot_ab_ab = jnp.sum(ab * ab, axis=1)
    # Padding rows have zero-length segments; avoid 0/0.
    t = dot_ap_ab / jnp.maximum(dot_ab_ab, 1e-12)
    t = jnp.clip(t, 0.0, 1.0)

    c = a + t[:, None] * ab
    dist2 = jnp.sum((c - point_xz[None, :]) ** 2, axis=1)
    hit = (dist2 < radius * radius) & seg_mask
    return jnp.any(hit)


def circle_segs4(point_xz: jax.Array, radius: jax.Array,
                 segs4: jax.Array) -> jax.Array:
    """Circle-vs-segments over component-major (4, NS) segment packs.

    Lane-major layout of intersect_circle_segs: rows are
    [a_x, a_z, b_x, b_z] with NS segments in the minor axis, so every
    op is a wide elementwise op — the (NS, 2, 2) form's tiny inner dims
    forced relayout copies on the chip this was tuned for (not yet
    measured on the GPU). Padding columns are far-away unit segments
    (compile.SEG_PAD), never mask rows.
    """
    ax, az, bx, bz = segs4[0], segs4[1], segs4[2], segs4[3]
    abx, abz = bx - ax, bz - az
    apx = point_xz[0] - ax
    apz = point_xz[1] - az
    t = (apx * abx + apz * abz) / jnp.maximum(abx * abx + abz * abz, 1e-12)
    t = jnp.clip(t, 0.0, 1.0)
    dx = ax + t * abx - point_xz[0]
    dz = az + t * abz - point_xz[1]
    return jnp.any(dx * dx + dz * dz < radius * radius)


def point_inside_convex(
    p_xz: jax.Array,
    outline_xz: jax.Array,
    edge_norms_xz: jax.Array,
    vert_mask: jax.Array,
) -> jax.Array:
    """True if an XZ point is strictly inside a convex room outline.

    Mirrors Room.point_inside (miniworld/miniworld.py:273-285): the
    point is inside iff dot(edge_normal_i, p - outline_i) > 0 for every
    edge. Padded vertices are treated as passing.

    Args:
      p_xz: (2,) point.
      outline_xz: (V, 2) padded CCW outline vertices.
      edge_norms_xz: (V, 2) inward edge normals (normal i belongs to
        edge from vertex i to vertex i+1).
      vert_mask: (V,) bool validity mask.
    """
    ap = p_xz[None, :] - outline_xz
    dot_n_ap = jnp.sum(edge_norms_xz * ap, axis=1)
    ok = jnp.where(vert_mask, dot_n_ap > 0.0, True)
    return jnp.all(ok)


def circle_vs_entities(
    pos_xz: jax.Array,
    radius: jax.Array,
    ent_pos_xz: jax.Array,
    ent_radius: jax.Array,
    ent_mask: jax.Array,
) -> jax.Array:
    """Index of the first entity whose bounding circle overlaps, or -1.

    Mirrors the entity loop in MiniWorldEnv.intersect
    (miniworld/miniworld.py:1034-1044), which returns the first
    intersecting entity in insertion order; here "first" is the lowest
    valid index. ``ent_mask`` must already exclude the queried entity
    itself and dead/padded slots.

    Returns:
      Scalar int32 index into the entity table, or -1 if none hit.
    """
    d2 = jnp.sum((ent_pos_xz - pos_xz[None, :]) ** 2, axis=1)
    rsum = radius + ent_radius
    hit = (d2 < rsum * rsum) & ent_mask
    idx = jnp.argmax(hit)  # first True (argmax of bool picks lowest index)
    return jnp.where(jnp.any(hit), idx.astype(jnp.int32), jnp.int32(-1))


def cam_basis(yaw: jax.Array, pitch_deg: jax.Array):
    """Camera (forward, up, right) basis from agent yaw and pitch.

    Mirrors Agent.cam_dir / Agent.cam_up (miniworld/entity.py:488-517):
    pitch rotates about Z (degrees, positive = up), then yaw about Y,
    applied as row-vector products. Closed-form expansion:

      fwd = ( cos p * cos y,  sin p, -cos p * sin y)
      up  = (-sin p * cos y,  cos p,  sin p * sin y)

    right = cross(fwd, up) completes the orthonormal frame.
    """
    p = jnp.deg2rad(pitch_deg)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    fwd = jnp.stack([cp * cy, sp, -cp * sy], axis=-1)
    up = jnp.stack([-sp * cy, cp, sp * sy], axis=-1)
    right = jnp.cross(fwd, up)
    return fwd, up, right


def cam_position(
    pos: jax.Array,
    yaw: jax.Array,
    cam_height: jax.Array,
    cam_fwd_disp: jax.Array,
) -> jax.Array:
    """Camera eye position (Agent.cam_pos, miniworld/entity.py:476-486).

    The reference computes ``[cam_fwd_disp, cam_height, 0] @ rot_y(yaw)``
    which displaces the eye by ``cam_fwd_disp`` along the forward vector
    and ``cam_height`` up.
    """
    fwd = yaw_dir_vec(yaw)
    disp = fwd * cam_fwd_disp
    return pos + disp + jnp.stack(
        [jnp.zeros_like(cam_height), cam_height, jnp.zeros_like(cam_height)], axis=-1
    )
