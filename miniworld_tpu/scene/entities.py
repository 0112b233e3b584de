"""Entity definitions and their compiled prototypes.

Host-side entity model replacing the reference's OO entities
(miniworld/entity.py). Each entity *definition* carries the physical
attributes the reference derives (radius, height, colors), and compiles
to either:

  * baked static triangles (static meshes, ImageFrame, TextFrame — the
    reference renders these from the static display list,
    miniworld.py:1140-1143), or
  * a *prototype* row in a fixed-shape table for dynamic entities the
    raycaster draws analytically each frame.

Dynamic-entity shapes: BOX (exact analytic OBB), SPHERE (Ball — the
reference's ball mesh is a tessellated sphere), and MESH_TRIS — the
mesh's ACTUAL triangles, decimated to a budget and packed as
local-space render rows the raycaster intersects per frame
(render/raycast._entity_mesh_pass), textures included. Physics
radii/heights match the reference exactly for every shape
(miniworld/entity.py:124-165, objmesh.py:280-292).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np

from miniworld_tpu.scene.mesh import load_mesh
from miniworld_tpu.scene.room import TriBatch
from miniworld_tpu.utils.assets import (
    png_size, read_png_rgb, resize_rgb, texture_variant_paths,
)

# Named colors (reference: miniworld/entity.py:30-40)
COLORS = {
    "red": np.array([1.0, 0.0, 0.0]),
    "green": np.array([0.0, 1.0, 0.0]),
    "blue": np.array([0.0, 0.0, 1.0]),
    "purple": np.array([0.44, 0.15, 0.76]),
    "yellow": np.array([1.00, 1.00, 0.00]),
    "grey": np.array([0.39, 0.39, 0.39]),
}
COLOR_NAMES = sorted(COLORS.keys())

# Shape codes for the raycaster's dynamic-entity pass
SHAPE_NONE = 0
SHAPE_BOX = 1
SHAPE_SPHERE = 2
SHAPE_MESH_BOX = 3
SHAPE_MESH_TRIS = 4

# Triangle budget per dynamic-mesh prototype (scene/mesh.decimate_mesh).
# 48 keeps a key/duckie silhouette recognizable while the per-(pixel,
# triangle) render cost stays within the entity-pass budget.
MESH_TRI_BUDGET = 48
# Packed mesh-row layout: [verts(9) | attr(16)] where attr matches
# render/raycast.ATTR_DIM ([A(6) | b(2) | normal(3) | color(3) | slot | one])
# in the proto's LOCAL frame; the renderer composes the entity's world
# transform into the attrs per frame.
MESH_ROW_DIM = 25


def rot_y(angle: float) -> np.ndarray:
    """Column-vector rotation about +Y; R @ (1,0,0) == dir_vec(angle)."""
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclass
class Proto:
    """One dynamic-entity prototype row."""

    shape: int
    size: np.ndarray  # (3,) box dims / impostor dims; sphere: (d, h, d)
    radius: float
    height: float
    color: np.ndarray  # (3,)
    colorable: bool = False  # Box: obj_color_bias applies (entity.py:405-407)
    static: bool = False
    pickable: bool = True  # not is_static
    # (K, MESH_ROW_DIM) packed local-space triangle rows; only
    # meaningful for SHAPE_MESH_TRIS
    mesh_rows: np.ndarray | None = None

    def __post_init__(self):
        self.size = np.asarray(self.size, dtype=np.float64)
        self.color = np.asarray(self.color, dtype=np.float64)


def _face_colors_areas(mesh):
    """Per-face effective colors (Kd x mean texture color) and areas."""
    v = mesh.verts
    areas = 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1
    )
    colors = mesh.colors.copy()
    for t, tex in enumerate(mesh.tex_names):
        if tex is not None:
            colors[t] = colors[t] * _texture_mean(tex)
    return colors, areas


@functools.lru_cache(maxsize=None)
def _texture_mean(path: str) -> np.ndarray:
    """Mean colour in [0, 1] of a mesh texture: the mean of its 8x8
    bicubic thumbnail (PIL's default ``Image.resize`` filter)."""
    thumb = resize_rgb(read_png_rgb(path), 8, 8, "bicubic")
    return thumb.reshape(-1, 3).mean(axis=0) / 255.0


def _mesh_color(mesh) -> np.ndarray:
    """Area-weighted mean color of a mesh (Kd x mean texture color)."""
    colors, areas = _face_colors_areas(mesh)
    w = areas / max(areas.sum(), 1e-9)
    return (colors * w[:, None]).sum(axis=0)


def mesh_scale_radius(mesh_name: str, height: float):
    """MeshEnt scale/radius derivation (miniworld/entity.py:132-148)."""
    mesh = load_mesh(mesh_name)
    sx, sy, sz = mesh.ref_max_coords
    scale = height / sy
    radius = math.sqrt(sx * sx + sz * sz) * scale
    return mesh, scale, radius


def _box_rows(size) -> np.ndarray:
    """12 packed local-space triangle rows for a box spanning
    [-sx/2, sx/2] x [0, sy] x [-sz/2, sz/2] (drawBox extents,
    entity.py:409-432), CCW-outward winding (the raycaster backface
    culls), flat white color (the entity tint multiplies in at render
    time), untextured."""
    sx, sy, sz = [float(v) for v in size]
    hx, hz = sx / 2, sz / 2
    # (origin, u, v) per face; normal = u x v points outward
    faces = [
        ((hx, 0, hz), (0, 0, -sz), (0, sy, 0)),    # +x
        ((-hx, 0, -hz), (0, 0, sz), (0, sy, 0)),   # -x
        ((-hx, 0, hz), (sx, 0, 0), (0, sy, 0)),    # +z
        ((hx, 0, -hz), (-sx, 0, 0), (0, sy, 0)),   # -z
        ((-hx, sy, -hz), (0, 0, sz), (sx, 0, 0)),  # top
        ((-hx, 0, -hz), (sx, 0, 0), (0, 0, sz)),   # bottom
    ]
    rows = np.zeros((12, MESH_ROW_DIM), dtype=np.float32)
    for f, (p, u, v) in enumerate(faces):
        p, u, v = np.asarray(p), np.asarray(u), np.asarray(v)
        quad = [p, p + u, p + u + v, p + v]
        n = np.cross(u, v)
        n = n / np.linalg.norm(n)
        for t, idx in enumerate(((0, 1, 2), (0, 2, 3))):
            r = rows[2 * f + t]
            r[0:9] = np.concatenate([quad[i] for i in idx])
            r[17:20] = n
            r[20:23] = 1.0
            r[23] = -1.0  # untextured
            r[24] = 1.0
    return rows


def box_proto(color: str, size=0.8) -> Proto:
    """Colored box (miniworld/entity.py:386-432).

    Default shape is the analytic OBB; scene compilation converts box
    protos to 12 mesh rows (SHAPE_MESH_TRIS, via ``_box_rows``) when
    the world already runs the mesh-entity pass — merged boxes were
    faster there, while box-only scenes keep the cheaper analytic
    branch (measured both ways on another chip; not yet on the GPU)."""
    if isinstance(size, (int, float)):
        size = np.array([size, size, size], dtype=np.float64)
    size = np.asarray(size, dtype=np.float64)
    sx, sy, sz = size
    return Proto(
        shape=SHAPE_BOX,
        size=size,
        radius=math.sqrt(sx * sx + sz * sz) / 2,
        height=float(sy),
        color=COLORS[color],
        colorable=True,
    )


def ball_proto(color: str, size=0.6) -> Proto:
    """Ball = ball_{color} mesh at height ``size`` (entity.py:445-452).

    Rendered as an analytic sphere (the source mesh is a tessellated
    sphere); physics radius follows the MeshEnt formula.
    """
    mesh, scale, radius = mesh_scale_radius(f"ball_{color}", size)
    return Proto(
        shape=SHAPE_SPHERE,
        size=np.array([size, size, size]),
        radius=radius,
        height=float(size),
        color=_mesh_color(mesh),
    )


def key_proto(color: str, slot_fn=None) -> Proto:
    """Key = key_{color} mesh at height 0.35 (entity.py:435-442)."""
    return mesh_box_proto(f"key_{color}", 0.35, static=False, slot_fn=slot_fn)


def affine_uv_maps(verts: np.ndarray, uvs: np.ndarray):
    """Per-triangle affine texture maps uv = A @ p + b.

    For points p on the triangle's plane the map reproduces the
    barycentric-interpolated UVs, letting the renderer derive texture
    coordinates from the hit point with two dot products instead of
    per-pixel barycentric selects (see scene/compile.py packing).
    verts (T,3,3), uvs (T,3,2) -> (A (T,2,3), b (T,2)), float64.
    """
    v0 = verts[:, 0].astype(np.float64)
    e1 = verts[:, 1].astype(np.float64) - v0
    e2 = verts[:, 2].astype(np.float64) - v0
    uv0 = uvs[:, 0, :].astype(np.float64)
    duv1 = uvs[:, 1, :].astype(np.float64) - uv0
    duv2 = uvs[:, 2, :].astype(np.float64) - uv0
    l11 = np.sum(e1 * e1, axis=1)
    l22 = np.sum(e2 * e2, axis=1)
    l12 = np.sum(e1 * e2, axis=1)
    den = np.maximum(l11 * l22 - l12 * l12, 1e-18)
    gu = (l22[:, None] * e1 - l12[:, None] * e2) / den[:, None]
    gv = (l11[:, None] * e2 - l12[:, None] * e1) / den[:, None]
    a_map = duv1[:, :, None] * gu[:, None, :] + duv2[:, :, None] * gv[:, None, :]
    b_map = uv0 - np.einsum("tij,tj->ti", a_map, v0)
    return a_map, b_map


def _mesh_tri_rows(mesh, scale: float, slot_fn=None,
                   budget: int = MESH_TRI_BUDGET) -> np.ndarray:
    """Pack a (decimated, scaled) mesh into local-space render rows.

    Row = [verts(9) | A(6) | b(2) | normal(3) | color(3) | slot | one]
    — the attr half is raycast.ATTR_DIM in the proto's LOCAL frame
    (recentered, scaled; entity yaw/translation/size_mul are composed
    in at render time). ``slot_fn`` maps a texture path to a
    layout-local texture slot; without it textured faces fall back to
    their Kd color untextured.
    """
    from miniworld_tpu.scene.mesh import decimate_mesh

    dm = decimate_mesh(mesh, budget)
    verts = dm.verts * scale
    k = verts.shape[0]
    a_map, b_map = affine_uv_maps(verts, dm.uvs)
    n = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nl = np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    n = n / nl
    rows = np.zeros((k, MESH_ROW_DIM), dtype=np.float32)
    rows[:, 0:9] = verts.reshape(k, 9)
    rows[:, 9:15] = a_map.reshape(k, 6)
    rows[:, 15:17] = b_map
    rows[:, 17:20] = n
    rows[:, 20:23] = dm.colors
    for t in range(k):
        tex = dm.tex_names[t]
        rows[t, 23] = slot_fn(tex) if (tex is not None and slot_fn) else -1
    rows[:, 24] = 1.0
    return rows


def mesh_box_proto(mesh_name: str, height: float, static: bool = True,
                   slot_fn=None) -> Proto:
    """Mesh entity prototype.

    Static meshes keep the OBB (their visuals are baked triangles; the
    proto only matters for collision). Dynamic meshes carry their
    actual decimated triangles (``mesh_rows``) which the raycaster
    intersects per frame — real silhouettes AND textures, replacing
    round 1's convex-hull impostors (reference objmesh.py:280-292,
    entity.py:124-165).
    """
    mesh, scale, radius = mesh_scale_radius(mesh_name, height)
    dims = (mesh.bbox_hi - mesh.bbox_lo) * scale
    proto = Proto(
        shape=SHAPE_MESH_BOX if static else SHAPE_MESH_TRIS,
        size=dims,
        radius=radius,
        height=float(height),
        color=_mesh_color(mesh),
        static=static,
        pickable=not static,
    )
    if not static:
        proto.mesh_rows = _mesh_tri_rows(mesh, scale, slot_fn)
    return proto


def bake_static_mesh(
    tris: TriBatch, mesh_name: str, height: float, pos, direction, tex_slot_fn
):
    """Bake a static MeshEnt into the scene triangle soup.

    Applies the reference's model transform (translate, uniform scale,
    CCW yaw rotation; miniworld/entity.py:150-161).
    """
    mesh, scale, _ = mesh_scale_radius(mesh_name, height)
    r = rot_y(float(direction))
    pos = np.asarray(pos, dtype=np.float64)
    verts = np.einsum("ij,tvj->tvi", r, mesh.verts * scale) + pos
    for t in range(mesh.num_tris):
        v = verts[t]
        n = np.cross(v[1] - v[0], v[2] - v[0])
        nl = np.linalg.norm(n)
        if nl < 1e-12:
            continue
        n = n / nl
        tex = mesh.tex_names[t]
        slot = tex_slot_fn(tex) if tex is not None else -1
        tris.add_tri(v, mesh.uvs[t], n, slot, mesh.colors[t])


def bake_image_frame(
    tris: TriBatch, pos, direction, tex_name: str, width: float, slot: int,
    depth: float = 0.05, height: float | None = None,
):
    """Bake an ImageFrame: textured front face + black border box.

    Geometry mirrors ImageFrame.render (miniworld/entity.py:191-262);
    ``height`` defaults to preserving the image aspect ratio.
    """
    if height is None:
        tw, th = png_size(texture_variant_paths(tex_name)[0])
        height = (th / tw) * width
    sx, hz, hy = depth, width / 2, height / 2
    r = rot_y(float(direction))
    pos = np.asarray(pos, dtype=np.float64)

    def tq(v4, uv4, normal, tslot, color=(1, 1, 1)):
        v4 = np.einsum("ij,vj->vi", r, np.asarray(v4, dtype=np.float64)) + pos
        n = r @ np.asarray(normal, dtype=np.float64)
        tris.add_quad(v4, uv4, n, tslot, color)

    # Front face (facing +X in local frame), image UVs flipped in u.
    tq(
        [[sx, +hy, -hz], [sx, +hy, +hz], [sx, -hy, +hz], [sx, -hy, -hz]],
        [[1, 1], [0, 1], [0, 0], [1, 0]],
        [1, 0, 0],
        slot,
    )
    black = (0.0, 0.0, 0.0)
    zero_uv = [[0, 0]] * 4
    tq([[0, +hy, -hz], [+sx, +hy, -hz], [+sx, -hy, -hz], [0, -hy, -hz]],
       zero_uv, [0, 0, -1], -1, black)
    tq([[+sx, +hy, +hz], [0, +hy, +hz], [0, -hy, +hz], [+sx, -hy, +hz]],
       zero_uv, [0, 0, 1], -1, black)
    tq([[+sx, +hy, +hz], [+sx, +hy, -hz], [0, +hy, -hz], [0, +hy, +hz]],
       zero_uv, [0, 1, 0], -1, black)
    tq([[+sx, -hy, -hz], [+sx, -hy, +hz], [0, -hy, +hz], [0, -hy, -hz]],
       zero_uv, [0, -1, 0], -1, black)


def bake_text_frame(
    tris: TriBatch, pos, direction, text: str, tex_slot_fn,
    height: float = 0.15, depth: float = 0.05,
):
    """Bake a TextFrame: one textured quad per character + black box.

    Mirrors TextFrame.render (miniworld/entity.py:301-383); the front
    quads sit at local x=0.05 regardless of ``depth`` (reference quirk).
    Character texture names are ``chars/ch_0x{ord}`` with variants, so
    glyph randomization rides the texture-variant mechanism.
    """
    width = len(text) * height
    sx, hz, hy = 0.05, width / 2, height / 2
    r = rot_y(float(direction))
    pos = np.asarray(pos, dtype=np.float64)

    def tq(v4, uv4, normal, tslot, color=(1, 1, 1)):
        v4 = np.einsum("ij,vj->vi", r, np.asarray(v4, dtype=np.float64)) + pos
        n = r @ np.asarray(normal, dtype=np.float64)
        tris.add_quad(v4, uv4, n, tslot, color)

    for idx, ch in enumerate(text):
        if ch == " ":
            continue
        slot = tex_slot_fn(f"chars/ch_0x{ord(ch)}")
        cw = height
        z0 = hz - cw * (idx + 1)
        z1 = z0 + cw
        tq(
            [[sx, +hy, z0], [sx, +hy, z1], [sx, -hy, z1], [sx, -hy, z0]],
            [[1, 1], [0, 1], [0, 0], [1, 0]],
            [1, 0, 0],
            slot,
        )

    black = (0.0, 0.0, 0.0)
    zero_uv = [[0, 0]] * 4
    tq([[0, +hy, -hz], [+sx, +hy, -hz], [+sx, -hy, -hz], [0, -hy, -hz]],
       zero_uv, [0, 0, -1], -1, black)
    tq([[+sx, +hy, +hz], [0, +hy, +hz], [0, -hy, +hz], [+sx, -hy, +hz]],
       zero_uv, [0, 0, 1], -1, black)
    tq([[+sx, +hy, +hz], [+sx, +hy, -hz], [0, +hy, -hz], [0, +hy, +hz]],
       zero_uv, [0, 1, 0], -1, black)
    tq([[+sx, -hy, -hz], [+sx, -hy, +hz], [0, -hy, +hz], [0, -hy, -hz]],
       zero_uv, [0, -1, 0], -1, black)
