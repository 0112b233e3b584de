"""Host-side room model: convex outlines, portals, static geometry.

Semantics mirror the reference Room (miniworld/miniworld.py:123-435):
CCW convex outlines on the XZ plane, portals punched into walls, wall
quads split around portals, ground-level collision segments. The output
is *triangle soup + segment arrays* for the JAX raycaster instead of GL
polygons.

All math here is float64 numpy on host; the compiler downcasts to f32
when packing device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from miniworld_tpu.render.textures import TEX_DENSITY  # noqa: F401 (re-export)

# Default wall height (reference: miniworld/miniworld.py:77)
DEFAULT_WALL_HEIGHT = 2.74

Y_VEC = np.array([0.0, 1.0, 0.0])


@dataclass
class TriBatch:
    """Accumulates render primitives with per-vertex UVs, flat normals.

    Each primitive is 3 stored vertices (v0, v1, v2); ``kinds`` says how
    the raycaster interprets them (raycast._tri_pass):
      1.0 -> triangle (barycentric u + v <= det),
      0.0 -> parallelogram {v0 + a*(v1-v0) + b*(v2-v0), a,b in [0,1]}
             (u <= det and v <= det).
    Rect quads become ONE parallelogram prim instead of two triangles —
    same pixels, same plane, HALF the rows in the render scan's dominant
    hit-test fusion (profiled at ~45% of the Maze step). The reference
    draws these as GL_QUADS too (miniworld/miniworld.py:330-400).
    """

    verts: list = field(default_factory=list)  # (3,3) each
    uvs: list = field(default_factory=list)  # (3,2) each
    normals: list = field(default_factory=list)  # (3,) each
    tex_slots: list = field(default_factory=list)  # int, -1 = flat color
    colors: list = field(default_factory=list)  # (3,) each
    kinds: list = field(default_factory=list)  # 1.0 tri / 0.0 parallelogram

    def add_tri(self, v, uv, normal, tex_slot, color=(1.0, 1.0, 1.0)):
        self.verts.append(np.asarray(v, dtype=np.float64))
        self.uvs.append(np.asarray(uv, dtype=np.float64))
        self.normals.append(np.asarray(normal, dtype=np.float64))
        self.tex_slots.append(int(tex_slot))
        self.colors.append(np.asarray(color, dtype=np.float64))
        self.kinds.append(1.0)

    def add_quad(self, v4, uv4, normal, tex_slot, color=(1.0, 1.0, 1.0)):
        """Quad (CCW) -> one parallelogram prim when exact (the usual
        case: wall spans, frames, glyphs are rectangles), else two
        triangles preserving winding."""
        v4 = np.asarray(v4, dtype=np.float64)
        uv4 = np.asarray(uv4, dtype=np.float64)
        if _is_parallelogram(v4, uv4):
            self.verts.append(v4[[0, 1, 3]])
            self.uvs.append(uv4[[0, 1, 3]])
            self.normals.append(np.asarray(normal, dtype=np.float64))
            self.tex_slots.append(int(tex_slot))
            self.colors.append(np.asarray(color, dtype=np.float64))
            self.kinds.append(0.0)
            return
        self.add_tri(v4[[0, 1, 2]], uv4[[0, 1, 2]], normal, tex_slot, color)
        self.add_tri(v4[[0, 2, 3]], uv4[[0, 2, 3]], normal, tex_slot, color)

    def add_convex_fan(self, verts, uvs, normal, tex_slot, color=(1.0, 1.0, 1.0)):
        """Convex polygon (CCW) -> one parallelogram for exact quads
        (rect-room floors/ceilings), else a triangle fan."""
        verts = np.asarray(verts, dtype=np.float64)
        uvs = np.asarray(uvs, dtype=np.float64)
        if len(verts) == 4 and _is_parallelogram(verts, uvs):
            self.add_quad(verts, uvs, normal, tex_slot, color)
            return
        for i in range(1, len(verts) - 1):
            self.add_tri(
                verts[[0, i, i + 1]], uvs[[0, i, i + 1]], normal, tex_slot, color
            )

    def extend(self, other: "TriBatch"):
        self.verts.extend(other.verts)
        self.uvs.extend(other.uvs)
        self.normals.extend(other.normals)
        self.tex_slots.extend(other.tex_slots)
        self.colors.extend(other.colors)
        self.kinds.extend(other.kinds)

    def __len__(self):
        return len(self.verts)


def _is_parallelogram(v4: np.ndarray, uv4: np.ndarray) -> bool:
    """v2 == v1 + v3 - v0 (and affine-consistent UVs) within tolerance.

    The merged prim evaluates UVs through the affine plane map fit to
    (v0, v1, v3), so UVs must be affine across the whole quad too.
    """
    scale = max(1.0, float(np.abs(v4).max()))
    if np.abs(v4[2] - (v4[1] + v4[3] - v4[0])).max() > 1e-9 * scale:
        return False
    uscale = max(1.0, float(np.abs(uv4).max()))
    return np.abs(uv4[2] - (uv4[1] + uv4[3] - uv4[0])).max() <= 1e-9 * uscale


def wall_uvs(xc: float, yc: float, min_x: float, min_y: float, width: float, height: float):
    """UVs for a wall quad: meters * texels-per-meter / texture size.

    Mirrors gen_texcs_wall (miniworld/miniworld.py:83-104); ``xc``/``yc``
    are TEX_DENSITY / texture pixel size.
    """
    min_u, max_u = min_x * xc, (min_x + width) * xc
    min_v, max_v = min_y * yc, (min_y + height) * yc
    return np.array(
        [[min_u, min_v], [min_u, max_v], [max_u, max_v], [max_u, min_v]],
        dtype=np.float64,
    )


def floor_uvs(xc: float, yc: float, poss: np.ndarray):
    """Planar XZ UVs for floor/ceiling (gen_texcs_floor, miniworld.py:107-120)."""
    return np.stack([poss[:, 0] * xc, poss[:, 2] * yc], axis=1)


class Room:
    """A convex room on the XZ floorplan.

    Constructed from an (N,2) CCW outline; computes edge directions and
    inward normals the same way the reference does
    (miniworld/miniworld.py:128-195).
    """

    def __init__(
        self,
        outline: np.ndarray,
        wall_height: float = DEFAULT_WALL_HEIGHT,
        floor_tex: str = "floor_tiles_bw",
        wall_tex: str = "concrete",
        ceil_tex: str = "concrete_tiles",
        no_ceiling: bool = False,
    ):
        outline = np.asarray(outline, dtype=np.float64)
        assert outline.ndim == 2 and outline.shape[1] == 2 and outline.shape[0] >= 3
        # Insert y=0 to get (N,3) world-space outline points.
        self.outline = np.insert(outline, 1, 0.0, axis=1)
        self.num_walls = self.outline.shape[0]

        self.min_x = float(self.outline[:, 0].min())
        self.max_x = float(self.outline[:, 0].max())
        self.min_z = float(self.outline[:, 2].min())
        self.max_z = float(self.outline[:, 2].max())
        self.mid_x = (self.max_x + self.min_x) / 2
        self.mid_z = (self.max_z + self.min_z) / 2
        self.area = (self.max_x - self.min_x) * (self.max_z - self.min_z)

        next_pts = np.roll(self.outline, -1, axis=0)
        dirs = next_pts - self.outline
        self.edge_dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
        norms = -np.cross(self.edge_dirs, Y_VEC)
        self.edge_norms = norms / np.linalg.norm(norms, axis=1, keepdims=True)

        self.wall_height = float(wall_height)
        self.no_ceiling = bool(no_ceiling)
        self.wall_tex_name = wall_tex
        self.floor_tex_name = floor_tex
        self.ceil_tex_name = ceil_tex

        # Portals per wall edge, each {start_pos, end_pos, min_y, max_y}
        # with positions measured in meters along the edge.
        self.portals = [[] for _ in range(self.num_walls)]

    def add_portal(
        self,
        edge: int,
        start_pos=None,
        end_pos=None,
        min_x=None,
        max_x=None,
        min_z=None,
        max_z=None,
        min_y=0.0,
        max_y=None,
    ):
        """Punch an opening into a wall (miniworld/miniworld.py:197-271).

        Extents may be given as positions along the edge or as world
        x/z coordinates projected onto the edge.
        """
        if max_y is None:
            max_y = self.wall_height
        assert edge <= self.num_walls
        assert max_y > min_y

        e_p0 = self.outline[edge]
        e_p1 = self.outline[(edge + 1) % self.num_walls]
        e_len = float(np.linalg.norm(e_p1 - e_p0))
        e_dir = (e_p1 - e_p0) / e_len
        x0, _, z0 = e_p0
        dx, _, dz = e_dir

        if min_x is not None:
            assert min_z is None and max_z is None
            assert start_pos is None and end_pos is None
            m0, m1 = (min_x - x0) / dx, (max_x - x0) / dx
            if m1 < m0:
                m0, m1 = m1, m0
            start_pos, end_pos = m0, m1
        elif min_z is not None:
            assert start_pos is None and end_pos is None
            m0, m1 = (min_z - z0) / dz, (max_z - z0) / dz
            if m1 < m0:
                m0, m1 = m1, m0
            start_pos, end_pos = m0, m1

        assert end_pos > start_pos
        assert start_pos >= 0, "portal outside of wall extents"
        assert end_pos <= e_len + 1e-9, "portal outside of wall extents"

        self.portals[edge].append(
            dict(start_pos=float(start_pos), end_pos=float(end_pos),
                 min_y=float(min_y), max_y=float(max_y))
        )
        self.portals[edge].sort(key=lambda p: p["start_pos"])
        return start_pos, end_pos

    def point_inside(self, p) -> bool:
        """Strict convex-interior test (miniworld/miniworld.py:273-285)."""
        p = np.asarray(p, dtype=np.float64)
        ap = p - self.outline
        dot_n_ap = np.sum(self.edge_norms * ap, axis=1)
        return bool(np.all(dot_n_ap > 0))

    def gen_static(self, tex_slot_fn, uv_mul_fn):
        """Build this room's triangles and collision segments.

        Args:
          tex_slot_fn: name -> texture slot id (TextureCatalog hook).
          uv_mul_fn: name -> (xc, yc) UV multipliers.

        Returns:
          (TriBatch, wall_segs (N,2,2) float64 XZ endpoint pairs)

        Wall construction follows Room._gen_static_data
        (miniworld/miniworld.py:287-400): each edge is split into spans
        around its portals; spans starting at ground level contribute a
        collision segment ordered [s_p1, s_p0].
        """
        tris = TriBatch()
        segs = []

        wall_slot = tex_slot_fn(self.wall_tex_name)
        floor_slot = tex_slot_fn(self.floor_tex_name)
        wall_xc, wall_yc = uv_mul_fn(self.wall_tex_name)
        floor_xc, floor_yc = uv_mul_fn(self.floor_tex_name)

        # Floor: the outline itself (CCW seen from above), normal +Y.
        floor_verts = self.outline
        tris.add_convex_fan(
            floor_verts,
            floor_uvs(floor_xc, floor_yc, floor_verts),
            np.array([0.0, 1.0, 0.0]),
            floor_slot,
        )

        # Ceiling: flipped outline raised to wall_height, normal -Y
        # (flip keeps front faces visible from below; miniworld.py:304-307).
        if not self.no_ceiling:
            ceil_slot = tex_slot_fn(self.ceil_tex_name)
            ceil_xc, ceil_yc = uv_mul_fn(self.ceil_tex_name)
            ceil_verts = np.flip(self.outline, axis=0) + self.wall_height * Y_VEC
            tris.add_convex_fan(
                ceil_verts,
                floor_uvs(ceil_xc, ceil_yc, ceil_verts),
                np.array([0.0, -1.0, 0.0]),
                ceil_slot,
            )

        def emit_span(edge_p0, side_vec, seg_start, seg_end, min_y, max_y):
            if seg_end == seg_start or min_y == max_y:
                return
            s_p0 = edge_p0 + seg_start * side_vec
            s_p1 = edge_p0 + seg_end * side_vec
            if min_y == 0:
                segs.append(np.array([s_p1[[0, 2]], s_p0[[0, 2]]]))
            normal = np.cross(s_p1 - s_p0, Y_VEC)
            normal = -normal / np.linalg.norm(normal)
            quad = np.array(
                [
                    s_p0 + min_y * Y_VEC,
                    s_p0 + max_y * Y_VEC,
                    s_p1 + max_y * Y_VEC,
                    s_p1 + min_y * Y_VEC,
                ]
            )
            uv4 = wall_uvs(
                wall_xc, wall_yc, seg_start, min_y, seg_end - seg_start, max_y - min_y
            )
            tris.add_quad(quad, uv4, normal, wall_slot)

        for wall_idx in range(self.num_walls):
            edge_p0 = self.outline[wall_idx]
            edge_p1 = self.outline[(wall_idx + 1) % self.num_walls]
            wall_width = float(np.linalg.norm(edge_p1 - edge_p0))
            side_vec = (edge_p1 - edge_p0) / wall_width
            portals = self.portals[wall_idx]

            first_end = portals[0]["start_pos"] if portals else wall_width
            emit_span(edge_p0, side_vec, 0.0, first_end, 0.0, self.wall_height)

            for pi, portal in enumerate(portals):
                emit_span(
                    edge_p0, side_vec,
                    portal["start_pos"], portal["end_pos"],
                    0.0, portal["min_y"],
                )
                emit_span(
                    edge_p0, side_vec,
                    portal["start_pos"], portal["end_pos"],
                    portal["max_y"], self.wall_height,
                )
                next_start = (
                    portals[pi + 1]["start_pos"] if pi + 1 < len(portals) else wall_width
                )
                emit_span(
                    edge_p0, side_vec,
                    portal["end_pos"], next_start,
                    0.0, self.wall_height,
                )

        wall_segs = (
            np.stack(segs) if segs else np.zeros((0, 2, 2), dtype=np.float64)
        )
        return tris, wall_segs
