"""Layout compilation: World -> fixed-shape numpy arrays.

A ``Layout`` is everything the device needs about one world geometry:
static render triangles, collision segments, room tables (for on-device
placement), entity prototypes/slots/placement rules, and texture slot
tables. Layouts pad to common shapes and stack into *banks* so
procedurally generated env classes (Maze) can gather a per-env layout
by index on device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import jax
import numpy as np

from miniworld_tpu.scene.world import MAX_ALTS, World


def _pad(arr: np.ndarray, n: int, axis: int = 0, fill=0):
    pad_n = n - arr.shape[axis]
    assert pad_n >= 0, (arr.shape, n)
    if pad_n == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad_n)
    return np.pad(arr, widths, constant_values=fill)


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


# Far-away padding value for room-local segment packs: a padded column
# decodes to the unit segment (1e9, 1e9)-(1e9+1, 1e9), which no
# in-world circle can touch (and is non-degenerate, so the projection
# math stays finite).
SEG_PAD = 1e9


def _seg_intersects_rect(a, b, lo_x, hi_x, lo_z, hi_z) -> bool:
    """Liang-Barsky: does segment a-b intersect the axis rect?"""
    d = (b[0] - a[0], b[1] - a[1])
    t0, t1 = 0.0, 1.0
    for p, q in (
        (-d[0], a[0] - lo_x), (d[0], hi_x - a[0]),
        (-d[1], a[1] - lo_z), (d[1], hi_z - a[1]),
    ):
        if abs(p) < 1e-12:
            if q < 0:
                return False
            continue
        t = q / p
        if p < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return False
    return True


def _room_local_segs(world, segs: np.ndarray, seg_codes: np.ndarray | None = None):
    """(R, 4, NS) component-major per-room collision segment packs.

    A room's pack holds every wall segment within collision REACH of
    its AABB — conservative for every physics/placement query made
    while the agent (or a placement candidate) is in that room: moves
    (radius + step), the carried-object check at its forward offset
    (miniworld.py:677-689), the pickup probe, and rejection-sampled
    positions up to ``radius`` outside the room bbox.

    ``seg_codes`` ((n_segs,) i32, procgen super-banks): also returns a
    parallel (R, NS) pack of per-seg wall codes (pad columns = -1 =
    always solid).
    """
    max_r = float(world.agent_radius)
    for s in world.slots:
        for pid in s.proto_ids:
            max_r = max(max_r, world.protos[pid].radius * float(s.size_hi))
    maxf = float(world.max_forward_step)
    r_a = float(world.agent_radius)
    reach = max(
        r_a + maxf + 0.1,  # move target
        1.05 * (r_a + max_r + maxf) + max_r,  # carried-object query
        2.7 * r_a,  # pickup probe (1.5 r + 1.2 r)
        2.0 * max_r,  # placement candidate (bbox + radius, query radius)
    ) + 0.5

    rooms = world.rooms
    sel_per_room = []
    for room in rooms:
        lo_x, hi_x = room.min_x - reach, room.max_x + reach
        lo_z, hi_z = room.min_z - reach, room.max_z + reach
        sel = [
            i for i in range(segs.shape[0])
            if _seg_intersects_rect(segs[i, 0], segs[i, 1],
                                    lo_x, hi_x, lo_z, hi_z)
        ]
        sel_per_room.append(sel)
    ns = _round_up(max([len(s) for s in sel_per_room] + [1]), 8)
    out = np.full((len(rooms), 4, ns), SEG_PAD, dtype=np.float32)
    out[:, 2, :] = SEG_PAD + 1.0  # b_x: keep pad segments non-degenerate
    codes = np.full((len(rooms), ns), -1, dtype=np.int32)
    for r, sel in enumerate(sel_per_room):
        if sel:
            picked = segs[sel]  # (k, 2, 2)
            out[r, 0, :len(sel)] = picked[:, 0, 0]
            out[r, 1, :len(sel)] = picked[:, 0, 1]
            out[r, 2, :len(sel)] = picked[:, 1, 0]
            out[r, 3, :len(sel)] = picked[:, 1, 1]
            if seg_codes is not None:
                codes[r, :len(sel)] = seg_codes[sel]
    if seg_codes is not None:
        return out, codes
    return out


@dataclass
class Layout:
    """One compiled world layout (all numpy; see module docstring)."""

    # static geometry
    tri_verts: np.ndarray  # (S,3,3) f32
    # component-major copy for the render chunk scan: rows are
    # [v0x v0y v0z v1x v1y v1z v2x v2y v2z] with triangles in the
    # minor axis — per-chunk slices are contiguous rows instead of
    # (.., 3, 3) blocks with a tiny inner dimension
    tri_verts9: np.ndarray  # (9,S) f32
    tri_attr: np.ndarray  # (S,16) f32 packed render attrs (raycast.ATTR_DIM)
    tri_uv: np.ndarray  # (S,3,2) f32
    tri_normal: np.ndarray  # (S,3) f32
    tri_tex: np.ndarray  # (S,) i32 texture slot, -1 = flat color
    tri_tex_base: np.ndarray  # (S,) f32 atlas base index of the tri's slot, -1 = flat
    tri_tex_count: np.ndarray  # (S,) f32 number of texture variants of the tri's slot
    tri_color: np.ndarray  # (S,3) f32
    tri_mask: np.ndarray  # (S,) bool
    tri_room: np.ndarray  # (S,) i32 owning room; -1 = always visible, -2 = pad
    # room-geometry flag (walls/floors/ceilings vs baked static
    # entities): the get_visible_ents occlusion pass depth-tests
    # against ROOMS ONLY (miniworld/miniworld.py:1627-1629)
    tri_is_room: np.ndarray  # (S,) bool
    room_pvs: np.ndarray  # (R,R) bool potentially-visible rooms (scene/pvs.py)
    # collision
    segs: np.ndarray  # (W,2,2) f32 XZ endpoints
    seg_mask: np.ndarray  # (W,) bool
    # room-local collision sets: component-major [a_x,a_z,b_x,b_z] packs
    # of every segment within collision reach of each room's AABB, so
    # the physics/placement hot loops slice (4, NS) per env instead of
    # gathering all W segments (pad columns = SEG_PAD far segments)
    room_segs: np.ndarray  # (R,4,NS) f32
    # rooms (placement / point_inside)
    room_outline: np.ndarray  # (R,V,2) f32
    room_norms: np.ndarray  # (R,V,2) f32
    room_vmask: np.ndarray  # (R,V) bool
    room_mask: np.ndarray  # (R,) bool
    room_aabb: np.ndarray  # (R,4) f32 [min_x,max_x,min_z,max_z]
    room_area: np.ndarray  # (R,) f32
    # prototypes
    proto_shape: np.ndarray  # (P,) i32
    proto_mesh: np.ndarray  # (P,M,25) f32 local mesh rows for SHAPE_MESH_TRIS
    proto_mesh_mask: np.ndarray  # (P,M) bool
    proto_size: np.ndarray  # (P,3) f32
    proto_radius: np.ndarray  # (P,) f32
    proto_height: np.ndarray  # (P,) f32
    proto_color: np.ndarray  # (P,3) f32
    proto_colorable: np.ndarray  # (P,) bool
    proto_static: np.ndarray  # (P,) bool
    proto_pickable: np.ndarray  # (P,) bool
    # entity slots
    slot_protos: np.ndarray  # (E,C) i32, -1 pad
    slot_size_lo: np.ndarray  # (E,) f32
    slot_size_hi: np.ndarray  # (E,) f32
    slot_mask: np.ndarray  # (E,) bool
    # placement rules, (E+1, A, ...) — row E is the agent's rule
    rule_room: np.ndarray  # (E+1,A) i32, -1 = any
    rule_bbox: np.ndarray  # (E+1,A,4) f32, nan = room bbox
    rule_pos: np.ndarray  # (E+1,A,3) f32, nan = sample
    rule_dir: np.ndarray  # (E+1,A) f32, nan = sample in range
    rule_dir_lo: np.ndarray  # (E+1,A) f32
    rule_dir_hi: np.ndarray  # (E+1,A) f32
    rule_mask: np.ndarray  # (E+1,A) bool
    # textures
    tex_slot_base: np.ndarray  # (T,) i32
    tex_slot_count: np.ndarray  # (T,) i32
    # misc
    extents: np.ndarray  # (4,) f32 floorplan min_x,max_x,min_z,max_z
    # Packed per-room PVS copies (vector.plan_packed_pvs; None unless
    # that planner wins): each room's potentially-visible triangles
    # stored contiguously (duplicated across rooms) so the render scan
    # visits exactly ceil(|PVS(room)|/chunk) chunks. Built AFTER
    # stacking — per-layout pad_to never sees these.
    pvs_verts9: np.ndarray | None = None  # (L,9,S2) f32
    pvs_attr: np.ndarray | None = None  # (L,S2,ATTR_DIM) f32
    pvs_tri_tex: np.ndarray | None = None  # (L,S2) i32
    pvs_tri_tex_base: np.ndarray | None = None  # (L,S2) f32
    pvs_tri_tex_count: np.ndarray | None = None  # (L,S2) f32
    pvs_room_base: np.ndarray | None = None  # (L,R) i32 chunk base per room
    pvs_room_nchunks: np.ndarray | None = None  # (L,R) i32 chunks per room's set
    # Chunk-row views of the packed banks (vector._install_bank):
    # row layout*NC + c holds chunk c of that layout, flattened — the
    # render scan reads its per-env chunk with ONE one-hot matrix
    # product instead of a vmapped dynamic_slice (which lowered as a
    # while-loop gather over layouts on the chip this was tuned for;
    # not yet measured on the GPU, ROADMAP A4).
    pvs_v9_rows: np.ndarray | None = None  # (L*NC, 9*k) f32
    pvs_attr_rows: np.ndarray | None = None  # (L*NC, k*ATTR_DIM) f32
    # Procgen super-bank fields (scene/supermaze.py; None unless the env
    # runs device-side per-reset maze generation). The bank then holds
    # ONE layout with every wall variant; per-env episode geometry is
    # the wall-open bitmask in EnvState.wall_open:
    #   tri_wall: -1 = unconditional; w = rendered iff wall w CLOSED
    #     (the closed-wall quads).
    #   tri_jwall: -1 = unconditional; w = rendered iff wall w OPEN
    #     (junction/gap content — floor, ceiling, side walls: a closed
    #     wall's junction is sealed and must vanish like the
    #     reference's never-built junction, visibly so in top views).
    #   tri_active_base + tri_wall_onehot: the two folded into one
    #     signed matvec. base[s] = 0 for junction tris else 1;
    #     K[w, s] = +1 if tri_jwall[s] == w, -1 if tri_wall[s] == w,
    #     so per-env triangle activity is
    #     active = base + wall_open @ K (exact 0/1 in f32).
    #   room_seg_wall: per room-local collision seg (compile.room_segs
    #     packs), -1 = always solid; w = solid iff wall w CLOSED.
    #   room_wall: -1 = room always exists (cells); w = the junction
    #     room of wall w, existing (placeable) iff wall w OPEN.
    tri_wall: np.ndarray | None = None  # (L,S) i32
    tri_jwall: np.ndarray | None = None  # (L,S) i32
    tri_active_base: np.ndarray | None = None  # (L,S) f32
    tri_wall_onehot: np.ndarray | None = None  # (L,W,S) f32 signed
    room_seg_wall: np.ndarray | None = None  # (L,R,NS) i32
    room_wall: np.ndarray | None = None  # (L,R) i32
    # Paired procgen render bank (scene/supermaze.build_paired_bank):
    # exactly ONE of {a wall's junction content (4 prims), its
    # closed-wall quads (2 prims + 2 degenerate)} exists per episode,
    # so the render scan stores them as PRIMARY/ALT variants of the
    # same Sp = cells + 4*walls rows and selects per env in-chunk
    # (use_primary = pg_sel_base + wall_open @ pg_sel_onehot, exact
    # 0/1) — 27% fewer rows in the hit-test fusion than the dense
    # activity-masked bank, and no inactive rows at all. The dense
    # tri_* arrays + activity machinery REMAIN for the non-hot
    # consumers (top view, get_visible_ents).
    pg_verts9: np.ndarray | None = None  # (L,9,Sp) f32 primary
    pg_attr: np.ndarray | None = None  # (L,Sp,16) f32
    pg_verts9_alt: np.ndarray | None = None  # (L,9,Sp) f32
    pg_attr_alt: np.ndarray | None = None  # (L,Sp,16) f32
    pg_sel_base: np.ndarray | None = None  # (L,Sp) f32
    pg_sel_onehot: np.ndarray | None = None  # (L,W,Sp) f32
    pg_tex: np.ndarray | None = None  # (L,2,3,Sp) f32 [variant][ids|base|cnt]

    def pad_to(self, sizes: dict) -> "Layout":
        """Pad all leading dims to the given sizes (keys: S,W,R,V,P,E,C,T)."""
        s = sizes
        nan4 = float("nan")
        return Layout(
            tri_verts=_pad(self.tri_verts, s["S"]),
            tri_verts9=_pad(self.tri_verts9, s["S"], axis=1),
            tri_attr=_pad(self.tri_attr, s["S"]),
            tri_uv=_pad(self.tri_uv, s["S"]),
            tri_normal=_pad(self.tri_normal, s["S"]),
            tri_tex=_pad(self.tri_tex, s["S"], fill=-1),
            tri_tex_base=_pad(self.tri_tex_base, s["S"], fill=-1.0),
            tri_tex_count=_pad(self.tri_tex_count, s["S"], fill=1.0),
            tri_color=_pad(self.tri_color, s["S"]),
            tri_mask=_pad(self.tri_mask, s["S"], fill=False),
            tri_room=_pad(self.tri_room, s["S"], fill=-2),
            tri_is_room=_pad(self.tri_is_room, s["S"], fill=False),
            room_pvs=_pad(_pad(self.room_pvs, s["R"], axis=1, fill=False), s["R"], fill=False),
            segs=_pad(self.segs, s["W"]),
            seg_mask=_pad(self.seg_mask, s["W"], fill=False),
            room_segs=_pad(
                _pad(self.room_segs, s["NS"], axis=2, fill=SEG_PAD),
                s["R"], fill=SEG_PAD,
            ),
            room_outline=_pad(_pad(self.room_outline, s["V"], axis=1), s["R"]),
            room_norms=_pad(_pad(self.room_norms, s["V"], axis=1), s["R"]),
            room_vmask=_pad(_pad(self.room_vmask, s["V"], axis=1, fill=False), s["R"], fill=False),
            room_mask=_pad(self.room_mask, s["R"], fill=False),
            room_aabb=_pad(self.room_aabb, s["R"]),
            room_area=_pad(self.room_area, s["R"]),
            proto_shape=_pad(self.proto_shape, s["P"]),
            proto_mesh=_pad(_pad(self.proto_mesh, s["M"], axis=1), s["P"]),
            proto_mesh_mask=_pad(
                _pad(self.proto_mesh_mask, s["M"], axis=1, fill=False),
                s["P"], fill=False,
            ),
            proto_size=_pad(self.proto_size, s["P"]),
            proto_radius=_pad(self.proto_radius, s["P"]),
            proto_height=_pad(self.proto_height, s["P"]),
            proto_color=_pad(self.proto_color, s["P"]),
            proto_colorable=_pad(self.proto_colorable, s["P"], fill=False),
            proto_static=_pad(self.proto_static, s["P"], fill=True),
            proto_pickable=_pad(self.proto_pickable, s["P"], fill=False),
            slot_protos=_pad(_pad(self.slot_protos, s["C"], axis=1, fill=-1), s["E"], fill=-1),
            slot_size_lo=_pad(self.slot_size_lo, s["E"], fill=1.0),
            slot_size_hi=_pad(self.slot_size_hi, s["E"], fill=1.0),
            slot_mask=_pad(self.slot_mask, s["E"], fill=False),
            rule_room=_pad(self.rule_room, s["E"] + 1, fill=-1),
            rule_bbox=_pad(self.rule_bbox, s["E"] + 1, fill=nan4),
            rule_pos=_pad(self.rule_pos, s["E"] + 1, fill=nan4),
            rule_dir=_pad(self.rule_dir, s["E"] + 1, fill=nan4),
            rule_dir_lo=_pad(self.rule_dir_lo, s["E"] + 1, fill=-math.pi),
            rule_dir_hi=_pad(self.rule_dir_hi, s["E"] + 1, fill=math.pi),
            rule_mask=_pad(self.rule_mask, s["E"] + 1, fill=False),
            tex_slot_base=_pad(self.tex_slot_base, s["T"]),
            tex_slot_count=_pad(self.tex_slot_count, s["T"], fill=1),
            extents=self.extents,
        )

    @property
    def sizes(self) -> dict:
        return dict(
            S=self.tri_verts.shape[0],
            W=self.segs.shape[0],
            NS=self.room_segs.shape[2],
            R=self.room_outline.shape[0],
            V=self.room_outline.shape[1],
            P=self.proto_shape.shape[0],
            M=self.proto_mesh.shape[1],
            E=self.slot_protos.shape[0],
            C=self.slot_protos.shape[1],
            T=self.tex_slot_base.shape[0],
        )


# Layout is a pytree so banks can be passed as jit ARGUMENTS (closure
# capture would embed them as XLA constants — brutal compile times).
jax.tree_util.register_pytree_node(
    Layout,
    lambda lay: (tuple(getattr(lay, f.name) for f in fields(Layout)), None),
    lambda _, children: Layout(*children),
)


def natural_sizes(layouts, align: int = 8) -> dict:
    """Max sizes across layouts, rounded up for stable shapes."""
    keys = ["S", "W", "NS", "R", "V", "P", "M", "E", "C", "T"]
    out = {}
    for k in keys:
        m = max(lay.sizes[k] for lay in layouts)
        out[k] = _round_up(m, align if k in ("S", "W") else 1)
    return out


def stack_layouts(layouts, align: int = 8, min_sizes: dict | None = None):
    """Pad to common sizes and stack into a bank (leading L axis).

    ``min_sizes`` raises the per-axis floors — bank refreshes
    (MiniWorldVec.refresh_layouts) pass the previous bank's sizes so a
    regenerated bank keeps identical array shapes (and the compiled
    programs stay cached)."""
    sizes = natural_sizes(layouts, align)
    if min_sizes:
        for k, v in min_sizes.items():
            sizes[k] = max(sizes[k], v)
    padded = [lay.pad_to(sizes) for lay in layouts]
    out = {}
    for f in fields(Layout):
        vals = [getattr(p, f.name) for p in padded]
        out[f.name] = None if vals[0] is None else np.stack(vals)
    return Layout(**out)


def _static_tri_rooms(rooms, verts: np.ndarray) -> np.ndarray:
    """Assign baked static-entity triangles to rooms for PVS culling.

    A triangle belongs to a room when all three vertices are (within
    tolerance) inside it; anything else — decorative meshes outside the
    floorplan (wallgap.py's building), straddlers — gets -1 = rendered
    from everywhere. Tolerance admits wall-mounted frames whose quads
    lie exactly on a room boundary.
    """
    n = verts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    xz = verts[:, :, [0, 2]]  # (n, 3, 2)
    best_room = np.full(n, -1, dtype=np.int32)
    best_score = np.full(n, -0.05)
    for ri, room in enumerate(rooms):
        pts = room.outline[:, [0, 2]]  # (V, 2)
        nrm = room.edge_norms[:, [0, 2]]  # (V, 2) inward
        # insideness of each vertex: min over edges of n . (p - p0)
        d = np.einsum("vk,ntvk->ntv", nrm, xz[:, :, None, :] - pts[None, None])
        score = d.min(axis=(1, 2))  # (n,) min over verts and edges
        take = score > best_score
        best_room[take] = ri
        best_score[take] = score[take]
    return best_room


def _room_block_order(rooms) -> list:
    """DFS order over the portal graph, for chunk-schedule locality.

    Rooms that see each other lie along portal chains; laying their
    triangle blocks out in portal-DFS order keeps a camera's visible
    set in few, mostly-contiguous chunks (room indices themselves are
    NOT renumbered — only triangle storage order changes, which is
    invisible under z-buffering).
    """
    from miniworld_tpu.scene.pvs import portal_connections

    adj = [[] for _ in rooms]
    for ri, rj, _, _ in portal_connections(rooms):
        adj[ri].append(rj)
        adj[rj].append(ri)
    seen, order = set(), []

    def dfs(r):
        seen.add(r)
        order.append(r)
        for n in adj[r]:
            if n not in seen:
                dfs(n)

    for r in range(len(rooms)):
        if r not in seen:
            dfs(r)
    return order


def pack_tri_attrs(tri_verts, tri_uv, tri_normal, tri_color, tri_tex,
                   tri_kind=None) -> np.ndarray:
    """Packed render attribute rows: [A(6) | b(2) | normal(3) |
    color(3) | slot | kind]. (A, b) is the prim's affine texture map
    uv = A @ p + b for points p on its plane, so the renderer derives
    UVs from the hit point instead of selecting per-pixel barycentrics
    (two (pixels x chunk) reductions per chunk). The trailing column is the primitive kind
    (TriBatch.kinds: 1.0 triangle, 0.0 parallelogram; padding rows 0
    never hit because their verts are degenerate)."""
    S = tri_verts.shape[0]
    v0 = tri_verts[:, 0].astype(np.float64)
    e1 = tri_verts[:, 1].astype(np.float64) - v0
    e2 = tri_verts[:, 2].astype(np.float64) - v0
    uv0 = tri_uv[:, 0, :].astype(np.float64)
    duv1 = tri_uv[:, 1, :].astype(np.float64) - uv0
    duv2 = tri_uv[:, 2, :].astype(np.float64) - uv0
    l11 = np.sum(e1 * e1, axis=1)
    l22 = np.sum(e2 * e2, axis=1)
    l12 = np.sum(e1 * e2, axis=1)
    den = np.maximum(l11 * l22 - l12 * l12, 1e-18)
    gu = (l22[:, None] * e1 - l12[:, None] * e2) / den[:, None]
    gv = (l11[:, None] * e2 - l12[:, None] * e1) / den[:, None]
    a_map = duv1[:, :, None] * gu[:, None, :] + duv2[:, :, None] * gv[:, None, :]
    b_map = uv0 - np.einsum("tij,tj->ti", a_map, v0)
    tri_attr = np.zeros((S, 16), dtype=np.float32)
    tri_attr[:, 0:6] = a_map.reshape(S, 6)
    tri_attr[:, 6:8] = b_map
    tri_attr[:, 8:11] = tri_normal
    tri_attr[:, 11:14] = tri_color
    tri_attr[:, 14] = tri_tex.astype(np.float32)
    tri_attr[:, 15] = (
        1.0 if tri_kind is None else np.asarray(tri_kind, np.float32)
    )
    return tri_attr


def tex_base_count(tri_tex, tex_slots):
    """Per-tri atlas base / variant count (static): lets the renderer
    resolve per-episode texture-variant randomization with pure per-tri
    arithmetic (state.tri_slots) instead of a slot-table lookup —
    per-(room, role) slots made that table 3x#rooms wide and a
    per-pixel slot one-hot over it was a 22 GB intermediate."""
    slot_base = np.array([b for b, _ in tex_slots] or [0], np.int64)
    slot_count = np.array([c for _, c in tex_slots] or [1], np.int64)
    safe_tex = np.clip(tri_tex, 0, len(tex_slots) - 1 if tex_slots else 0)
    tri_tex_base = np.where(tri_tex >= 0, slot_base[safe_tex], -1).astype(np.float32)
    tri_tex_count = np.where(tri_tex >= 0, slot_count[safe_tex], 1).astype(np.float32)
    return tri_tex_base, tri_tex_count


def compile_world(world: World, with_pvs: bool = False) -> Layout:
    """Compile a built World into a Layout (natural, unpadded sizes).

    ``with_pvs=True`` additionally runs the portal-visibility analysis
    (scene/pvs.py) used by the renderer's chunk culling; the eager
    (gymnasium adapter) path skips it — a fresh world is compiled every
    reset there and single-env CPU rendering doesn't cull.
    """
    world.gen_static_data(rand=None if not world.eager else world._eager_static_rand)

    # Room triangles + baked static entity triangles. The reference
    # renders rooms first, then static entities (miniworld.py:1135-1143)
    # — order is irrelevant under z-buffering, so triangles are stored
    # grouped by room in portal-DFS order for the renderer's PVS chunk
    # culling (always-visible triangles lead).
    tri = world._room_tris
    all_verts = tri.verts + world.static_tris.verts
    all_uvs = tri.uvs + world.static_tris.uvs
    all_normals = tri.normals + world.static_tris.normals
    all_tex = tri.tex_slots + world.static_tris.tex_slots
    all_colors = tri.colors + world.static_tris.colors
    all_kinds = tri.kinds + world.static_tris.kinds

    S = len(all_verts)
    tri_verts = np.asarray(all_verts, dtype=np.float32).reshape(S, 3, 3)
    tri_uv = np.asarray(all_uvs, dtype=np.float32).reshape(S, 3, 2)
    tri_normal = np.asarray(all_normals, dtype=np.float32).reshape(S, 3)
    tri_tex = np.asarray(all_tex, dtype=np.int32)
    tri_color = np.asarray(all_colors, dtype=np.float32).reshape(S, 3)
    tri_kind = np.asarray(all_kinds, dtype=np.float32)
    tri_mask = np.ones(S, dtype=bool)

    # Per-triangle owning room, then the block permutation.
    room_counts = world._room_tri_counts
    tri_room = np.concatenate(
        [
            np.repeat(np.arange(len(room_counts), dtype=np.int32), room_counts),
            _static_tri_rooms(
                world.rooms,
                np.asarray(
                    world.static_tris.verts, dtype=np.float64
                ).reshape(-1, 3, 3),
            ),
        ]
    )
    assert tri_room.shape[0] == S
    tri_is_room = np.arange(S) < int(np.sum(room_counts))
    order = _room_block_order(world.rooms)
    rank = np.empty(len(world.rooms) + 1, dtype=np.int64)
    rank[0] = 0  # always-visible block first (index shifted by +1)
    for k, ri in enumerate(order):
        rank[ri + 1] = k + 1
    perm = np.argsort(rank[tri_room + 1], kind="stable")
    tri_verts, tri_uv, tri_normal = tri_verts[perm], tri_uv[perm], tri_normal[perm]
    tri_tex, tri_color, tri_room = tri_tex[perm], tri_color[perm], tri_room[perm]
    tri_is_room, tri_kind = tri_is_room[perm], tri_kind[perm]

    if with_pvs:
        from miniworld_tpu.scene.pvs import compute_room_pvs

        room_pvs = compute_room_pvs(world.rooms)
    else:
        room_pvs = np.ones((len(world.rooms), len(world.rooms)), dtype=bool)

    tri_attr = pack_tri_attrs(tri_verts, tri_uv, tri_normal, tri_color,
                              tri_tex, tri_kind)
    tri_tex_base, tri_tex_count = tex_base_count(tri_tex, world.tex_slots)

    segs = world._wall_segs.astype(np.float32)
    seg_mask = np.ones(segs.shape[0], dtype=bool)
    room_segs = _room_local_segs(world, world._wall_segs)

    R = len(world.rooms)
    V = max(r.num_walls for r in world.rooms)
    room_outline = np.zeros((R, V, 2), dtype=np.float32)
    room_norms = np.zeros((R, V, 2), dtype=np.float32)
    room_vmask = np.zeros((R, V), dtype=bool)
    room_aabb = np.zeros((R, 4), dtype=np.float32)
    room_area = np.zeros(R, dtype=np.float32)
    for i, r in enumerate(world.rooms):
        n = r.num_walls
        room_outline[i, :n] = r.outline[:, [0, 2]]
        room_norms[i, :n] = r.edge_norms[:, [0, 2]]
        room_vmask[i, :n] = True
        room_aabb[i] = [r.min_x, r.max_x, r.min_z, r.max_z]
        room_area[i] = r.area
    room_mask = np.ones(R, dtype=bool)

    from miniworld_tpu.scene import entities as ent_lib
    from miniworld_tpu.scene.entities import MESH_ROW_DIM

    # Boxes join the mesh-entity pass (12 exact rows) when the world
    # already pays for it, and keep the analytic OBB branch in box-only
    # scenes (each faster on the chip this was tuned for; not yet
    # measured on the GPU); see box_proto.
    if any(p.shape == ent_lib.SHAPE_MESH_TRIS for p in world.protos):
        for p in world.protos:
            if p.shape == ent_lib.SHAPE_BOX:
                p.shape = ent_lib.SHAPE_MESH_TRIS
                p.mesh_rows = ent_lib._box_rows(p.size)

    P = max(len(world.protos), 1)
    M = max([p.mesh_rows.shape[0] for p in world.protos
             if p.mesh_rows is not None] + [1])
    M = _round_up(M, 8)
    proto_shape = np.zeros(P, dtype=np.int32)
    proto_mesh = np.zeros((P, M, MESH_ROW_DIM), dtype=np.float32)
    proto_mesh_mask = np.zeros((P, M), dtype=bool)
    proto_size = np.zeros((P, 3), dtype=np.float32)
    proto_radius = np.zeros(P, dtype=np.float32)
    proto_height = np.zeros(P, dtype=np.float32)
    proto_color = np.zeros((P, 3), dtype=np.float32)
    proto_colorable = np.zeros(P, dtype=bool)
    proto_static = np.ones(P, dtype=bool)
    proto_pickable = np.zeros(P, dtype=bool)
    for i, p in enumerate(world.protos):
        proto_shape[i] = p.shape
        if p.mesh_rows is not None:
            k = p.mesh_rows.shape[0]
            proto_mesh[i, :k] = p.mesh_rows
            proto_mesh_mask[i, :k] = True
        proto_size[i] = p.size
        proto_radius[i] = p.radius
        proto_height[i] = p.height
        proto_color[i] = p.color
        proto_colorable[i] = p.colorable
        proto_static[i] = p.static
        proto_pickable[i] = p.pickable

    E = len(world.slots)
    C = max([len(s.proto_ids) for s in world.slots] + [1])
    slot_protos = np.full((E, C), -1, dtype=np.int32)
    slot_size_lo = np.ones(E, dtype=np.float32)
    slot_size_hi = np.ones(E, dtype=np.float32)
    slot_mask = np.ones(E, dtype=bool)

    A = MAX_ALTS
    rule_room = np.full((E + 1, A), -1, dtype=np.int32)
    rule_bbox = np.full((E + 1, A, 4), np.nan, dtype=np.float32)
    rule_pos = np.full((E + 1, A, 3), np.nan, dtype=np.float32)
    rule_dir = np.full((E + 1, A), np.nan, dtype=np.float32)
    rule_dir_lo = np.full((E + 1, A), -math.pi, dtype=np.float32)
    rule_dir_hi = np.full((E + 1, A), math.pi, dtype=np.float32)
    rule_mask = np.zeros((E + 1, A), dtype=bool)

    def fill_rules(row, rules):
        for a, rule in enumerate(rules):
            rule_room[row, a] = rule.room_idx
            rule_bbox[row, a] = [rule.min_x, rule.max_x, rule.min_z, rule.max_z]
            if rule.pos is not None:
                rule_pos[row, a] = rule.pos
            if rule.dir is not None:
                rule_dir[row, a] = rule.dir
            rule_dir_lo[row, a] = rule.dir_lo
            rule_dir_hi[row, a] = rule.dir_hi
            rule_mask[row, a] = True

    for i, s in enumerate(world.slots):
        slot_protos[i, : len(s.proto_ids)] = s.proto_ids
        slot_size_lo[i] = s.size_lo
        slot_size_hi[i] = s.size_hi
        fill_rules(i, s.rules)

    assert world.agent_slot is not None, "world must place the agent"
    fill_rules(E, world.agent_slot.rules)

    T = max(len(world.tex_slots), 1)
    tex_slot_base = np.zeros(T, dtype=np.int32)
    tex_slot_count = np.ones(T, dtype=np.int32)
    for i, (b, c) in enumerate(world.tex_slots):
        tex_slot_base[i] = b
        tex_slot_count[i] = c

    extents = np.array(
        [
            min(r.min_x for r in world.rooms),
            max(r.max_x for r in world.rooms),
            min(r.min_z for r in world.rooms),
            max(r.max_z for r in world.rooms),
        ],
        dtype=np.float32,
    )

    return Layout(
        tri_verts=tri_verts,
        tri_verts9=np.ascontiguousarray(tri_verts.reshape(S, 9).T),
        tri_attr=tri_attr,
        tri_uv=tri_uv, tri_normal=tri_normal,
        tri_tex=tri_tex, tri_tex_base=tri_tex_base,
        tri_tex_count=tri_tex_count,
        tri_color=tri_color, tri_mask=tri_mask,
        tri_room=tri_room, tri_is_room=tri_is_room, room_pvs=room_pvs,
        segs=segs, seg_mask=seg_mask, room_segs=room_segs,
        room_outline=room_outline, room_norms=room_norms,
        room_vmask=room_vmask, room_mask=room_mask,
        room_aabb=room_aabb, room_area=room_area,
        proto_shape=proto_shape, proto_mesh=proto_mesh,
        proto_mesh_mask=proto_mesh_mask,
        proto_size=proto_size,
        proto_radius=proto_radius, proto_height=proto_height,
        proto_color=proto_color, proto_colorable=proto_colorable,
        proto_static=proto_static, proto_pickable=proto_pickable,
        slot_protos=slot_protos, slot_size_lo=slot_size_lo,
        slot_size_hi=slot_size_hi, slot_mask=slot_mask,
        rule_room=rule_room, rule_bbox=rule_bbox, rule_pos=rule_pos,
        rule_dir=rule_dir, rule_dir_lo=rule_dir_lo, rule_dir_hi=rule_dir_hi,
        rule_mask=rule_mask,
        tex_slot_base=tex_slot_base, tex_slot_count=tex_slot_count,
        extents=extents,
    )
