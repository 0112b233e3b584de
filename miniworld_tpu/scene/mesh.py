"""Wavefront OBJ/MTL loading into flat triangle arrays.

Array-based replacement for the reference mesh loader
(miniworld/objmesh.py): instead of building per-material pyglet vertex
lists for GL, we bake every mesh into flat numpy triangle arrays
(vertices, normals, per-vertex colors, texture UVs) ready to be packed
into the raycaster's primitive stream.

Only the OBJ features the bundled assets use are supported: v/vt/vn
records, triangular ``f`` faces with v[/vt][/vn] indices, ``usemtl``,
and MTL ``Kd`` / ``map_Kd``.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import numpy as np

from miniworld_tpu.utils.assets import mesh_path


@dataclass
class TriMesh:
    """A mesh baked to triangles, recentered like the reference.

    The reference recenters meshes so the base sits at y=0 and x/z are
    centered (miniworld/objmesh.py:138-186). ``bbox_hi``/``bbox_lo`` are
    the true post-recentering extents; ``ref_max_coords`` reproduces the
    reference's quirky ``max_coords`` (it applies ``.min(axis=0)`` at
    objmesh.py:175) because entity *scale and radius* are derived from
    it (miniworld/entity.py:141-148) and physics parity depends on that.
    """

    name: str
    verts: np.ndarray  # (T, 3, 3) float64
    normals: np.ndarray  # (T, 3, 3) float64
    uvs: np.ndarray  # (T, 3, 2) float64
    colors: np.ndarray  # (T, 3) float64 — per-triangle Kd color
    tex_names: list = field(default_factory=list)  # per-tri texture or None
    bbox_lo: np.ndarray = None  # (3,)
    bbox_hi: np.ndarray = None  # (3,)
    ref_max_coords: np.ndarray = None  # (3,) reference-compatible extents

    @property
    def num_tris(self) -> int:
        return self.verts.shape[0]


def decimate_mesh(mesh: TriMesh, budget: int) -> TriMesh:
    """Reduce a mesh to <= ``budget`` triangles by vertex clustering.

    Dynamic entities render their actual triangles on-device
    (render/raycast._entity_mesh_pass); the per-(pixel, triangle) cost
    makes full-resolution assets (duckie: 1194 tris) unaffordable, so
    protos bake a decimated copy. Vertices are clustered on a uniform
    grid (binary search on resolution for the largest grid meeting the
    budget), cluster representatives are the mean member position, and
    each surviving triangle keeps the color/UV/texture of its
    largest-area source triangle. Simple, watertight, and good enough
    at 32-64 triangles for MiniWorld's props.
    """
    if mesh.num_tris <= budget:
        return mesh
    flat = mesh.verts.reshape(-1, 3)
    lo = flat.min(axis=0)
    span = np.maximum(flat.max(axis=0) - lo, 1e-9)

    e1 = mesh.verts[:, 1] - mesh.verts[:, 0]
    e2 = mesh.verts[:, 2] - mesh.verts[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    def build(res: int):
        cell = np.minimum(((flat - lo) / span) * res, res - 1e-6).astype(np.int64)
        cid = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inv = np.unique(cid, return_inverse=True)
        reps = np.zeros((len(uniq), 3))
        np.add.at(reps, inv, flat)
        counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        reps /= counts[:, None]
        tri_cids = inv.reshape(-1, 3)  # (T, 3) cluster per corner
        # drop degenerate (collapsed) triangles; dedup same triples by
        # largest source area
        keep = {}
        for t in range(tri_cids.shape[0]):
            a, b, c = tri_cids[t]
            if a == b or b == c or a == c:
                continue
            key = tuple(sorted((a, b, c)))
            if key not in keep or areas[t] > areas[keep[key]]:
                keep[key] = t
        return reps, tri_cids, sorted(keep.values())

    # largest grid resolution whose output fits the budget
    lo_r, hi_r = 1, 96
    best = None
    while lo_r <= hi_r:
        mid = (lo_r + hi_r) // 2
        reps, tri_cids, kept = build(mid)
        if len(kept) <= budget:
            best = (reps, tri_cids, kept)
            lo_r = mid + 1
        else:
            hi_r = mid - 1
    reps, tri_cids, kept = best
    kept = np.asarray(kept, dtype=np.int64)

    out_verts = reps[tri_cids[kept]]  # (K, 3, 3)
    e1 = out_verts[:, 1] - out_verts[:, 0]
    e2 = out_verts[:, 2] - out_verts[:, 0]
    n = np.cross(e1, e2)
    nl = np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    out_norms = np.repeat((n / nl)[:, None, :], 3, axis=1)

    return TriMesh(
        name=f"{mesh.name}@{budget}",
        verts=out_verts,
        normals=out_norms,
        uvs=mesh.uvs[kept],
        colors=mesh.colors[kept],
        tex_names=[mesh.tex_names[t] for t in kept],
        bbox_lo=mesh.bbox_lo,
        bbox_hi=mesh.bbox_hi,
        ref_max_coords=mesh.ref_max_coords,
    )


def _parse_mtl(path: str):
    """Parse an MTL file into {material_name: (Kd rgb, map_Kd path|None)}."""
    materials = {}
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            if tokens[0] == "newmtl":
                cur = tokens[1]
                materials[cur] = {"Kd": np.ones(3), "map_Kd": None}
            elif tokens[0] == "Kd" and cur is not None:
                materials[cur]["Kd"] = np.array([float(t) for t in tokens[1:4]])
            elif tokens[0] == "map_Kd" and cur is not None:
                materials[cur]["map_Kd"] = os.path.join(base, tokens[1])
    return materials


@functools.lru_cache(maxsize=None)
def load_mesh(mesh_name: str) -> TriMesh:
    """Load and recenter a mesh by name (cached)."""
    obj_path = mesh_path(mesh_name)
    base = os.path.splitext(obj_path)[0]

    verts, texs, norms = [], [], []
    faces = []  # (v_idx[3], vt_idx[3], vn_idx[3], mtl_name)
    cur_mtl = None
    materials = {}

    mtl_path = base + ".mtl"
    if os.path.exists(mtl_path):
        materials = _parse_mtl(mtl_path)

    with open(obj_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            kind = tokens[0]
            if kind == "v":
                verts.append([float(t) for t in tokens[1:4]])
            elif kind == "vt":
                texs.append([float(t) for t in tokens[1:3]])
            elif kind == "vn":
                norms.append([float(t) for t in tokens[1:4]])
            elif kind == "usemtl":
                cur_mtl = tokens[1]
            elif kind == "mtllib":
                lib = os.path.join(os.path.dirname(obj_path), tokens[1])
                if os.path.exists(lib):
                    materials.update(_parse_mtl(lib))
            elif kind == "f":
                assert len(tokens) == 4, f"{mesh_name}: only triangle faces supported"
                vi, ti, ni = [], [], []
                for vert_str in tokens[1:]:
                    parts = vert_str.split("/")
                    vi.append(int(parts[0]) - 1)
                    ti.append(int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1)
                    ni.append(int(parts[2]) - 1 if len(parts) > 2 and parts[2] else -1)
                faces.append((vi, ti, ni, cur_mtl))

    verts = np.array(verts, dtype=np.float64)
    texs = np.array(texs, dtype=np.float64) if texs else np.zeros((0, 2))
    norms = np.array(norms, dtype=np.float64) if norms else np.zeros((0, 3))

    # Default material: white, with a same-named PNG if present
    # (miniworld/objmesh.py:218-232).
    default_tex = base + ".png" if os.path.exists(base + ".png") else None

    T = len(faces)
    tri_verts = np.zeros((T, 3, 3))
    tri_norms = np.zeros((T, 3, 3))
    tri_uvs = np.zeros((T, 3, 2))
    tri_colors = np.ones((T, 3))
    tri_tex = []

    for t, (vi, ti, ni, mtl_name) in enumerate(faces):
        tri_verts[t] = verts[vi]
        if all(i >= 0 for i in ti) and len(texs):
            tri_uvs[t] = texs[ti]
        if all(i >= 0 for i in ni) and len(norms):
            tri_norms[t] = norms[ni]
        else:
            e1 = tri_verts[t, 1] - tri_verts[t, 0]
            e2 = tri_verts[t, 2] - tri_verts[t, 0]
            n = np.cross(e1, e2)
            nl = np.linalg.norm(n)
            tri_norms[t] = n / nl if nl > 0 else np.array([0.0, 1.0, 0.0])
        mat = materials.get(mtl_name)
        if mat is not None:
            tri_colors[t] = mat["Kd"]
            tri_tex.append(mat["map_Kd"])
        else:
            tri_tex.append(default_tex)

    # Recentering: base at y=0, centered in x/z. The reference computes
    # the centering offset with a quirky reduction — min over faces then
    # min over vertex slots for the lower corner, but *max over faces
    # then MIN over vertex slots* for the upper corner
    # (miniworld/objmesh.py:174-182). MeshEnt scale and radius derive
    # from the post-recentering extents (entity.py:141-148), so we
    # reproduce the quirk exactly for physics parity.
    lo_q = tri_verts.min(axis=0).min(axis=0)  # (3,) true minimum
    hi_q = tri_verts.max(axis=0).min(axis=0)  # (3,) reference quirk
    mean_q = 0.5 * (lo_q + hi_q)
    offset = np.array([mean_q[0], lo_q[1], mean_q[2]])
    tri_verts -= offset

    # Final extents are the true min/max after recentering
    # (objmesh.py:184-186); these feed MeshEnt scale/radius.
    lo2 = tri_verts.reshape(-1, 3).min(axis=0)
    hi2 = tri_verts.reshape(-1, 3).max(axis=0)
    ref_max = hi2.copy()

    return TriMesh(
        name=mesh_name,
        verts=tri_verts,
        normals=tri_norms,
        uvs=tri_uvs,
        colors=tri_colors,
        tex_names=tri_tex,
        bbox_lo=lo2,
        bbox_hi=hi2,
        ref_max_coords=ref_max,
    )
