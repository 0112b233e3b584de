"""Raycaster: RGB-D observations without OpenGL and without gathers.

Replaces the reference's fixed-function GL pipeline
(miniworld/miniworld.py:1260-1318, miniworld/opengl.py:197-435) with a
pure-JAX perspective raycaster that XLA compiles for the accelerator:

  * Ray-triangle intersection is algebraically rearranged so the
    per-(pixel, triangle) work is three separable contractions plus
    cheap elementwise masking: for ray ``o + t*d`` and triangle
    (v0, e1, e2),

        det   = d . (e2 x e1)
        u*det = d . (e2 x (o-v0))
        v*det = d . ((o-v0) x e1)
        t*det = e2 . ((o-v0) x e1)        (pixel-independent!)

  * **No per-pixel gathers.** The design was made for another chip,
    where per-pixel gathers lowered to slow element-wise loads; it has
    not been measured on the GPU yet (ROADMAP A3/A4/D1). Instead:
      - Triangle attributes are resolved *inside* the chunk scan: the
        within-chunk winner per pixel becomes a one-hot row that is
        contracted against the chunk's packed attribute table — an
        ``(HW, TC) @ (TC, 16)`` matrix product, carried across chunks
        with the running z-buffer.
      - Texture sampling uses the Fourier texture model (see
        textures.fit_fourier_texture): the winning texture's packed
        coefficients are selected with a small one-hot product over
        the texture table, then evaluated as K cosine terms per pixel.
        GL_REPEAT tiling is exact (integer frequencies).
  * A ``lax.scan`` over triangle chunks keeps memory O(HW * 16), not
    O(HW * S).
  * Matrix-product precision is named at every f32 product: XLA's
    DEFAULT lets the GPU round f32 operands to TF32 (10-bit mantissa),
    so geometry and exact-id selects ask for HIGHEST (``matmul_f32``)
    and the bf16 attribute resolve rounds its operands to bf16 itself
    (``_select_rows``).
  * Backface culling (det > 0) reproduces GL_CULL_FACE; ray parameter t
    equals eye-space Z because ray directions are built with a unit
    forward component, so the depth map matches the reference's
    perspective-inverted depth (miniworld/opengl.py:400-435).
  * Rays are generated from the agent camera exactly as gluPerspective/
    gluLookAt would (fov_y, aspect, near=0.04, far=100;
    miniworld.py:1283-1301).

Deviations from GL (statistical, not bit-level, visual parity):
1 sample/pixel vs 8x MSAA; K-term Fourier texture reconstruction vs
trilinear mipmaps (validated sharper than the mip level GL uses at
80x60); per-pixel instead of per-vertex (Gouraud) lighting.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from miniworld_tpu.ops import geom
from miniworld_tpu.scene.entities import SHAPE_BOX, SHAPE_MESH_TRIS, SHAPE_SPHERE

NEAR = 0.04  # miniworld/miniworld.py:1287
FAR = 100.0
# OpenGL default global ambient (GL_LIGHT_MODEL_AMBIENT); the reference
# never overrides it, so it contributes to every lit fragment.
GL_GLOBAL_AMBIENT = 0.2

# Packed per-primitive attribute row (Layout.tri_attr):
#   [A(6) | b(2) | normal(3) | color(3) | tex_slot(1) | kind]
# (A, b) is the prim's affine texture map uv = A @ p + b. ``kind``
# (scene/room.TriBatch.kinds) selects the coverage test: 1.0 =
# triangle (u + v <= det), 0.0 = parallelogram (u <= det AND
# v <= det) — rect quads render as ONE prim, halving the hit-test
# fusion's rows (the reference draws GL_QUADS, miniworld.py:330-400).
# Dynamic mesh-entity rows keep a literal ones column there
# (all triangles; _entity_mesh_pass normalizes real ties by it).
ATTR_DIM = 16
_AMAP, _BMAP = slice(0, 6), slice(6, 8)
_NRM, _COL, _SLOT, _KIND = slice(8, 11), slice(11, 14), 14, 15
_ONE = _KIND  # mesh-entity rows: same column, literal 1.0

# Bits of the z-key's mantissa that carry the winning within-chunk row
# index (see _tri_pass): caps tri_chunk at 1024 rows and quantizes the
# depth competition to a 13-bit mantissa — still ~8x finer than the
# reference's GL_UNSIGNED_SHORT depth buffer (opengl.py:400-435).
_IDX_BITS = 10
_IDX_MASK = (1 << _IDX_BITS) - 1


def matmul_f32(a, b):
    """``a @ b`` in full f32. At DEFAULT precision the GPU may run an f32
    product on the tensor cores in TF32, which rounds each operand to a
    10-bit mantissa: enough to move a silhouette or a texture
    coordinate, and exact for integers only up to 2048."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _select_rows(onehot, table, out_dtype):
    """``onehot^T @ table`` for an (N, HW) one-hot with at most one 1
    per column: each pixel's selected (ATTR_DIM,) table row, or zeros.

    bf16 output: both operands are rounded to bf16 BEFORE the product.
    With a single nonzero term that gives the same bits as rounding the
    exact f32 product after it, on every backend, and the product runs
    as a bf16 matrix product. f32 output: HIGHEST, so slot ids past
    2048 and uv-map coefficients are not rounded to TF32 on the GPU.
    """
    dims = (((0,), (0,)), ((), ()))
    if out_dtype == jnp.bfloat16:
        return jax.lax.dot_general(
            onehot.astype(jnp.bfloat16), table.astype(jnp.bfloat16), dims,
            preferred_element_type=jnp.bfloat16,
        )
    return jax.lax.dot_general(
        onehot, table, dims, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(out_dtype)


def camera_grid(state, width: int, height: int):
    """Separable ray decomposition: (fwd, right, up, xv, yv) with the
    per-pixel ray d = fwd + xv*right + yv*up (unit forward component).

    Matches gluPerspective(fov_y, width/height, ...) + gluLookAt with
    the agent's camera basis; row 0 is the TOP image row (the reference
    flips the GL readback; opengl.py:393-398). The primitive passes
    exploit the decomposition directly: a ray-set dot g . d becomes
    (g.fwd) + xv*(g.right) + yv*(g.up) — the three basis dots are
    per-PRIM, leaving 2 FMAs per (prim, pixel) instead of 3.
    """
    fwd, up, right = geom.cam_basis(state.dir, state.cam_pitch)
    tan_y = jnp.tan(jnp.deg2rad(state.cam_fov_y) * 0.5)
    tan_x = tan_y * (width / height)

    xs = (2.0 * (jnp.arange(width, dtype=jnp.float32) + 0.5) / width - 1.0) * tan_x
    ys = (1.0 - 2.0 * (jnp.arange(height, dtype=jnp.float32) + 0.5) / height) * tan_y
    xv = jnp.broadcast_to(xs[None, :], (height, width)).reshape(-1)
    yv = jnp.broadcast_to(ys[:, None], (height, width)).reshape(-1)
    return fwd, right, up, xv, yv


def camera_rays(state, width: int, height: int):
    """Per-pixel ray directions (HW, 3); see camera_grid."""
    fwd, right, up, xv, yv = camera_grid(state, width, height)
    return (
        fwd[None, :] + xv[:, None] * right[None, :] + yv[:, None] * up[None, :]
    )


def room_of_point(bank, layout_id, p_xz):
    """Index of the room containing (or nearest to) a 2D point.

    Argmax over rooms of convex insideness (min over edges of
    inward-normal distance; Room.point_inside semantics,
    miniworld/miniworld.py:273-285) — robust at portal boundaries,
    where a strict inside test can reject both adjacent rooms in f32.
    """
    outline = bank.room_outline[layout_id]  # (R, V, 2)
    norms = bank.room_norms[layout_id]
    vmask = bank.room_vmask[layout_id]
    rmask = bank.room_mask[layout_id]
    d = jnp.sum(norms * (p_xz[None, None, :] - outline), axis=-1)  # (R, V)
    score = jnp.min(jnp.where(vmask, d, jnp.inf), axis=1)
    score = jnp.where(rmask, score, -jnp.inf)
    return jnp.argmax(score)


def chunk_schedule(bank, chunk_vis, layout_id, origin, sched_len: int):
    """PVS chunk schedule for one env: the indices of triangle chunks
    potentially visible from the camera's room, compacted to a STATIC
    length (scene/pvs.py computes the visibility; the vector layer
    sizes ``sched_len`` as the worst case over (layout, room), so
    compaction never drops an active chunk). Inactive tail slots hold
    the sentinel n_chunks, which the chunk scan clamps to a repeat of
    the last chunk — re-rendering triangles is a no-op under z-min.
    """
    vis = chunk_vis[layout_id, :, room_of_point(bank, layout_id, origin[jnp.array([0, 2])])]
    n_chunks = vis.shape[0]
    keys = jnp.where(vis, jnp.arange(n_chunks, dtype=jnp.int32), n_chunks)
    return jax.lax.sort(keys)[:sched_len]


# Counter-based uniform in [0,1) keyed on (key, id): same id => same
# draw within an episode, so every triangle of a (room, role) texture
# slot picks the same variant while distinct slots draw independently
# (the reference samples one variant per Texture.get call,
# opengl.py:136-140). The render scan evaluates it chunk-wise — the
# per-episode texture-variant state is just the scalar key,
# state.tri_slots. Shared with reset-time draws in ops/rng.py.
from miniworld_tpu.ops.rng import hash01  # noqa: E402,F401 (re-export)


def _tri_pass(verts9_bank, attr_bank, layout_id, origin, rays,
              tri_chunk: int, slot_key=None, tex_banks=None,
              dr_active: bool = False, chunk_sched=None,
              init=None, tri_active=None, chunk_rows=None,
              attr_dtype=jnp.bfloat16, all_quads: bool = False,
              paired=None):
    """Scan triangle chunks carrying (t_best, attr_best, u_best, v_best).

    ``verts9_bank`` (L, 9, S) and ``attr_bank`` (L, S, ATTR_DIM) are the
    triangle source — either the plain bank arrays or the packed
    per-room PVS copies (vector.plan_packed_pvs); the pass itself is
    agnostic.

    The winning triangle's packed attributes are resolved in-chunk via
    a one-hot matmul, so no per-pixel index survives the scan — and no
    gather is ever issued.

    ``slot_key`` (() u32, optional, fourier mode) replaces the static
    slot column of the packed attrs with this episode's per-tri atlas
    index, computed chunk-wise as ``base + floor(hash01(key, slot_id)
    * count)`` from ``tex_banks = (tri_tex (L,S) i32, tri_tex_base
    (L,S) f32, tri_tex_count (L,S) f32)`` — per-(room, role)
    texture-variant randomization with no per-tri episode state and no
    slot-table lookup. With ``dr_active=False`` the override is just
    the atlas base (variant 0), matching no_random resets.

    ``chunk_sched`` ((N,) i32, optional) restricts the scan to the
    given chunk indices (PVS culling; see chunk_schedule). Out-of-range
    sentinel entries re-render the last chunk (dynamic_slice clamps),
    which is harmless under z-min.

    ``init`` ((HW,) t, (HW, ATTR_DIM) attr) seeds the carry — how
    dynamic mesh entities join the z-competition for free (the scan's
    own closer-select is the merge; no post-pass select or layout
    copies).

    ``tri_active`` ((S,) f32 0/1, optional) kills triangles per ENV for
    free (procgen super-banks, scene/supermaze.py): the activity
    multiplies into the per-TRIANGLE reciprocal ``inv_tnum``, so a
    killed triangle's r is exactly 0 and fails the r > 1/FAR gate —
    zero per-pixel cost. Dense scans only (asserted).

    ``attr_dtype`` (static): the resolved-attr carry dtype. bf16 keeps
    the slot column's integer ids exact ONLY while they stay <= 256
    (8-bit mantissa); render_rgbd picks f32 automatically when the
    texture table is larger (attr_carry_dtype) instead of silently
    rounding ids — big nearest-mode slot tables (a 10x10 maze has
    3 x #rooms local slots) and >256-row atlases stay exact.

    The vector layer repads the bank so ``S % tri_chunk == 0``
    (MiniWorldVec._repad_for_chunks): chunk boundaries then align
    cleanly, and vertex reads come from the component-major
    ``tri_verts9`` rows rather than (TC, 3, 3) gathers with a tiny
    inner dimension (a layout chosen for another chip; not yet
    measured on the GPU).
    """
    num_tris = verts9_bank.shape[-1]
    tri_chunk = min(tri_chunk, num_tris)
    n_chunks = -(-num_tris // tri_chunk)
    fwd, right, up, xv, yv = rays  # camera_grid decomposition
    hw = xv.shape[0]

    def read_chunk(c):
        """(v9 (9, TC), attrs (TC, ATTR_DIM)) for chunk index c.

        No mask read: padding triangles are all-zero by construction,
        so det == 0 and they can never hit.

        ``chunk_rows`` = (v9_rows (L*NC, 9*TC), attr_rows
        (L*NC, TC*ATTR_DIM), n_chunks_per_layout): read the chunk with
        ONE one-hot matrix product per operand instead of a per-env
        dynamic_slice, which lowered as a while-loop gather when
        vmapped over the layout axis on the chip this was tuned for
        (unmeasured on the GPU; ROADMAP A4). HIGHEST precision keeps
        f32 vertex coordinates (and nearest-mode slot ids) exact
        through the dot.
        """
        if chunk_rows is not None:
            assert slot_key is None, "chunk_rows excludes the dr override"
            v9_rows, attr_rows, ncl = chunk_rows
            oh = (jnp.arange(v9_rows.shape[0], dtype=jnp.int32)
                  == layout_id * ncl + c).astype(jnp.float32)
            v9 = jax.lax.dot_general(
                oh[None, :], v9_rows,
                dimension_numbers=(((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )[0].reshape(9, tri_chunk)
            attrs = jax.lax.dot_general(
                oh[None, :], attr_rows,
                dimension_numbers=(((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )[0].reshape(tri_chunk, ATTR_DIM)
            return v9, attrs
        start = c * tri_chunk
        v9 = jax.lax.dynamic_slice(
            verts9_bank, (layout_id, 0, start), (1, 9, tri_chunk)
        )[0]  # (9, TC) component-major
        attrs = jax.lax.dynamic_slice(
            attr_bank, (layout_id, start, 0), (1, tri_chunk, ATTR_DIM)
        )[0]
        if paired is not None:
            # paired procgen super bank (Layout.pg_*): select the
            # wall's live variant per env — junction content (primary)
            # when the wall is open, its closed quads (alt) when not.
            # ``use_p`` is this env's (Sp,) 0/1 vector (one matvec per
            # render); the select is (9+16, TC) elementwise.
            use_p, v9_alt_bank, attr_alt_bank, pg_tex_bank = paired
            v9a = jax.lax.dynamic_slice(
                v9_alt_bank, (layout_id, 0, start), (1, 9, tri_chunk)
            )[0]
            aa = jax.lax.dynamic_slice(
                attr_alt_bank, (layout_id, start, 0),
                (1, tri_chunk, ATTR_DIM),
            )[0]
            up = jax.lax.dynamic_slice(use_p, (start,), (tri_chunk,))
            keep = up > 0.5
            v9 = jnp.where(keep[None, :], v9, v9a)
            attrs = jnp.where(keep[:, None], attrs, aa)
            if slot_key is not None:
                t2 = jax.lax.dynamic_slice(
                    pg_tex_bank, (layout_id, 0, 0, start),
                    (1, 2, 3, tri_chunk),
                )[0]  # (2, 3, TC): [variant][ids|base|cnt]
                ids = jnp.where(keep, t2[0, 0], t2[1, 0])
                base = jnp.where(keep, t2[0, 1], t2[1, 1])
                cnt = jnp.where(keep, t2[0, 2], t2[1, 2])
                if dr_active:
                    u_t = hash01(slot_key, ids)
                    offs = jnp.minimum(jnp.floor(u_t * cnt), cnt - 1.0)
                    ov = jnp.where(base >= 0.0, base + offs, -1.0)
                else:
                    ov = base
                attrs = jnp.concatenate(
                    [attrs[:, :_SLOT], ov[:, None], attrs[:, _SLOT + 1:]],
                    axis=1,
                )
            return v9, attrs
        if slot_key is not None:
            tex_ids, tex_base, tex_count = tex_banks
            base = jax.lax.dynamic_slice(
                tex_base, (layout_id, start), (1, tri_chunk)
            )[0]
            if dr_active:
                ids = jax.lax.dynamic_slice(
                    tex_ids, (layout_id, start), (1, tri_chunk)
                )[0]
                cnt = jax.lax.dynamic_slice(
                    tex_count, (layout_id, start), (1, tri_chunk)
                )[0]
                u_t = hash01(slot_key, ids)
                offs = jnp.minimum(jnp.floor(u_t * cnt), cnt - 1.0)
                ov = jnp.where(base >= 0.0, base + offs, -1.0)
            else:
                ov = base  # -1 where flat; variant 0 otherwise
            attrs = jnp.concatenate(
                [attrs[:, :_SLOT], ov[:, None], attrs[:, _SLOT + 1:]], axis=1
            )
        return v9, attrs

    def chunk_compete(x):
        """One chunk's keyed-z competition: (key_max (HW,) i32,
        sel (HW, ATTR_DIM) bf16)."""
        if tri_active is None:
            v9, attrs = x
        else:
            v9, attrs, act = x

        # all-lane component math on (TC,) rows (v9 is component-major)
        e1x, e1y, e1z = v9[3] - v9[0], v9[4] - v9[1], v9[5] - v9[2]
        e2x, e2y, e2z = v9[6] - v9[0], v9[7] - v9[1], v9[8] - v9[2]
        sx = origin[0] - v9[0]
        sy = origin[1] - v9[1]
        sz = origin[2] - v9[2]

        # g_det = e2 x e1 ; g_u = e2 x s ; g_v = s x e1
        gdx, gdy, gdz = (e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z,
                         e2x * e1y - e2y * e1x)
        gux, guy, guz = (e2y * sz - e2z * sy, e2z * sx - e2x * sz,
                         e2x * sy - e2y * sx)
        gvx, gvy, gvz = (sy * e1z - sz * e1y, sz * e1x - sx * e1z,
                         sx * e1y - sy * e1x)
        t_num = e2x * gvx + e2y * gvy + e2z * gvz  # (TC,)
        # Reciprocal-depth competition: t = t_num / det per (tri, px),
        # but 1/t = det * (1/t_num) needs only a PER-TRIANGLE
        # reciprocal — the per-(tri, px) divide becomes one multiply,
        # and min-t becomes max-r. Triangles with t_num <= 0
        # cannot give t > NEAR under det > 0; zeroing their reciprocal
        # makes r = 0 fail the r > 1/FAR gate.
        inv_tnum = jnp.where(
            t_num > 0.0, 1.0 / jnp.where(t_num > 0.0, t_num, 1.0), 0.0
        )  # (TC,)
        if tri_active is not None:
            # per-env triangle kill: r = det * inv_tnum becomes exactly
            # 0 for killed rows and fails the r > 1/FAR gate
            inv_tnum = inv_tnum * act

        # Per-(tri,pixel) contractions as broadcast FMAs in (TC, HW)
        # orientation: triangles lead, pixels minor, so the z-buffer
        # reduce runs over the leading axis. K=3 dots are avoided: a
        # K=3 contraction cannot use a matrix unit, and on the chip
        # this was tuned for its lowering produced edge cracks at
        # silhouettes. Exact f32
        # elementwise math keeps the hit test identical across
        # backends up to FMA contraction. The ray SEPARABILITY
        # d = fwd + xv*right + yv*up (camera_grid) makes
        # g . d = (g.fwd) + xv*(g.right) + yv*(g.up) with the three
        # basis dots hoisted to per-TRI (TC,) work — 2 FMAs per (tri,
        # pixel) instead of 3. (Layout choices made for another chip;
        # their cost on the GPU is not yet measured, ROADMAP A2.)
        def contract(gx, gy, gz):
            a = gx * fwd[0] + gy * fwd[1] + gz * fwd[2]  # (TC,)
            b = gx * right[0] + gy * right[1] + gz * right[2]
            c = gx * up[0] + gy * up[1] + gz * up[2]
            return (
                a[:, None]
                + b[:, None] * xv[None, :]
                + c[:, None] * yv[None, :]
            )

        det = contract(gdx, gdy, gdz)  # (TC, HW)
        u_num = contract(gux, guy, guz)
        v_num = contract(gvx, gvy, gvz)

        # det > 0 <=> front-facing (GL_CULL_FACE; miniworld.py:513)
        r = det * inv_tnum[:, None]  # = 1/t
        # Kind-blended coverage: triangles (kind 1) need
        # u + v <= det — max + 1.0*min adds the SAME two floats, so
        # the tri path is bit-identical to the former u_num + v_num;
        # parallelograms (kind 0) need max(u, v) <= det. ``all_quads``
        # (static, from the bank's kind column) skips the blend — maze
        # banks are 100% rect prims (padding rows never hit: det = 0).
        if all_quads:
            cov = jnp.maximum(u_num, v_num)
        else:
            kind = attrs[:, _KIND:_KIND + 1]  # (TC, 1)
            cov = (
                jnp.maximum(u_num, v_num)
                + kind * jnp.minimum(u_num, v_num)
            )
        hit = (
            (det > 1e-12)
            & (u_num >= 0.0)
            & (v_num >= 0.0)
            & (cov <= det)
            & (r < 1.0 / NEAR)
            & (r > 1.0 / FAR)
        )
        # Keyed z-competition: the winner's within-chunk row index is
        # packed into the low _IDX_BITS mantissa bits of r's bit
        # pattern (monotone for r > 0, so an i32 max still ranks by
        # depth; quantizing r to a 13-bit mantissa is far finer than
        # the reference's 16-bit GL depth buffer, opengl.py:400-435).
        # The attribute one-hot is then a pure INTEGER COMPARE against
        # the winning index, so the one-hot's producer never has to
        # recompute the det/u/v hit test (the (TC, HW) intermediates
        # are never materialized). Ties at equal quantized depth pick
        # the larger row index (GL z-fighting is order-dependent too).
        rkey = jax.lax.bitcast_convert_type(r, jnp.int32)
        idx = jax.lax.broadcasted_iota(jnp.int32, (r.shape[0], 1), 0)
        key = jnp.where(hit, (rkey & ~_IDX_MASK) | idx, 0)

        key_max = jnp.max(key, axis=0)  # (HW,)
        ohf = (idx == (key_max & _IDX_MASK)[None, :]).astype(jnp.float32)
        # attribute resolve: (TC, HW)^T @ (TC, 16), no gather.
        # (A no-hit pixel selects row 0's attrs; its key stays 0 so the
        # carry never takes them, and the final t is inf -> sky.)
        # The carry is bf16 while slot ids fit (attr_carry_dtype): it
        # halves the (B, HW, 16) carry/select streams, and
        # _select_rows makes it the same bits on the GPU as on the CPU.
        # An f32 carry resolves at HIGHEST precision.
        sel = _select_rows(ohf, attrs, attr_dtype)  # (HW, 16)
        return key_max, sel

    def body(carry, x):
        # barrier: keeps XLA from fusing or rematerializing iterations
        # of this scan into one (B, HW, S) buffer, as it did on the chip
        # this was tuned for (whether the GPU needs it is not yet
        # measured, ROADMAP D1)
        carry = jax.lax.optimization_barrier(carry)
        key_best, attr_best = carry
        key_max, sel = chunk_compete(x)
        # Key comparison across chunks keeps the SINGLE winner (the
        # packed index makes keys unique per pixel; a repeat-sentinel
        # chunk reproduces the identical key and is not closer).
        closer = key_max > key_best
        return (
            jnp.where(closer, key_max, key_best),
            jnp.where(closer[:, None], sel, attr_best),
        ), None

    seeded_init = init
    if init is None:
        init = (
            jnp.zeros(hw, jnp.int32),  # key 0 = no hit (t = inf)
            jnp.zeros((hw, ATTR_DIM), attr_dtype),
        )
    else:
        # seeds arrive in t-space (the mesh-entity pass); 1/inf == 0.
        # The seed takes the max index so it wins quantized-depth ties
        # against coincident static geometry deterministically.
        seed_r = 1.0 / init[0]
        seed_key = jnp.where(
            seed_r > 0.0,
            (jax.lax.bitcast_convert_type(seed_r, jnp.int32)
             & ~_IDX_MASK) | _IDX_MASK,
            0,
        )
        init = (seed_key, init[1].astype(attr_dtype))
    # Chunk data is gathered BEFORE the scan (vmapped read_chunk) and
    # fed as scan xs: the scan then unstacks plain slices instead of
    # issuing per-iteration dynamic slices with scalar offsets.
    cs = jnp.arange(n_chunks, dtype=jnp.int32) if chunk_sched is None else chunk_sched
    xs = jax.vmap(read_chunk)(cs)
    if tri_active is not None:
        assert chunk_sched is None, "tri_active requires a dense scan"
        xs = (*xs, tri_active.reshape(n_chunks, tri_chunk))
    if int(cs.shape[0]) == 1 and seeded_init is None:
        # single-chunk schedule, no seed (Maze packed sched-1, Hallway):
        # skip the scan — and with it the zero-init broadcast and the
        # (B, HW, 16) carry select.
        # No-hit pixels return key 0 (t = inf -> sky) with chunk row
        # 0's attrs, which nothing downstream reads for sky pixels.
        key_best, attr_best = chunk_compete(
            jax.tree.map(lambda a: a[0], xs)
        )
    else:
        (key_best, attr_best), _ = jax.lax.scan(body, init, xs)
    # No tie-normalize divide: the keyed-z winner is unique per pixel
    # (the packed row index disambiguates equal quantized depths), the
    # mesh-pass seed arrives already normalized, and no-hit pixels stay
    # at the all-zero init — the ones column is always exactly 0 or 1
    # here.
    # attr_best RETURNS the carry dtype: downstream uv/shade/slot
    # consumers promote bf16 x f32 arithmetic to f32 in-register, with
    # the same values as an explicit f32 copy.
    r_best = jax.lax.bitcast_convert_type(key_best & ~_IDX_MASK,
                                          jnp.float32)
    t_best = jnp.where(key_best > 0, 1.0 / jnp.maximum(r_best, 1e-30),
                       jnp.inf)
    return t_best, attr_best


def attr_carry_dtype(tex, state) -> "jnp.dtype":
    """Resolved-attr carry dtype for this render: bf16 while every
    slot id the attr stream can carry is an exact bf16 integer
    (<= 256), else f32.

    fourier mode carries ATLAS indices (tex table rows); nearest mode
    carries layout-LOCAL slot ids resolved later through
    ``state.tex_map`` (a 10x10 maze's 3 x #rooms local slots exceed
    256 — silently rounding them cross-assigned roles/rooms). The
    half-width (B, HW, 16) attr streams are kept wherever exact;
    bigger tables pay the f32 carry instead of refusing to construct.
    """
    n_ids = tex["coeffs"].shape[0] if tex["mode"] == "fourier" \
        else state.tex_map.shape[0]
    return jnp.bfloat16 if n_ids <= 256 else jnp.float32


def _cos_sin_turns(phi: jax.Array):
    """(cos, sin) of ``2*pi*phi`` via turn-wrapped minimax polynomials.

    The Fourier texture model only ever needs cos/sin at integer
    frequencies times uv, i.e. periodic in whole turns — so wrap the
    phase to t in [-1/2, 1/2] with one round() and evaluate degree-4
    polynomials in t^2 (~12 multiply-adds for BOTH outputs) instead of
    two library calls with general argument reduction. Chosen for
    another chip, whose cos/sin were costly; not yet measured on the
    GPU (ROADMAP D1). Max abs error 1.2e-4 — 16x below u8 texel
    quantization (tested vs jnp.cos/sin in tests/test_render.py).
    """
    t = phi - jnp.round(phi)
    x = t * t
    c = (((46.31062891 * x - 82.70142833) * x + 64.7143991) * x
         - 19.73279735) * x + 0.99997109
    s = t * ((((33.16881029 * x - 74.67622289) * x + 81.40014212) * x
              - 41.33325045) * x + 6.2830885)
    return c, s


def eval_fourier(coeffs_env: jax.Array, slot: jax.Array, uv: jax.Array,
                 k_terms: int, footprint: jax.Array | None = None,
                 has_gain: bool = True):
    """Evaluate the Fourier texture model per pixel.

    Args:
      coeffs_env: (A, 3+8K) texture table. In the render path this is
        the full shared atlas and ``slot`` already holds per-pixel
        atlas indices (variant randomization resolved per tri).
      slot: (HW,) f32 texture slot per pixel (from the attr matmul;
        exact for small ints), -1 or padding => flat white.
      uv: (HW, 2).

    Returns (HW, 3) linear-space texel colors.
    """
    n_slots = coeffs_env.shape[0]
    slot_i = jnp.round(slot).astype(jnp.int32)
    k = k_terms
    a0 = 3 + 2 * k

    # Structure (chosen for another chip; not yet measured on the GPU,
    # ROADMAP A3):
    #  * cos/sin are computed ONCE per pixel on the winning texture's
    #    frequencies (selected by a small one-hot product) — per-slot
    #    re-evaluation would multiply the transcendental cost by T;
    #  * the amplitude contractions run as matrix products
    #    (HW,K)@(K,3T) instead of (HW,K) reductions;
    #  * per-pixel slot selection of the 3T sums is a tiny masked sum.
    # Every selection and amplitude product in this stage has bf16
    # OPERANDS, set here explicitly: one half-width (B, HW, A) one-hot
    # feeds every dot, and the result does not depend on a backend's
    # DEFAULT f32 precision (TF32 on the GPU, f32 on the CPU). Texel error from the bf16 amplitudes stays under a u8
    # level (tests/test_render.py holds the Fourier path to the exact
    # nearest sampler).
    oh = (slot_i[:, None] == jnp.arange(n_slots)[None, :]).astype(jnp.bfloat16)
    # frequency selection in bf16: frequencies are small integers
    # (exact in bf16 up to 256) and the half-width intermediate halves
    # the memory traffic of this memory-bound op
    freqs = jax.lax.dot_general(
        oh,
        coeffs_env[:, 3:3 + 2 * k].astype(jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.bfloat16,
    )  # (HW, 2K) selected [fu | fv] — stays bf16 (small ints, exact);
    # the materialized (B, HW, 2K) stream is half-width, upcasts happen
    # in-register inside the consumer fusion
    fu = freqs[:, :k].astype(jnp.float32)
    fv = freqs[:, k:].astype(jnp.float32)
    phi = fu * uv[:, 0:1] + fv * uv[:, 1:2]  # turns
    c, s = _cos_sin_turns(phi)  # (HW, K) each
    if footprint is not None:
        # Frequency-space anti-aliasing — the Fourier analog of GL's
        # trilinear mipmapping: a pixel whose uv-space footprint spans
        # several periods of a term averages that term to ~zero, so
        # attenuate each term by a rational low-pass in (freq x
        # footprint). Kills distance moire on high-frequency textures
        # (checkerboard floors); a handful of (HW, K) elementwise ops.
        f2 = fu * fu + fv * fv  # (HW, K)
        att = 1.0 / (1.0 + (math.pi ** 2) * f2 * (footprint[:, None] ** 2))
        c, s = c * att, s * att
    # Two half-width operand streams instead of one concatenated
    # (HW, 2K+1): on the chip this was tuned for, the concat form
    # materialized cos/sin/att as three full f32 (B, HW, K) arrays; as
    # two bf16 stores the whole phase+poly+AA chain fuses into their
    # producers.
    ca = c.astype(jnp.bfloat16)
    sa = s.astype(jnp.bfloat16)

    # W: (3T, K) channel-major amplitude rows; the DC term joins after
    # the slot selection (dc_pix below) instead of riding a ones
    # column. Channel-major ordering keeps the per-channel slot
    # selection a contiguous slice (a (HW, T, 3) reshape would force a
    # layout copy).
    amps = coeffs_env[:, a0:a0 + 6 * k]  # (T, 6K) = [A(3K) | B(3K)]
    w_a = amps[:, :3 * k].reshape(n_slots, 3, k).transpose(1, 0, 2).reshape(
        3 * n_slots, k
    )
    w_b = amps[:, 3 * k:].reshape(n_slots, 3, k).transpose(1, 0, 2).reshape(
        3 * n_slots, k
    )
    # bf16 OUTPUTS requested from the dots themselves: the product
    # still accumulates in f32 and converts on the way out, so XLA
    # skips a separate f32 (B, HW, T) materialization + convert pass.
    # The bf16 add of the two rounded partials differs from
    # round-after-f32-add by <= 1 bf16 ulp — under a u8 texel step.
    sums = (
        jax.lax.dot_general(
            ca, w_a.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.bfloat16,
        )
        + jax.lax.dot_general(
            sa, w_b.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.bfloat16,
        )
    )  # (HW, 3T) bf16, channel-major
    # (An optimization_barrier here, to stop the per-channel slices
    # propagating into the amplitude dots, was slower on another chip;
    # XLA is left to split the dots per channel.)
    if has_gain:
        dcg = jax.lax.dot_general(
            oh,
            jnp.concatenate(
                [coeffs_env[:, 0:3], coeffs_env[:, -1:]], axis=1
            ).astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (HW, 4): [dc rgb | gain]
        dc_pix = dcg[:, 0:3]
    else:
        dc_pix = jax.lax.dot_general(
            oh, coeffs_env[:, 0:3].astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (HW, 3)
    # per-channel slot select: bf16 product of exact 0/1 one-hot with
    # already-bf16 sums — the f32 upcast happens inside the reduction
    texel = dc_pix + jnp.stack(
        [
            jnp.sum(
                (sums[:, ch * n_slots:(ch + 1) * n_slots] * oh).astype(
                    jnp.float32),
                axis=1,
            )
            for ch in range(3)
        ],
        axis=1,
    )
    # Per-texture glyph handling, keyed on the trailing coefficient:
    #   gain < 0  -> Fourier-SDF glyph (textures.fit_sdf_texture): the
    #     channel contraction above produced [sdf | ink | bg] per
    #     pixel; threshold the reconstructed signed distance with edge
    #     half-width w = -1/(2*gain) for binary-crisp strokes.
    #   gain > 1  -> legacy contrast expansion away from dc.
    #   gain == 1 -> identity (all non-glyph textures).
    # ``has_gain`` is a static flag (any glyph row in the table) so
    # glyph-free env classes skip the extra contraction entirely.
    if has_gain:
        gain = dcg[:, 3:4]
        # SDF edge half-width, in texels: the static fit width, grown
        # with the PIXEL FOOTPRINT under minification. The AA
        # attenuation turns the reconstructed SDF into its local mean
        # over the footprint, and thresholding a mean at a fixed
        # width makes distant glyphs collapse to mid-gray (every
        # pixel lands inside the widened apparent edge); scaling the
        # width with the footprint instead recovers COVERAGE — the
        # box-filtered glyph a mip-mapped renderer would show — so
        # small on-screen glyphs stay legible. The 0.55 factor is the
        # argmax of the native-scale classification oracle
        # (tests/test_render.py): swept 0.3-0.8, 8/8 glyphs classify
        # at 8/12/16 px with the best self-correlation at 0.55
        # (0.5 left one 8 px E misread as R; sharper widths alias,
        # wider ones blur).
        w0 = -1.0 / (2.0 * jnp.minimum(gain, -1e-9))
        if footprint is not None:
            from miniworld_tpu.render.textures import ATLAS_RES

            w_eff = jnp.maximum(w0, 0.55 * footprint[:, None] * ATLAS_RES)
        else:
            w_eff = w0
        s = jnp.clip(0.5 + texel[:, 0:1] / (2.0 * w_eff), 0.0, 1.0)
        sdf_texel = texel[:, 1:2] + (texel[:, 2:3] - texel[:, 1:2]) * s
        texel = jnp.where(gain < 0.0, sdf_texel, texel)
        texel = jnp.where(
            gain > 1.0, dcg[:, 0:3] + (texel - dcg[:, 0:3]) * gain, texel
        )
    textured = slot_i >= 0
    return jnp.where(textured[:, None], jnp.clip(texel, 0.0, 1.0), 1.0)


def eval_nearest(atlas: jax.Array, tex_map: jax.Array, slot: jax.Array,
                 uv: jax.Array):
    """Exact nearest-neighbor GL_REPEAT sampling (gather-based).

    The bit-accurate texture path: used on CPU (tests, gym adapter
    rendering) where gathers are cheap. atlas (N,R,R,3) u8.
    """
    res = atlas.shape[1]
    slot_i = jnp.round(slot).astype(jnp.int32)
    atlas_idx = tex_map[jnp.maximum(slot_i, 0)]
    frac = uv - jnp.floor(uv)
    tx = jnp.clip((frac[:, 0] * res).astype(jnp.int32), 0, res - 1)
    # v=0 is the image bottom in GL; atlas rows run top-down.
    ty = res - 1 - jnp.clip((frac[:, 1] * res).astype(jnp.int32), 0, res - 1)
    flat = atlas.reshape(-1, 3)
    lin = (atlas_idx * res + ty) * res + tx
    texel = flat[lin].astype(jnp.float32) * (1.0 / 255.0)
    return jnp.where((slot_i >= 0)[:, None], texel, 1.0)


def entity_mesh_rows(bank, layout_id, state, fourier: bool):
    """World-space triangle rows of every dynamic mesh entity:
    (verts (E*M, 3, 3), attrs (E*M, ATTR_DIM)).

    Each SHAPE_MESH_TRIS prototype carries its decimated LOCAL-space
    triangle rows (scene/entities._mesh_tri_rows); per frame every
    entity's rows are rotated/scaled/translated to world space (vmapped
    over the few entity slots) and concatenated into one block.
    Deactivated rows collapse to degenerate geometry (no hit).

    ``fourier``: translate the layout-local texture slot column to the
    shared-atlas index (mesh textures have a single variant) so the
    merged attr feeds eval_fourier; the nearest path keeps local slots
    (eval_nearest resolves them through state.tex_map).
    """
    num_ents = state.ent_pos.shape[0]
    proto_shape = bank.proto_shape[layout_id]
    proto_static = bank.proto_static[layout_id]
    proto_height = bank.proto_height[layout_id]
    proto_colorable = bank.proto_colorable[layout_id]
    tex_base = bank.tex_slot_base[layout_id].astype(jnp.float32)

    def world_rows(e):
        """One entity's rows in world space: verts (M,3,3), attrs
        (M, ATTR_DIM)."""
        p = state.ent_proto[e]
        rows = bank.proto_mesh[layout_id, p]  # (M, 25)
        rmask = bank.proto_mesh_mask[layout_id, p]
        active = (
            state.ent_alive[e]
            & ~proto_static[p]
            & (proto_shape[p] == SHAPE_MESH_TRIS)
        )
        su = state.ent_height[e] / jnp.maximum(proto_height[p], 1e-9)
        pos = state.ent_pos[e]
        cd, sd = jnp.cos(state.ent_dir[e]), jnp.sin(state.ent_dir[e])
        col_x = jnp.stack([cd, 0.0, -sd])
        col_y = jnp.array([0.0, 1.0, 0.0])
        col_z = jnp.stack([sd, 0.0, cd])

        def rot(a):  # (..., 3) local row vectors -> R a
            return (
                a[..., 0:1] * col_x
                + a[..., 1:2] * col_y
                + a[..., 2:3] * col_z
            )

        verts = rot(rows[:, 0:9].reshape(-1, 3, 3)) * su + pos  # (M,3,3)
        # local-UV rows compose as A_w = R a / su, b_w = b - A_w . pos
        inv_su = 1.0 / jnp.maximum(su, 1e-9)
        a1 = rot(rows[:, 9:12]) * inv_su
        a2 = rot(rows[:, 12:15]) * inv_su
        b1 = rows[:, 15] - matmul_f32(a1, pos)
        b2 = rows[:, 16] - matmul_f32(a2, pos)
        nrm = rot(rows[:, 17:20])
        slot = rows[:, 23]
        if fourier:
            slot_i = jnp.maximum(jnp.round(slot).astype(jnp.int32), 0)
            slot = jnp.where(slot >= 0.0, tex_base[slot_i], -1.0)
        # colorable protos (boxes) tint their white rows with the
        # entity's episode color, obj_color_bias included
        # (entity.py:405-432)
        color = rows[:, 20:23] * jnp.where(
            proto_colorable[p], state.ent_color[e], jnp.ones(3)
        )
        # ATTR_DIM order: [A(6) | b(2) | nrm(3) | col(3) | slot | one]
        attrs = jnp.concatenate(
            [a1, a2, b1[:, None], b2[:, None], nrm, color,
             slot[:, None], rows[:, 24:25]],
            axis=1,
        )
        # deactivated rows collapse to degenerate geometry (no hit)
        valid = rmask & active
        verts = jnp.where(valid[:, None, None], verts, 0.0)
        return verts, attrs

    verts, attrs = jax.vmap(world_rows)(jnp.arange(num_ents))
    verts = verts.reshape(-1, 3, 3)  # (E*M, 3, 3)
    attrs = attrs.reshape(-1, ATTR_DIM)
    return verts, attrs


def _entity_mesh_pass(bank, layout_id, state, origin, rays, fourier: bool,
                      attr_dtype=jnp.bfloat16):
    """Intersect dynamic mesh-entity rows (entity_mesh_rows) in one
    pass — no per-entity scan, no carry selects. Returns (t (HW,),
    attr (HW, ATTR_DIM)) normalized, ready to seed the static chunk
    scan's carry (render_rgbd feeds it as the scan init, so the
    z-merge with static geometry is the scan's own closer-select —
    zero extra merge ops or layout copies)."""
    fwd, right, up, xv, yv = rays
    hw = xv.shape[0]
    verts, attrs = entity_mesh_rows(bank, layout_id, state, fourier)

    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0
    e2 = verts[:, 2] - v0
    s = origin[None, :] - v0
    g_det = jnp.cross(e2, e1)
    g_u = jnp.cross(e2, s)
    g_v = jnp.cross(s, e1)
    t_num = jnp.sum(e2 * g_v, axis=-1)
    # reciprocal-depth competition, like _tri_pass: one per-row
    # reciprocal instead of a per-(row, pixel) divide
    inv_tnum = jnp.where(
        t_num > 0.0, 1.0 / jnp.where(t_num > 0.0, t_num, 1.0), 0.0
    )

    def contract(g):
        # separable rays, like _tri_pass: per-row basis dots (explicit
        # FMAs — minor-axis K=3 reductions lower pathologically) + 2
        # FMAs per (row, pixel)
        a = g[:, 0] * fwd[0] + g[:, 1] * fwd[1] + g[:, 2] * fwd[2]
        b = g[:, 0] * right[0] + g[:, 1] * right[1] + g[:, 2] * right[2]
        c = g[:, 0] * up[0] + g[:, 1] * up[1] + g[:, 2] * up[2]
        return (
            a[:, None] + b[:, None] * xv[None, :] + c[:, None] * yv[None, :]
        )

    det = contract(g_det)  # (E*M, HW)
    u_num = contract(g_u)
    v_num = contract(g_v)
    r = det * inv_tnum[:, None]  # = 1/t
    hit = (
        (det > 1e-12)
        & (u_num >= 0.0)
        & (v_num >= 0.0)
        & (u_num + v_num <= det)
        & (r < 1.0 / NEAR)
        & (r > 1.0 / FAR)
    )
    # Keyed z-competition, like _tri_pass: the winner's row index rides
    # the low mantissa bits of r, making the winner UNIQUE per pixel —
    # coincident-row ties resolve to the larger row index (GL z-fight
    # ties are order-dependent too), with no tie-normalize divide.
    assert r.shape[0] <= (1 << _IDX_BITS), r.shape
    rkey = jax.lax.bitcast_convert_type(r, jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (r.shape[0], 1), 0)
    key = jnp.where(hit, (rkey & ~_IDX_MASK) | idx, 0)
    key_max = jnp.max(key, axis=0)  # (HW,)
    ohf = (
        (idx == (key_max & _IDX_MASK)[None, :]) & (key_max > 0)[None, :]
    ).astype(jnp.float32)
    r_best = jax.lax.bitcast_convert_type(key_max & ~_IDX_MASK, jnp.float32)
    t_min = jnp.where(key_max > 0, 1.0 / jnp.maximum(r_best, 1e-30),
                      jnp.inf)
    sel = _select_rows(ohf, attrs, attr_dtype)  # (HW, ATTR_DIM)
    return t_min, sel


def _entity_pass(bank, layout_id, state, origin, rays,
                 shapes_present=(True, True, True)):
    """Analytic intersection for sphere (Ball) and box entities,
    vectorized over the entity slots in ONE pass.

    Dynamic meshes render as real triangles in _entity_mesh_pass;
    boxes also join it when a world runs that pass anyway (see
    box_proto / scene/compile.py) — here the analytic OBB serves
    box-only scenes. Spheres stay analytic always (the source ball
    meshes are tessellated spheres, entity.py:445-452).

    Every slot's hit test runs as (E, HW) broadcast work (no per-slot
    scan carrying (HW,) buffers), the winner is picked with the keyed-z
    index pack (unique, no tie handling), and the winner's normal is
    reconstructed once per pixel from one-hot-resolved entity
    parameters.
    """
    has_sphere, has_box, _ = shapes_present
    fwd, right, up, xv, yv = rays
    hw = xv.shape[0]
    E = state.ent_pos.shape[0]

    proto = state.ent_proto  # (E,)
    shape = bank.proto_shape[layout_id][proto]
    static = bank.proto_static[layout_id][proto]
    active = state.ent_alive & ~static  # (E,)
    is_sphere = shape == SHAPE_SPHERE
    is_box = shape == SHAPE_BOX

    pos = state.ent_pos  # (E, 3)
    height = state.ent_height  # (E,)
    size = state.ent_size  # (E, 3)

    def ray_dot(v):
        """v . d for per-entity vectors v (E, 3) -> (E, HW), via the
        separable ray decomposition (2 FMAs per (entity, pixel))."""
        a = v[:, 0] * fwd[0] + v[:, 1] * fwd[1] + v[:, 2] * fwd[2]
        b = v[:, 0] * right[0] + v[:, 1] * right[1] + v[:, 2] * right[2]
        c = v[:, 0] * up[0] + v[:, 1] * up[1] + v[:, 2] * up[2]
        return a[:, None] + b[:, None] * xv[None, :] + c[:, None] * yv[None, :]

    # |d|^2 per pixel: the camera basis is orthonormal
    a_px = (1.0 + xv * xv + yv * yv)[None, :]  # (1, HW)

    # --- spheres (Ball) ---
    if has_sphere:
        zeros_e = jnp.zeros_like(height)
        center = pos + jnp.stack([zeros_e, 0.5 * height, zeros_e], axis=1)
        r_vis = 0.5 * height  # (E,)
        oc = origin[None, :] - center  # (E, 3)
        b = 2.0 * ray_dot(oc)  # (E, HW)
        cc = jnp.sum(oc * oc, axis=1) - r_vis * r_vis  # (E,)
        disc = b * b - (4.0 * cc)[:, None] * a_px
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t_sph = (-b - sq) / (2.0 * a_px)
        sph_hit = (disc > 0.0) & (t_sph > NEAR) & (t_sph < FAR)
    else:
        t_sph = jnp.full((E, hw), jnp.inf, jnp.float32)
        sph_hit = jnp.zeros((E, hw), bool)

    # box frame (shared with the normal reconstruction below)
    cd, sd = jnp.cos(state.ent_dir), jnp.sin(state.ent_dir)  # (E,)
    zero = jnp.zeros_like(cd)
    ax_x = jnp.stack([cd, zero, -sd], axis=1)  # (E, 3)
    ax_z = jnp.stack([sd, zero, cd], axis=1)
    o_rel = origin[None, :] - pos  # (E, 3)
    o_l = jnp.stack(
        [jnp.sum(o_rel * ax_x, axis=1), o_rel[:, 1],
         jnp.sum(o_rel * ax_z, axis=1)],
        axis=1,
    )  # (E, 3) ray origin in each box's local frame
    lo = jnp.stack([-size[:, 0] * 0.5, zero, -size[:, 2] * 0.5], axis=1)
    hi = jnp.stack([size[:, 0] * 0.5, size[:, 1], size[:, 2] * 0.5], axis=1)

    # --- oriented boxes (analytic OBB; drawBox extents,
    # entity.py:409-432) ---
    if has_box:
        d_ly = (fwd[1] + xv * right[1] + yv * up[1])[None, :]  # (1, HW)
        d_l = (ray_dot(ax_x), d_ly, ray_dot(ax_z))
        t_lo, t_hi_l = [], []
        for k in range(3):
            dk = d_l[k]
            inv = 1.0 / jnp.where(jnp.abs(dk) < 1e-9, 1e-9, dk)
            t1 = (lo[:, k:k + 1] - o_l[:, k:k + 1]) * inv
            t2 = (hi[:, k:k + 1] - o_l[:, k:k + 1]) * inv
            t_lo.append(jnp.minimum(t1, t2))
            t_hi_l.append(jnp.maximum(t1, t2))
        t_in = jnp.maximum(jnp.maximum(t_lo[0], t_lo[1]), t_lo[2])
        t_out = jnp.minimum(jnp.minimum(t_hi_l[0], t_hi_l[1]), t_hi_l[2])
        box_hit = (t_in <= t_out) & (t_in > NEAR) & (t_in < FAR)
    else:
        t_in = jnp.full((E, hw), jnp.inf, jnp.float32)
        box_hit = jnp.zeros((E, hw), bool)

    t_e = jnp.where(is_sphere[:, None], t_sph, t_in)
    hit_e = active[:, None] & jnp.where(
        is_sphere[:, None], sph_hit, box_hit & is_box[:, None]
    )

    # keyed-z winner over the slot axis (unique per pixel)
    assert E <= (1 << _IDX_BITS), E
    r_e = jnp.where(hit_e, 1.0 / jnp.maximum(t_e, 1e-30), 0.0)
    rkey = jax.lax.bitcast_convert_type(r_e, jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (E, 1), 0)
    key = jnp.where(hit_e & (r_e > 0.0), (rkey & ~_IDX_MASK) | idx, 0)
    key_max = jnp.max(key, axis=0)  # (HW,)
    any_hit = key_max > 0
    ohf = (
        (idx == (key_max & _IDX_MASK)[None, :]) & any_hit[None, :]
    ).astype(jnp.float32)  # (E, HW)
    r_best = jax.lax.bitcast_convert_type(key_max & ~_IDX_MASK, jnp.float32)
    t_best = jnp.where(any_hit, 1.0 / jnp.maximum(r_best, 1e-30), jnp.inf)

    # winner color via one one-hot dot. HIGHEST: K is the slot count
    # (<= 18) and N = 3, so full f32 costs nothing measurable; TF32
    # would round colours by <= 2^-11, under 1/8 of a u8 level.
    col_best = jax.lax.dot_general(
        ohf, state.ent_color,
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (HW, 3)

    # Normals per (entity, pixel) component, selected by the one-hot
    # reduce over the leading slot axis — everything stays (E, HW)
    # elementwise work that XLA fuses into the reduction (a
    # winner-params + per-pixel-reconstruction variant materialized
    # ~25 extra (HW,) f32 streams and was slower on another chip).
    if has_sphere:
        # n = (oc + t*d) / r_vis, componentwise with separable d
        inv_rv = 1.0 / jnp.maximum(r_vis, 1e-9)  # (E,)
        t_s = jnp.where(sph_hit, t_sph, 0.0)
        d_x = (fwd[0] + xv * right[0] + yv * up[0])[None, :]
        d_y = (fwd[1] + xv * right[1] + yv * up[1])[None, :]
        d_z = (fwd[2] + xv * right[2] + yv * up[2])[None, :]
        ns_x = (oc[:, 0:1] + t_s * d_x) * inv_rv[:, None]
        ns_y = (oc[:, 1:2] + t_s * d_y) * inv_rv[:, None]
        ns_z = (oc[:, 2:3] + t_s * d_z) * inv_rv[:, None]
    if has_box:
        # entry-slab one-hot per (entity, pixel), like the reference
        # OBB pass: slab k wins when its t_lo equals t_in
        slab = [(t_lo[k] == t_in).astype(jnp.float32) for k in range(3)]
        norm = 1.0 / jnp.maximum(slab[0] + slab[1] + slab[2], 1.0)
        slab = [s * norm for s in slab]
        sign = -jnp.sign(
            slab[0] * d_l[0] + slab[1] * d_l[1] + slab[2] * d_l[2]
        )
        nb_x = sign * (slab[0] * ax_x[:, 0:1] + slab[2] * ax_z[:, 0:1])
        nb_y = sign * slab[1]
        nb_z = sign * (slab[0] * ax_x[:, 2:3] + slab[2] * ax_z[:, 2:3])
    if has_sphere and has_box:
        sph_e = is_sphere[:, None]
        n_x = jnp.where(sph_e, ns_x, nb_x)
        n_y = jnp.where(sph_e, ns_y, nb_y)
        n_z = jnp.where(sph_e, ns_z, nb_z)
    elif has_sphere:
        n_x, n_y, n_z = ns_x, ns_y, ns_z
    else:
        n_x, n_y, n_z = nb_x, nb_y, nb_z
    n_best = jnp.stack(
        [jnp.sum(ohf * n_x, axis=0), jnp.sum(ohf * n_y, axis=0),
         jnp.sum(ohf * n_z, axis=0)],
        axis=1,
    )  # (HW, 3)
    return t_best, col_best, n_best


def shade(color, normal, hit_p, state):
    """GL fixed-function lighting: one positional light + ambient.

    fragment = base * clamp(global_amb + light_ambient
                            + light_color * max(n . L, 0))
    (glLightfv setup at miniworld.py:1114-1133; GL_MODULATE texturing.)
    """
    l_vec = state.light_pos[None, :] - hit_p
    l_dir = l_vec / jnp.maximum(jnp.linalg.norm(l_vec, axis=1, keepdims=True), 1e-9)
    ndotl = jnp.maximum(jnp.sum(normal * l_dir, axis=1), 0.0)
    lit = (
        GL_GLOBAL_AMBIENT
        + state.light_ambient[None, :]
        + state.light_color[None, :] * ndotl[:, None]
    )
    return color * jnp.clip(lit, 0.0, 1.0)


def render_rgbd(
    bank,
    state,
    tex,
    *,
    width: int,
    height: int,
    tri_chunk: int = 128,
    with_depth: bool = True,
    shapes_present=(True, True, True),
    chunk_vis=None,
    sched_len: int | None = None,
    pvs_packed: bool = False,
    domain_rand: bool = False,
    supersample: int = 1,
    procgen: bool = False,
    all_quads: bool = False,
):
    """Render one env's observation. Returns (rgb u8 (H,W,3), depth (H,W,1)).

    ``bank`` is a Layout pytree with a leading layout axis; the env's
    layout is selected by ``state.layout_id``. ``tex`` is the texture
    pack from MiniWorldVec: {"mode": "fourier"|"nearest", "coeffs" or
    "atlas", "k"}. Depth is eye-space Z in meters, FAR for sky —
    matching FrameBuffer.get_depth_map semantics (opengl.py:400-435).

    ``chunk_vis`` ((L, n_chunks, R) bool) + ``sched_len`` enable PVS
    chunk culling (the vector layer precomputes both; rendering stays
    pixel-identical — only provably-invisible chunks are skipped).

    ``pvs_packed=True`` + ``sched_len`` instead reads the bank's packed
    per-room PVS copies (bank.pvs_verts9/pvs_attr, built by
    vector.plan_packed_pvs): the schedule is simply the camera room's
    contiguous chunk range — each env scans exactly its own visible
    set, with no bin-packing slack. Texture-variant randomization
    resolves chunk-wise from the packed pvs_tri_tex* tables, so the
    per-episode state is index-space-agnostic (just the scalar key).

    ``domain_rand`` (static) activates the per-episode variant draws
    keyed on ``state.tri_slots`` (a () u32 key); off, every slot
    renders variant 0 like the reference with rand_params absent.

    ``procgen`` (static): the bank is a single super layout
    (scene/supermaze.py) and ``state.wall_open`` holds this episode's
    wall bitmask; per-env triangle activity is one matvec against the
    bank's static one-hot and rides the scan's per-triangle reciprocal.

    ``supersample=2`` renders a 2x2 ordered grid per pixel and
    box-filters the shaded color down — the edge-anti-aliasing analog
    of the reference's 8x MSAA observation buffer (opengl.py:219-261;
    texture-interior AA is already covered by the frequency-space
    filter in eval_fourier). Depth keeps the top-left sample (a mean
    across an edge would invent depths no surface has). ~4x render
    cost; off by default.
    """
    ss = int(supersample)
    width, height = width * ss, height * ss
    layout_id = state.layout_id
    origin = geom.cam_position(
        state.pos, state.dir, state.cam_height, state.cam_fwd_disp
    )
    rays = camera_grid(state, width, height)  # separable decomposition
    fwd, right, up, xv, yv = rays
    # per-pixel directions, for hit-point reconstruction and the
    # analytic entity pass
    dirs = (
        fwd[None, :] + xv[:, None] * right[None, :] + yv[:, None] * up[None, :]
    )

    attr_dtype = attr_carry_dtype(tex, state)
    sched = None
    if pvs_packed:
        room = room_of_point(bank, layout_id, origin[jnp.array([0, 2])])
        base = bank.pvs_room_base[layout_id, room]
        sched = base + jnp.arange(sched_len, dtype=jnp.int32)
    elif chunk_vis is not None:
        sched = chunk_schedule(bank, chunk_vis, layout_id, origin, sched_len)
    seed = None
    if shapes_present[2]:
        # dynamic mesh triangles compete in the SAME (t, attr) stream
        # as static geometry (full texture evaluation included): their
        # pass result seeds the static scan's carry, making the z-merge
        # the scan's own closer-select
        seed = _entity_mesh_pass(
            bank, layout_id, state, origin, rays,
            fourier=tex["mode"] == "fourier", attr_dtype=attr_dtype,
        )
    if pvs_packed:
        v9_bank, at_bank = bank.pvs_verts9, bank.pvs_attr
        tex_banks = (bank.pvs_tri_tex, bank.pvs_tri_tex_base,
                     bank.pvs_tri_tex_count)
    else:
        v9_bank, at_bank = bank.tri_verts9, bank.tri_attr
        tex_banks = (bank.tri_tex, bank.tri_tex_base, bank.tri_tex_count)
    # fourier + domain_rand: per-episode variant draws resolve
    # chunk-wise from the scalar key. fourier without domain_rand: the
    # atlas base is already baked into the attr slot column
    # (MiniWorldVec.__init__), so no override runs at all. nearest:
    # the slot column stays the slot id, resolved through tex_map in
    # eval_nearest.
    use_key = tex["mode"] == "fourier" and domain_rand
    chunk_rows = None
    if pvs_packed and bank.pvs_v9_rows is not None and not use_key:
        # one-hot chunk read (see _tri_pass.read_chunk); the
        # dr-override path still slices pvs_tri_tex* itself, so it
        # keeps the dynamic_slice read
        ncl = bank.pvs_v9_rows.shape[0] // bank.pvs_verts9.shape[0]
        chunk_rows = (bank.pvs_v9_rows, bank.pvs_attr_rows, ncl)
    tri_active = None
    paired = None
    if procgen:
        if bank.pg_verts9 is not None:
            # Paired super bank (Layout.pg_*): the scan runs over
            # Sp = cells + 4*walls rows, selecting each wall slot's
            # live variant per env (use_primary = base + open @ K,
            # exact 0/1) — 27% fewer rows than the dense bank and no
            # inactive ones.
            use_p = (
                bank.pg_sel_base[0]
                + matmul_f32(state.wall_open, bank.pg_sel_onehot[0])
            )
            paired = (use_p, bank.pg_verts9_alt, bank.pg_attr_alt,
                      bank.pg_tex)
            v9_bank, at_bank = bank.pg_verts9, bank.pg_attr
            tex_banks = None  # the paired read resolves tex via pg_tex
        else:
            # (S,) f32, exact 0/1: active = base + open @ K (signed K:
            # -1 at closed-wall quads, +1 at junction content; see
            # scene/compile.Layout procgen fields)
            tri_active = (
                bank.tri_active_base[0]
                + matmul_f32(state.wall_open, bank.tri_wall_onehot[0])
            )
    t_tri, attr = _tri_pass(
        v9_bank, at_bank, layout_id, origin, rays, tri_chunk,
        slot_key=state.tri_slots if use_key else None,
        tex_banks=tex_banks if use_key else None,
        dr_active=domain_rand,
        chunk_sched=sched, init=seed, tri_active=tri_active,
        chunk_rows=chunk_rows, attr_dtype=attr_dtype,
        all_quads=all_quads, paired=paired,
    )
    has_analytic = shapes_present[0] or shapes_present[1]
    if has_analytic:
        # analytic spheres/boxes compete after texture evaluation
        t_ent, col_ent, n_ent = _entity_pass(
            bank, layout_id, state, origin, rays, shapes_present
        )

    # UV from the affine texture map at the triangle hit point
    t_uv = jnp.where(jnp.isfinite(t_tri), t_tri, 0.0)
    hit_tri_p = origin[None, :] + t_uv[:, None] * dirs
    uv = (
        jnp.stack(
            [
                jnp.sum(attr[:, 0:3] * hit_tri_p, axis=1),
                jnp.sum(attr[:, 3:6] * hit_tri_p, axis=1),
            ],
            axis=1,
        )
        + attr[:, _BMAP]
    )
    if tex["mode"] == "fourier":
        # The slot column already carries this episode's per-tri ATLAS
        # index (tri_slots override above), so the texture table is the
        # full atlas, shared by every env — no per-env table gather, and
        # per-(room, role) variant randomization costs nothing here.
        coeffs_env = tex["coeffs"]
        # uv-space pixel footprint ~ hit distance x pixel angle x the
        # texture map's scale (norm of the affine rows)
        pix_angle = jnp.tan(jnp.deg2rad(state.cam_fov_y) * 0.5) * (2.0 / height)
        amap_scale = jnp.sqrt(
            jnp.sum(attr[:, 0:6].astype(jnp.float32) ** 2, axis=1) * 0.5
        )
        footprint = t_uv * pix_angle * amap_scale
        texel = eval_fourier(
            coeffs_env, attr[:, _SLOT], uv, tex["k"], footprint,
            has_gain=tex.get("has_gain", True),
        )
    else:
        texel = eval_nearest(tex["atlas"], state.tex_map, attr[:, _SLOT], uv)
    tri_color = attr[:, _COL] * texel
    tri_normal = attr[:, _NRM]

    if has_analytic:
        ent_wins = t_ent < t_tri
        t_hit = jnp.where(ent_wins, t_ent, t_tri)
        color = jnp.where(ent_wins[:, None], col_ent, tri_color)
        normal = jnp.where(ent_wins[:, None], n_ent, tri_normal)
    else:
        t_hit, color, normal = t_tri, tri_color, tri_normal

    hit = jnp.isfinite(t_hit)
    t_safe = jnp.where(hit, t_hit, FAR)
    hit_p = origin[None, :] + t_safe[:, None] * dirs
    shaded = shade(color, normal, hit_p, state)
    rgb = jnp.where(hit[:, None], shaded, state.sky_color[None, :])
    rgb = rgb.reshape(height, width, 3)
    depth = t_safe.reshape(height, width, 1)
    if ss > 1:
        rgb = rgb.reshape(height // ss, ss, width // ss, ss, 3).mean(
            axis=(1, 3)
        )
        depth = depth[::ss, ::ss]
    rgb_u8 = jnp.clip(rgb * 255.0, 0.0, 255.0).astype(jnp.uint8)

    if with_depth:
        return rgb_u8, depth
    return rgb_u8, None
