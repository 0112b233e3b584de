"""Vectorized MiniWorld: thousands of envs under jit+vmap.

This is the batched execution engine the reference has no
counterpart for (its README's "multiple processes" is one env per OS
process; SURVEY.md §2.12): env state is a batched pytree, stepping is
``jit(vmap(step))``, resets happen on device (auto-reset included), and
observations come from the raycaster — no host round-trips in the hot
loop.

API (functional, gymnax-style):

    env = MiniWorldVec("MiniWorld-Hallway-v0", num_envs=1024)
    state, obs = env.reset(jax.random.key(0))
    state, obs, reward, done, info = env.step(state, actions)

On ``done`` the env auto-resets and ``obs`` is the first observation of
the new episode (the final pre-reset state is summarized in ``info``).
"""

from __future__ import annotations

import math
from dataclasses import fields as dc_fields
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from miniworld_tpu.envs.base import Ctx, EnvSpec
from miniworld_tpu.ops import physics, place as place_ops
from miniworld_tpu.render.raycast import hash01, render_rgbd
from miniworld_tpu.render.textures import FOURIER_TERMS, TextureCatalog
from miniworld_tpu.scene.compile import Layout, compile_world, stack_layouts
from miniworld_tpu.scene.world import World
from miniworld_tpu.state import EnvState, StepResult, tree_select

# Layout fields small enough to gather per env each step (everything
# except the triangle soup, which the renderer indexes chunk-wise).
_TRI_FIELDS = (
    "tri_verts", "tri_verts9", "tri_attr", "tri_uv", "tri_normal", "tri_tex",
    "tri_tex_base", "tri_tex_count", "tri_color", "tri_mask",
    "tri_room", "tri_is_room", "room_pvs",
    # collision arrays are never gathered per env: physics/placement
    # slice room-local (4, NS) packs from the bank instead of gathering
    # the full per-env (W, 2, 2) segment table
    "segs", "seg_mask", "room_segs",
    # procgen super-bank fields stay bank-indexed too
    "tri_wall", "tri_jwall", "tri_active_base", "tri_wall_onehot",
    "room_seg_wall",
)


_hash01 = hash01  # texture-variant draw hash; lives with its consumer


def build_bank(spec: EnvSpec, bank_seed: int = 0, tex_mode: str = "fourier",
               fourier_k: int | None = None,
               min_sizes: dict | None = None):
    """Compile the spec's layout bank + texture tables (host side).

    ``fourier_k=None`` resolves to the spec's ``fourier_k`` (glyph envs
    raise it for legibility) or the global FOURIER_TERMS default.
    ``min_sizes`` floors the bank's padded axis sizes (refresh path;
    see stack_layouts). Returns (bank, tex table, sizes dict).
    """
    from miniworld_tpu.scene.compile import natural_sizes

    if fourier_k is None:
        fourier_k = getattr(spec, "fourier_k", 0) or FOURIER_TERMS
    catalog = TextureCatalog()
    layouts = []
    seeds = np.random.SeedSequence(bank_seed).spawn(spec.num_layouts)
    for li in range(spec.num_layouts):
        world = World(catalog)
        world.agent_radius = spec.agent_radius
        spec.build(world, None, layout_rng=np.random.default_rng(seeds[li]),
                   layout_idx=li)
        layouts.append(compile_world(world, with_pvs=True))
    bank_np = stack_layouts(layouts, min_sizes=min_sizes)
    sizes = natural_sizes(layouts)
    if min_sizes:
        sizes = {k: max(v, min_sizes.get(k, 0)) for k, v in sizes.items()}
    if tex_mode == "fourier":
        tex_np = catalog.build_fourier(fourier_k)
    else:
        tex_np = catalog.build_atlas()
    return bank_np, tex_np, sizes


def build_super_bank(spec: EnvSpec, tex_mode: str = "fourier",
                     fourier_k: int | None = None):
    """Compile the spec's maze grid into a procgen super bank.

    One layout containing every wall variant (scene/supermaze.py);
    per-env episode geometry is generated ON DEVICE at reset
    (ops/mazegen.gen_walls) as a wall-open bitmask. Returns
    (bank, tex table, sizes dict) like build_bank.
    """
    from miniworld_tpu.ops import mazegen
    from miniworld_tpu.scene.compile import natural_sizes
    from miniworld_tpu.scene.supermaze import (
        compile_super_maze, finalize_super_bank,
    )

    if fourier_k is None:
        fourier_k = getattr(spec, "fourier_k", 0) or FOURIER_TERMS
    catalog = TextureCatalog()
    lay = compile_super_maze(spec, catalog)
    bank_np = stack_layouts([lay])
    bank_np = finalize_super_bank(
        bank_np, lay, mazegen.num_walls(spec.num_rows, spec.num_cols)
    )
    sizes = natural_sizes([lay])
    if tex_mode == "fourier":
        tex_np = catalog.build_fourier(fourier_k)
    else:
        tex_np = catalog.build_atlas()
    return bank_np, tex_np, sizes


def _to_device(bank_np: Layout) -> Layout:
    return jax.tree.map(jnp.asarray, bank_np)


# Fixed cost of one chunk-scan iteration expressed in triangle
# equivalents (carry read/write + attr matmul + per-iteration
# dynamic-slice/scalar stalls), used to pick the culling chunk size.
# Tuned on another chip, unmeasured on H100, see ROADMAP A6. Culling
# is pixel-exact, so the value only decides the schedule.
_CHUNK_OVERHEAD_TRIS = 56


def _round_up16(n: int) -> int:
    return -(-int(n) // 16) * 16


def _chunk_visibility(bank_np: Layout, chunk: int) -> np.ndarray:
    """(L, n_chunks, R) bool: chunk c needed when rendering from room r.

    Mirrors the scan's chunk mapping exactly (last chunk clamps to
    [S - chunk, S)). A chunk is needed from room r if it contains an
    always-visible triangle or any triangle of a room in PVS(r).
    """
    tri_room, tri_mask = bank_np.tri_room, bank_np.tri_mask
    pvs = bank_np.room_pvs
    num_layouts, S = tri_room.shape
    n_chunks = -(-S // chunk)
    R = pvs.shape[1]
    vis = np.zeros((num_layouts, n_chunks, R), dtype=bool)
    for li in range(num_layouts):
        for c in range(n_chunks):
            start = min(c * chunk, S - chunk)
            rooms = tri_room[li, start:start + chunk]
            rooms = rooms[tri_mask[li, start:start + chunk]]
            if (rooms == -1).any():
                vis[li, c, :] = True
                continue
            rset = np.unique(rooms[rooms >= 0])
            if len(rset):
                vis[li, c, :] = pvs[li][:, rset].any(axis=1)
    return vis


def _repad_for_chunks(bank_np: Layout, chunk: int) -> Layout:
    """Pad the bank's triangle axis to a multiple of ``chunk``.

    Aligned chunks let the render scan slice without clamping and view
    per-tri episode state as clean (n_chunks, chunk) rows
    (raycast._tri_pass). Padding rows are masked out.
    """
    import dataclasses as _dc

    S = bank_np.tri_mask.shape[1]
    S2 = -(-S // chunk) * chunk
    if S2 == S:
        return bank_np
    pad = S2 - S

    def p(arr, axis, fill):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, constant_values=fill)

    extra = {}
    if bank_np.tri_wall is not None:
        extra["tri_wall"] = p(bank_np.tri_wall, 1, -1)
        extra["tri_jwall"] = p(bank_np.tri_jwall, 1, -1)
        extra["tri_active_base"] = p(bank_np.tri_active_base, 1, 1.0)
        extra["tri_wall_onehot"] = p(bank_np.tri_wall_onehot, 2, 0.0)
    return _dc.replace(
        bank_np,
        tri_verts=p(bank_np.tri_verts, 1, 0.0),
        tri_verts9=p(bank_np.tri_verts9, 2, 0.0),
        tri_attr=p(bank_np.tri_attr, 1, 0.0),
        tri_uv=p(bank_np.tri_uv, 1, 0.0),
        tri_normal=p(bank_np.tri_normal, 1, 0.0),
        tri_tex=p(bank_np.tri_tex, 1, -1),
        tri_tex_base=p(bank_np.tri_tex_base, 1, -1.0),
        tri_tex_count=p(bank_np.tri_tex_count, 1, 1.0),
        tri_color=p(bank_np.tri_color, 1, 0.0),
        tri_mask=p(bank_np.tri_mask, 1, False),
        tri_room=p(bank_np.tri_room, 1, -2),
        tri_is_room=p(bank_np.tri_is_room, 1, False),
        **extra,
    )


def plan_culling(bank_np: Layout, chunk_cap: int):
    """Choose (chunk_vis, tri_chunk, sched_len) for PVS chunk culling.

    Tries chunk sizes and picks the one minimizing the modeled scan
    cost ``worst_case_active_chunks * (chunk + overhead)``; returns
    (None, chunk_cap, None) when full scans are at least as cheap
    (single-room scenes, open-air scenes, tiny banks).
    """
    pvs, room_mask = bank_np.room_pvs, bank_np.room_mask
    S = bank_np.tri_room.shape[1]
    full_k = min(chunk_cap, S)
    if all(pvs[li][np.ix_(m, m)].all()
           for li, m in enumerate(room_mask)):
        return None, full_k, None

    candidates = [k for k in (16, 32, 48, 64, 96, 128, 160, 192, 224, 256)
                  if k <= full_k] or [full_k]
    best = (None, full_k, None)
    # baseline: the full scan at its EFFECTIVE chunk (clamped to S —
    # using the raw cap here made a useless 2-chunk culling plan beat
    # a single-chunk full scan on MazeS3 once quads shrank S below it)
    best_cost = (-(-S // full_k)) * (full_k + _CHUNK_OVERHEAD_TRIS)
    for k in candidates:
        vis = _chunk_visibility(bank_np, k)
        # worst case over (layout, valid room) of active chunk count
        bound = 1
        for li in range(vis.shape[0]):
            counts = vis[li].sum(axis=0)[room_mask[li]]
            if counts.size:
                bound = max(bound, int(counts.max()))
        cost = bound * (k + _CHUNK_OVERHEAD_TRIS)
        if cost < best_cost:
            best_cost = cost
            best = (vis, k, bound)
    return best


def plan_packed_pvs(bank_np: Layout, chunk_cap: int,
                    max_bytes: int = 768 << 20,
                    force_k: int | None = None):
    """Plan packed per-room PVS banks (the space-time alternative to
    chunk_vis culling).

    chunk_vis culling visits every chunk CONTAINING a visible triangle;
    because a room's PVS is scattered over the bank (a maze corridor's
    visible set is a row segment plus a column segment — no 1-D
    triangle order keeps both contiguous), the worst-case schedule
    covers ~2x more triangles than the PVS itself (measured: Maze 8x8
    sched 6 x 96 = 576 tris vs a 326-tri worst-case PVS). Packing every
    room's visible set CONTIGUOUSLY (duplicating shared triangles, with
    identical visible-sets deduped) removes that slack: the schedule
    becomes ``room_base + arange(sched_len)``.

    Returns (packed dict | None, tri_chunk, sched_len, modeled_cost);
    None when a single region covers everything (no culling value) or
    the duplicated bank copies would exceed ``max_bytes`` (a budget
    tuned on another chip, unmeasured on H100, see ROADMAP A6).
    The duplicated copies are render-exact: the chunk scan's z/tie
    competition is partition-invariant (raycast._tri_pass).
    """
    pvs, room_mask = bank_np.room_pvs, bank_np.room_mask
    if all(pvs[li][np.ix_(m, m)].all() for li, m in enumerate(room_mask)):
        return None, chunk_cap, None, np.inf

    L, S = bank_np.tri_room.shape

    # Per-layout room triangle index lists + per-room visible sets
    # (shared across chunk-size candidates).
    layouts = []
    p_max = 1  # largest single visible set, in triangles
    for li in range(L):
        tri_room, mask = bank_np.tri_room[li], bank_np.tri_mask[li]
        glob = np.where((tri_room == -1) & mask)[0]
        rooms = np.where(room_mask[li])[0]
        tris_of = {r: np.where((tri_room == r) & mask)[0] for r in rooms}
        vsets = {}  # frozenset of visible rooms -> region id
        room_vset = {}
        for r in rooms:
            key = frozenset(np.where(pvs[li][r] & room_mask[li])[0].tolist())
            room_vset[r] = key
            vsets.setdefault(key, len(vsets))
            p_max = max(p_max, len(glob) + sum(len(tris_of[q]) for q in key))
        layouts.append((glob, rooms, tris_of, vsets, room_vset))

    if force_k is not None:  # refresh path: reuse the planned chunk
        candidates = [force_k]
    else:
        # fixed ladder + the chunk sizes that cover the WORST visible
        # set in exactly 1 or 2 scan iterations: on the chip this was
        # tuned for, one big fused chunk beat several small ones
        # (per-iteration fixed costs rival the triangle math); tuned on
        # another chip, unmeasured on H100, see ROADMAP A6
        ladder = [32, 48, 64, 96, 128, 160, 192, 224, 256,
                  _round_up16(-(-p_max // 2)), _round_up16(p_max)]
        candidates = sorted({k for k in ladder
                             if 16 <= k <= min(chunk_cap, S)}) \
            or [min(chunk_cap, S)]

    best = (None, chunk_cap, None, np.inf)
    for k in candidates:
        sched_len = 1
        s2_max = 0
        for glob, rooms, tris_of, vsets, room_vset in layouts:
            s2 = 0
            for key in vsets:
                n = len(glob) + sum(len(tris_of[r]) for r in key)
                n_chunks = max(-(-n // k), 1)
                sched_len = max(sched_len, n_chunks)
                s2 += n_chunks * k
            s2_max = max(s2_max, s2)
        cost = sched_len * (k + _CHUNK_OVERHEAD_TRIS)
        # bank copies: verts9(9f) + attr(16f) + tex id/base/count(3f)
        bytes_needed = L * s2_max * 28 * 4
        if cost < best[3] and bytes_needed <= max_bytes:
            best = (k, sched_len, s2_max, cost)

    if best[0] is None:
        return None, chunk_cap, None, np.inf
    k, sched_len, s2_max, cost = best

    R = bank_np.room_mask.shape[1]
    verts9 = np.zeros((L, 9, s2_max), np.float32)
    attr = np.zeros((L, s2_max, bank_np.tri_attr.shape[2]), np.float32)
    tri_tex = np.full((L, s2_max), -1, np.int32)
    tri_tex_base = np.full((L, s2_max), -1.0, np.float32)
    tri_tex_count = np.ones((L, s2_max), np.float32)
    room_base = np.zeros((L, R), np.int32)
    room_nchunks = np.ones((L, R), np.int32)
    for li, (glob, rooms, tris_of, vsets, room_vset) in enumerate(layouts):
        region_base = {}
        region_nchunks = {}
        pos = 0
        # room centers for near-to-far region ordering (the XLA scan
        # itself is order-invariant; near-to-far order is what an
        # occlusion early-out in a hand-written kernel would need)
        ra = bank_np.room_aabb[li]
        centers = np.stack(
            [(ra[:, 0] + ra[:, 1]) * 0.5, (ra[:, 2] + ra[:, 3]) * 0.5],
            axis=1,
        )
        for key, _rid in vsets.items():
            reps = [r for r in rooms if room_vset[r] == key]
            # Nearest-neighbor CHAIN from the representative room, not
            # a plain distance sort: rooms at equal radius ring the
            # representative, and a sort puts opposite sides of the
            # ring in consecutive chunks — their AABBs then span the
            # whole scene and no occlusion early-out or tile test could
            # ever fire. The chain keeps
            # consecutive rooms spatially contiguous (corridors pack
            # in walk order) while still starting at the camera's room.
            cur_pt = centers[reps[0]] if reps else centers[0]
            remaining = set(key)
            order = []
            while remaining:
                nxt = min(
                    remaining,
                    key=lambda r: (
                        float(np.sum((centers[r] - cur_pt) ** 2)), r,
                    ),
                )
                order.append(nxt)
                remaining.discard(nxt)
                cur_pt = centers[nxt]
            idx = np.concatenate(
                [glob] + [tris_of[r] for r in order]
            ).astype(np.int64) if (len(glob) or key) else np.zeros(0, np.int64)
            n_chunks = max(-(-len(idx) // k), 1)
            region_base[key] = pos // k
            region_nchunks[key] = n_chunks
            verts9[li, :, pos:pos + len(idx)] = bank_np.tri_verts9[li][:, idx]
            attr[li, pos:pos + len(idx)] = bank_np.tri_attr[li][idx]
            tri_tex[li, pos:pos + len(idx)] = bank_np.tri_tex[li][idx]
            tri_tex_base[li, pos:pos + len(idx)] = bank_np.tri_tex_base[li][idx]
            tri_tex_count[li, pos:pos + len(idx)] = bank_np.tri_tex_count[li][idx]
            pos += n_chunks * k
        for r in rooms:
            room_base[li, r] = region_base[room_vset[r]]
            room_nchunks[li, r] = region_nchunks[room_vset[r]]
    packed = dict(
        pvs_verts9=verts9, pvs_attr=attr, pvs_tri_tex=tri_tex,
        pvs_tri_tex_base=tri_tex_base, pvs_tri_tex_count=tri_tex_count,
        pvs_room_base=room_base, pvs_room_nchunks=room_nchunks,
    )
    return packed, k, sched_len, cost


def lay_view(bank: Layout, layout_id) -> Layout:
    """Per-env layout view: small fields gathered, triangle soup left
    as empty slices (the renderer indexes the bank chunk-wise instead —
    gathering (S,3,3) per env would blow memory at large S x B)."""
    out = {}
    for f in dc_fields(Layout):
        arr = getattr(bank, f.name)
        if arr is None:  # optional packed-PVS fields
            out[f.name] = None
        elif (f.name in _TRI_FIELDS or f.name.startswith("pvs_")
              or f.name.startswith("pg_")):
            out[f.name] = arr[0, :0]
        else:
            out[f.name] = arr[layout_id]
    return Layout(**out)


class MiniWorldVec:
    """Batched env over a compiled layout bank."""

    def __init__(
        self,
        spec: EnvSpec | str,
        num_envs: int,
        *,
        obs_width: int | None = None,
        obs_height: int | None = None,
        domain_rand: bool = False,
        bank_seed: int = 0,
        tri_chunk: int | None = None,  # None -> auto (largest allowed)
        with_depth: bool = True,
        place_budget: int | None = None,  # None -> spec.place_budget
        tex_mode: str = "fourier",
        fourier_k: int | None = None,
        supersample: int = 1,
        procgen: bool | None = None,  # None -> spec.procgen_default
        view: str = "agent",
    ):
        if isinstance(spec, str):
            from miniworld_tpu.envs import make_spec

            spec = make_spec(spec)
        self.spec = spec
        self.num_envs = num_envs
        self.obs_width = obs_width or spec.obs_width
        self.obs_height = obs_height or spec.obs_height
        self.domain_rand = domain_rand
        self.with_depth = with_depth
        self.place_budget = (
            spec.place_budget if place_budget is None else place_budget
        )
        # supersample=2: 2x2 ordered-grid edge AA (reference obs buffers
        # are 8x MSAA, opengl.py:219-261); ~4x render cost, opt-in
        assert supersample in (1, 2), supersample
        self.supersample = supersample
        hw = self.obs_width * self.obs_height * supersample ** 2
        self._hw = hw
        # Render micro-batching: serialize the render over sub-batches
        # of ~B' envs (lax.map) so working sets stay small while the
        # map iterates: B' ~ 1024 at 80x60 for box-only scenes, B' ~ 256
        # when the mesh-entity pass runs, whose (B', E*M, HW)
        # intermediates dominate. Tuned on another chip, unmeasured on
        # H100, see ROADMAP A6. The final value is set after the bank
        # install (it needs shapes_present); this provisional bound
        # only sizes the chunk cap below.
        eff_envs = min(num_envs, 1024)
        # Chunk-size cap: a runaway guard on the (B', HW, chunk) work
        # per scan iteration. The t/hit work fuses to (B', HW) outputs
        # (the largest real buffers are the (B', HW, 16) attr
        # resolves), so the cap sits far above any planned chunk.
        auto = int(4e10 / 4 / max(eff_envs * hw, 1))
        # full-scan chunk (user-tunable; None = the cap, i.e. as few
        # scan iterations as allowed — one whenever S fits, which also
        # takes _tri_pass's no-scan fast path). Fewer, larger chunks
        # were faster on the chip this was tuned for; tuned on another
        # chip, unmeasured on H100, see ROADMAP A6. The packed-PVS
        # planner explores up to _chunk_cap on its own either way.
        # 1024 = the z-key's index budget (raycast._IDX_BITS)
        self._chunk_cap = min((auto // 16) * 16 or 16, 1024)
        self.tri_chunk = max(
            16, min(tri_chunk or self._chunk_cap, self._chunk_cap)
        )
        self._chunk_vis = None  # set after the bank is compiled
        self._sched_len = None

        # view="top": per-step observations are the orthographic top
        # view with the agent marker, like the reference's view kwarg
        # (miniworld/miniworld.py:470, 524-526; _render_world routes
        # obs renders through render_top_view at 1147-1166)
        assert view in ("agent", "top"), view
        self.view = view
        assert tex_mode in ("fourier", "nearest"), tex_mode
        self.tex_mode = tex_mode
        if fourier_k is None:  # spec override, else global default
            fourier_k = getattr(spec, "fourier_k", 0) or FOURIER_TERMS
        self.fourier_k = fourier_k
        # Procgen mode: a fresh recursive-backtracker maze is generated
        # ON DEVICE at every reset (reference reset semantics,
        # miniworld/envs/maze.py:100-149) instead of cycling a compiled
        # layout bank. The bank becomes ONE super layout with every
        # wall variant; per-env geometry is the wall-open bitmask in
        # EnvState.wall_open (scene/supermaze.py, ops/mazegen.py).
        if procgen is None:
            procgen = spec.procgen_default  # Maze family: True (ref
            # reset semantics; envs/nav.py Maze.procgen_default)
        self.procgen = bool(procgen)
        if self.procgen:
            if not all(hasattr(spec, a) for a in
                       ("num_rows", "num_cols", "room_size", "gap_size")):
                raise ValueError(
                    f"procgen=True needs a maze-grid spec (num_rows/"
                    f"num_cols/room_size/gap_size); {spec.name} has none"
                )
            bank_np, tex_np, self._bank_sizes = build_super_bank(
                spec, tex_mode, fourier_k
            )
        else:
            bank_np, tex_np, self._bank_sizes = build_bank(
                spec, bank_seed, tex_mode, fourier_k
            )
        self._install_bank(bank_np, tex_np, fresh=True)

        # Final sub-batch size (see the note above): pixel budget
        # ~B' x 4800, scaled by the actual obs size. Tuned on another
        # chip, unmeasured on H100, see ROADMAP A6.
        px_budget = 1.25e6 if self._shapes_present[2] else 5.0e6
        self.render_microbatch = 1
        while (
            num_envs % (self.render_microbatch * 2) == 0
            and (num_envs // self.render_microbatch) * hw > px_budget
        ):
            self.render_microbatch *= 2

        if spec.discrete_actions is not None:
            self._action_table = jnp.asarray(spec.discrete_actions)
        else:
            self._action_table = None

        self._make_jits()

    def _install_bank(self, bank_np: Layout, tex_np, fresh: bool):
        """Plan culling, pack, and install a compiled layout bank.

        ``fresh=True`` (construction) picks the cheaper culling mode by
        modeled cost. ``fresh=False`` (refresh_layouts) re-runs the
        SAME decisions with the same chunk size and pads the new bank
        to at least the previous shapes, so the swapped-in arrays reuse
        every compiled program (bank/atlas are jit arguments).
        """
        import dataclasses as _dc

        tex_mode, domain_rand = self.tex_mode, self.domain_rand
        statics_changed = False
        if fresh:
            # PVS chunk culling (scene/pvs.py): per-env scans visit only
            # the chunks visible from the camera's room, with a static
            # worst-case schedule length. Exact — culled renders are
            # pixel-identical.
            self._pvs_packed = False
            _, chunks_k, chunks_bound = plan_culling(bank_np, self.tri_chunk)
            chunks_cost = (
                chunks_bound * (chunks_k + _CHUNK_OVERHEAD_TRIS)
                if chunks_bound is not None
                else (-(-bank_np.tri_mask.shape[1] // chunks_k))
                * (chunks_k + _CHUNK_OVERHEAD_TRIS)
            )
            packed, packed_k, packed_sched, packed_cost = (
                plan_packed_pvs(bank_np, self._chunk_cap)
            )
            if packed is not None and packed_cost < chunks_cost:
                # packed per-room PVS mode: duplicated contiguous
                # visible sets; schedule = room_base + arange
                self.tri_chunk = packed_k
                bank_np = _repad_for_chunks(bank_np, self.tri_chunk)
                bank_np = _dc.replace(bank_np, **packed)
                self._pvs_packed = True
                self._sched_len = packed_sched
            else:
                s_nat = bank_np.tri_mask.shape[1]
                # never pad the bank BEYOND its natural triangle count (a
                # 112-chunk on Hallway's 56 triangles would double the scan)
                self.tri_chunk = min(chunks_k, s_nat)
                # align chunks (and the per-tri state row view) to the bank
                trial = _repad_for_chunks(bank_np, self.tri_chunk)
                chunk_vis = _chunk_visibility(trial, self.tri_chunk)
                n_chunks = chunk_vis.shape[1]
                bound = 1
                for li in range(chunk_vis.shape[0]):
                    counts = chunk_vis[li].sum(axis=0)[trial.room_mask[li]]
                    if counts.size:
                        bound = max(bound, int(counts.max()))
                if bound < n_chunks:
                    bank_np = trial
                    self._chunk_vis = jnp.asarray(chunk_vis)
                    self._sched_len = bound
                else:
                    # repadding shifted chunk boundaries enough that the
                    # planned culling bound degraded to the full scan —
                    # take the largest-chunk full scan instead (fewest
                    # iterations; single chunk hits the no-scan path)
                    self.tri_chunk = min(self._chunk_cap, s_nat)
                    bank_np = _repad_for_chunks(bank_np, self.tri_chunk)
        elif self._pvs_packed:
            # refresh: same chunk size; pad region banks to the previous
            # packed size so shapes (and compiled programs) are reused.
            # A schedule slot past a room's region reads the next
            # region's real triangles — harmless under the z-buffer —
            # so a shorter new worst case keeps the old sched_len.
            packed, _, packed_sched, _ = plan_packed_pvs(
                bank_np, self.tri_chunk, force_k=self.tri_chunk
            )
            assert packed is not None, "refresh lost the packed-PVS plan"
            bank_np = _repad_for_chunks(bank_np, self.tri_chunk)
            prev_s2 = self._bank_np.pvs_attr.shape[1]
            new_s2 = packed["pvs_attr"].shape[1]
            if new_s2 < prev_s2:
                pad = prev_s2 - new_s2

                def p(arr, axis, fill):
                    widths = [(0, 0)] * arr.ndim
                    widths[axis] = (0, pad)
                    return np.pad(arr, widths, constant_values=fill)

                packed = dict(
                    packed,
                    pvs_verts9=p(packed["pvs_verts9"], 2, 0.0),
                    pvs_attr=p(packed["pvs_attr"], 1, 0.0),
                    pvs_tri_tex=p(packed["pvs_tri_tex"], 1, -1),
                    pvs_tri_tex_base=p(packed["pvs_tri_tex_base"], 1, -1.0),
                    pvs_tri_tex_count=p(packed["pvs_tri_tex_count"], 1, 1.0),
                )
            bank_np = _dc.replace(bank_np, **packed)
            if packed_sched > self._sched_len:
                # worst-case schedule grew: sched_len is baked into the
                # jitted programs as a static, so they must retrace
                self._sched_len = packed_sched
                statics_changed = True
        else:
            bank_np = _repad_for_chunks(bank_np, self.tri_chunk)
            if self._chunk_vis is not None:
                chunk_vis = _chunk_visibility(bank_np, self.tri_chunk)
                bound = 1
                for li in range(chunk_vis.shape[0]):
                    counts = chunk_vis[li].sum(axis=0)[bank_np.room_mask[li]]
                    if counts.size:
                        bound = max(bound, int(counts.max()))
                self._chunk_vis = jnp.asarray(chunk_vis)
                self._sched_len = max(self._sched_len, bound)
                # chunk_vis is a trace-time closure constant, not a jit
                # argument — the compiled programs must be rebuilt
                statics_changed = True
        if tex_mode == "fourier" and not domain_rand:
            # Without domain_rand every slot renders variant 0, so the
            # per-tri atlas index is static: bake it into the attr slot
            # column now and the render scan skips the override splice
            # (no extra tex-bank slices in read_chunk, no per-chunk
            # concat). raycast.render_rgbd only engages slot_key when
            # domain_rand is set.
            import dataclasses as _dc

            ta = bank_np.tri_attr.copy()
            ta[:, :, 14] = bank_np.tri_tex_base
            repl = {"tri_attr": ta}
            if self._pvs_packed:
                pa = bank_np.pvs_attr.copy()
                pa[:, :, 14] = bank_np.pvs_tri_tex_base
                repl["pvs_attr"] = pa
            if bank_np.pg_attr is not None:
                # paired procgen bank: both variants' slot columns get
                # their atlas bases (pg_tex rows [v][1])
                pga = bank_np.pg_attr.copy()
                pga[:, :, 14] = bank_np.pg_tex[:, 0, 1]
                pgaa = bank_np.pg_attr_alt.copy()
                pgaa[:, :, 14] = bank_np.pg_tex[:, 1, 1]
                repl["pg_attr"] = pga
                repl["pg_attr_alt"] = pgaa
            bank_np = _dc.replace(bank_np, **repl)
        if self._pvs_packed:
            # Chunk-row views for the one-hot chunk read (built AFTER
            # the attr-slot baking above so rows match what a
            # dynamic_slice would see). f32 + HIGHEST-precision dot in
            # the scan keeps vertex coordinates and (nearest-mode)
            # slot ids exact.
            L, _, S2 = bank_np.pvs_verts9.shape
            k = self.tri_chunk
            nc = S2 // k
            v9r = np.ascontiguousarray(
                bank_np.pvs_verts9.reshape(L, 9, nc, k)
                .transpose(0, 2, 1, 3).reshape(L * nc, 9 * k)
            )
            atr = np.ascontiguousarray(
                bank_np.pvs_attr.reshape(L, nc, k, -1).reshape(L * nc, -1)
            )
            bank_np = _dc.replace(
                bank_np, pvs_v9_rows=v9r, pvs_attr_rows=atr
            )
        self._bank_np = bank_np
        self._bank = _to_device(bank_np)
        # "atlas" carries whichever texture table the mode needs:
        # fourier -> (N, 3+8K) coefficients; nearest -> (N,R,R,3) u8.
        # Slot indices ride the attr rows in bf16 only while they are
        # exact bf16 integers (<= 256); bigger tables automatically
        # fall back to an f32 attr carry (raycast.attr_carry_dtype) —
        # slower streams, never wrong ids.
        self._atlas = jnp.asarray(tex_np)
        # static: does any texture carry a glyph marker (SDF mode,
        # gain < 0, or a legacy contrast gain > 1)? Skips the per-pixel
        # glyph contraction for glyph-free env classes.
        self._tex_has_gain = bool(
            tex_mode == "fourier"
            and ((tex_np[:, -1] > 1.0) | (tex_np[:, -1] < 0.0)).any()
        )

        # static: every REAL prim a parallelogram? (maze/room banks
        # are; the render scan then skips the kind blend entirely)
        self._all_quads = bool(
            (bank_np.tri_attr[:, :, 15][bank_np.tri_mask] == 0.0).all()
        )
        self.num_layouts = bank_np.tri_verts.shape[0]
        self.num_ent_slots = bank_np.slot_protos.shape[1]
        # static shape-presence flags let the renderer skip whole
        # entity-intersection branches for env classes without them
        from miniworld_tpu.scene.entities import (
            SHAPE_BOX, SHAPE_MESH_BOX, SHAPE_MESH_TRIS, SHAPE_SPHERE,
        )
        shp = bank_np.proto_shape
        self._shapes_present = (
            bool((shp == SHAPE_SPHERE).any()),
            bool(((shp == SHAPE_BOX) | (shp == SHAPE_MESH_BOX)).any()),
            bool((shp == SHAPE_MESH_TRIS).any()),
        )
        if not fresh and statics_changed:
            self._make_jits()

    def _make_jits(self):
        # bank/atlas are jit ARGUMENTS (not closures) so they never
        # become embedded XLA constants.
        self._reset_jit = jax.jit(
            jax.vmap(self._reset_one, in_axes=(None, 0))
        )
        self._step_jit = jax.jit(
            jax.vmap(self._step_one, in_axes=(None, 0, 0))
        )
        self._render_jit = jax.jit(self._render_batch)
        self._rollout_cache = {}

    # -- layout-bank refresh ------------------------------------------------

    def prepare_bank(self, bank_seed: int):
        """Host-side compile of a fresh layout bank (thread-safe, no
        device work) — run it in a background thread and hand the
        result to install_bank to swap banks without stalling rollouts.
        """
        bank_np, tex_np, _ = build_bank(
            self.spec, bank_seed, self.tex_mode, self.fourier_k,
            min_sizes=self._bank_sizes,
        )
        return bank_np, tex_np

    def install_bank(self, prepared):
        """Swap in a bank from prepare_bank (main thread; touches jit
        state)."""
        bank_np, tex_np = prepared
        assert tex_np.shape == tuple(np.asarray(self._atlas).shape), (
            "refreshed texture table changed shape — the spec's texture "
            "set must be layout-independent for bank refreshes"
        )
        self._install_bank(bank_np, tex_np, fresh=False)

    def refresh_layouts(self, bank_seed: int):
        """Regenerate the procedural layout bank with fresh seeds.

        The reference builds a fresh world every reset
        (miniworld/miniworld.py:558-618; Maze generates a new
        recursive-backtracker maze per episode, maze.py:100-149). The
        vectorized path draws layouts from a compiled bank instead —
        calling this between rollouts makes the training distribution
        unbounded over time: each refresh swaps in ``num_layouts`` new
        layouts built from ``SeedSequence(bank_seed)``.

        Procgen mode already regenerates geometry every reset on
        device, so a refresh is a documented no-op there.

        The new bank is padded to the previous bank's shapes and reuses
        its culling plan (same chunk size/schedule), so when shapes are
        stable — they are for Maze, whose triangle/segment counts are
        layout-independent — no recompilation happens: the bank is just
        a new jit argument. In-flight episodes keep their layout_id but
        see the NEW layout's geometry, so refresh at episode/rollout
        boundaries (auto-reset makes mid-episode swaps safe, just
        discontinuous).
        """
        if self.procgen:
            return  # every reset already generates a fresh maze
        self.install_bank(self.prepare_bank(bank_seed))

    # -- param sampling ----------------------------------------------------

    def _sample_param(self, key, name):
        p = self.spec.params.params[name]
        if not self.domain_rand:
            return jnp.asarray(p.default, dtype=jnp.float32)
        lo = jnp.asarray(p.min, dtype=jnp.float32)
        hi = jnp.asarray(p.max, dtype=jnp.float32)
        return jax.random.uniform(
            key, np.shape(p.default), jnp.float32, minval=lo, maxval=hi
        )

    def _sample_param_u(self, u3, name):
        """Like _sample_param but from a (3,) counter-based uniform row
        (ops/rng.py) — the reset path's draw source (see ops/rng.py
        for why reset avoids jax.random)."""
        p = self.spec.params.params[name]
        if not self.domain_rand:
            return jnp.asarray(p.default, dtype=jnp.float32)
        lo = jnp.asarray(p.min, dtype=jnp.float32)
        hi = jnp.asarray(p.max, dtype=jnp.float32)
        shape = np.shape(p.default)  # () or (3,) (params.py)
        assert shape in ((), (3,)), (name, shape)
        uu = u3 if shape else u3[0]
        return lo + uu * (hi - lo)

    # -- reset -------------------------------------------------------------

    def _reset_one(self, bank: Layout, key: jax.Array) -> EnvState:
        """Reset one env. All reset-time draws are counter-based
        uniforms from ops/rng.py keyed on this reset key's data words
        (every step computes a reset for every env in the auto-reset
        path, so its draws should be cheap elementwise math; see
        ops/rng.py). Only the episode rng / spec hook keep real PRNG
        keys (one split)."""
        from miniworld_tpu.ops import rng as rng_ops

        spec = self.spec
        k_rng, k_post = jax.random.split(key)
        seed = rng_ops.cheap_seed(key)

        def u(purpose, shape=()):
            return rng_ops.uniforms(seed, purpose, shape)

        if self.num_layouts > 1:
            layout_id = jnp.minimum(
                jnp.floor(u(10, (1,))[0] * self.num_layouts),
                self.num_layouts - 1,
            ).astype(jnp.int32)
        else:
            layout_id = jnp.int32(0)
        lay = lay_view(bank, layout_id)

        # Procgen: generate this episode's maze on device — a fresh
        # wall-open bitmask per reset (reference reset semantics,
        # miniworld/envs/maze.py:100-149). Placement sees it as junction
        # room weights (closed-wall junctions don't exist,
        # miniworld/miniworld.py:957-963) + gated collision segments.
        wall_open = None
        room_weight = None
        seg_gate = None
        if self.procgen:
            from miniworld_tpu.ops import mazegen

            wall_open = mazegen.gen_walls(
                rng_ops.sub(seed, 17), self.spec.num_rows, self.spec.num_cols
            )
            rw = lay.room_wall  # (R,) i32: -1 = cell, w = junction of w
            w_oh = (
                rw[:, None]
                == jnp.arange(wall_open.shape[0], dtype=jnp.int32)[None, :]
            ).astype(jnp.float32)
            room_weight = jnp.where(rw < 0, 1.0, w_oh @ wall_open)
            seg_gate = (bank.room_seg_wall, wall_open)

        E = self.num_ent_slots
        # prototype choice per slot
        def pick(uu, choices):
            n = jnp.sum(choices >= 0)
            i = jnp.minimum(
                jnp.floor(uu * n).astype(jnp.int32), jnp.maximum(n - 1, 0)
            )
            return choices[i]

        ent_proto = jax.vmap(pick)(u(11, (E,)), lay.slot_protos)
        ent_proto = jnp.maximum(ent_proto, 0)

        size_mul = (
            lay.slot_size_lo
            + u(12, (E,)) * (lay.slot_size_hi - lay.slot_size_lo)
        )
        ent_size = lay.proto_size[ent_proto] * size_mul[:, None]
        ent_radius = lay.proto_radius[ent_proto] * size_mul
        ent_height = lay.proto_height[ent_proto] * size_mul

        # obj_color_bias per entity (entity.py:405-407)
        p_bias = spec.params.params["obj_color_bias"]
        if self.domain_rand:
            b_lo = jnp.asarray(p_bias.min, jnp.float32)
            b_hi = jnp.asarray(p_bias.max, jnp.float32)
            bias = b_lo + u(13, (E, 3)) * (b_hi - b_lo)
        else:
            bias = jnp.broadcast_to(jnp.asarray(p_bias.default, jnp.float32), (E, 3))
        colorable = lay.proto_colorable[ent_proto]
        ent_color = jnp.clip(
            lay.proto_color[ent_proto] + jnp.where(colorable[:, None], bias, 0.0),
            0.0, 1.0,
        )

        # placement alternative per slot
        n_alts = jnp.sum(lay.rule_mask, axis=1)  # (E+1,)
        u_alts = u(14, (E + 1,))
        alts = jnp.minimum(
            jnp.floor(u_alts * n_alts).astype(jnp.int32),
            jnp.maximum(n_alts - 1, 0),
        )

        # sequential placement (miniworld.py:922-992 order semantics);
        # per-slot u32 subseeds (row E = the agent)
        place_seeds = rng_ops.hash_u32(
            rng_ops.sub(seed, 18), jnp.arange(E + 1, dtype=jnp.uint32)
        )

        def place_body(carry, inp):
            ent_pos, ent_dir, placed = carry
            e, kk = inp
            alt = alts[e]
            pos, d = place_ops.place_one(
                kk, lay, bank.room_segs, layout_id,  # kk: u32 subseed
                lay.rule_room[e, alt], lay.rule_bbox[e, alt],
                lay.rule_pos[e, alt], lay.rule_dir[e, alt],
                lay.rule_dir_lo[e, alt], lay.rule_dir_hi[e, alt],
                ent_radius[e],
                ent_pos[:, jnp.array([0, 2])], ent_radius, placed,
                budget=self.place_budget,
                room_weight=room_weight, seg_gate=seg_gate,
            )
            valid = lay.slot_mask[e]
            ent_pos = ent_pos.at[e].set(jnp.where(valid, pos, 0.0))
            ent_dir = ent_dir.at[e].set(jnp.where(valid, d, 0.0))
            placed = placed.at[e].set(valid)
            return (ent_pos, ent_dir, placed), None

        init = (
            jnp.zeros((E, 3), jnp.float32),
            jnp.zeros((E,), jnp.float32),
            jnp.zeros((E,), bool),
        )
        # unroll: E is small (1-18); the sequential dependence is real
        # (each slot collides against the ones placed before it) but the
        # rolled while's per-iteration launch latency is not
        (ent_pos, ent_dir, placed), _ = jax.lax.scan(
            place_body, init, (jnp.arange(E), place_seeds[:E]), unroll=True
        )

        # agent placement (rule row E)
        agent_alt = alts[E]
        agent_pos, agent_dir = place_ops.place_one(
            place_seeds[E], lay, bank.room_segs, layout_id,
            lay.rule_room[E, agent_alt], lay.rule_bbox[E, agent_alt],
            lay.rule_pos[E, agent_alt], lay.rule_dir[E, agent_alt],
            lay.rule_dir_lo[E, agent_alt], lay.rule_dir_hi[E, agent_alt],
            jnp.float32(spec.agent_radius),
            ent_pos[:, jnp.array([0, 2])], ent_radius, placed,
            budget=self.place_budget,
            room_weight=room_weight, seg_gate=seg_gate,
        )

        # per-episode params (reset consumption; miniworld.py:586-599)
        pu = u(15, (8, 3))
        names = ["sky_color", "light_pos", "light_color", "light_ambient",
                 "cam_height", "cam_fwd_disp", "cam_pitch", "cam_fov_y"]
        (sky_color, light_pos, light_color, light_ambient, cam_height,
         cam_fwd_disp, cam_pitch, cam_fov_y) = (
            self._sample_param_u(pu[i], n) for i, n in enumerate(names)
        )

        # Texture variants (opengl.py:136-140): one independent draw per
        # (room, role) slot via a keyed hash of the slot id, resolved
        # both as the slot table (tex_map, for the nearest/top-view
        # paths) and per triangle (tri_slots, for the fourier renderer —
        # no per-pixel slot-table lookup).
        n_slots = lay.tex_slot_base.shape[0]
        if self.domain_rand:
            tkey = rng_ops.sub(seed, 16)
            u_var = _hash01(tkey, jnp.arange(n_slots, dtype=jnp.int32))
            offs = jnp.minimum(
                jnp.floor(
                    u_var * lay.tex_slot_count.astype(jnp.float32)
                ).astype(jnp.int32),
                lay.tex_slot_count - 1,
            )
        else:
            tkey = jnp.uint32(0)
            offs = jnp.zeros((n_slots,), jnp.int32)
        tex_map = lay.tex_slot_base + offs
        # per-tri variant resolution happens chunk-wise IN the render
        # scan from this scalar key (raycast.hash01) — no (B, S) table

        task = jax.tree.map(jnp.asarray, spec.init_task())
        state = EnvState(
            pos=agent_pos, dir=agent_dir,
            cam_pitch=cam_pitch, cam_height=cam_height,
            cam_fov_y=cam_fov_y, cam_fwd_disp=cam_fwd_disp,
            carrying=jnp.int32(-1),
            ent_pos=ent_pos, ent_dir=ent_dir,
            ent_alive=lay.slot_mask,
            ent_proto=ent_proto, ent_color=ent_color, ent_size=ent_size,
            ent_radius=ent_radius, ent_height=ent_height,
            step_count=jnp.int32(0), rng=k_rng, layout_id=layout_id,
            sky_color=sky_color, light_pos=light_pos,
            light_color=light_color, light_ambient=light_ambient,
            tex_map=tex_map, tri_slots=tkey, wall_open=wall_open,
            task=task,
        )
        return spec.post_reset(lay, state, k_post)

    # -- step ---------------------------------------------------------------

    def _step_one(self, bank: Layout, state: EnvState, action):
        spec = self.spec
        key, k_params, k_reset = jax.random.split(state.rng, 3)
        state = state.replace(rng=key, step_count=state.step_count + 1)
        prev = state

        pk = jax.random.split(k_params, 3)
        fwd_step = self._sample_param(pk[0], "forward_step")
        fwd_drift = self._sample_param(pk[1], "forward_drift")
        turn_step = self._sample_param(pk[2], "turn_step")

        lay = lay_view(bank, state.layout_id)
        # room-local wall pack for every collision query this step (the
        # agent's reach from its pre-step room is covered by REACH;
        # scene/compile._room_local_segs)
        from miniworld_tpu.render.raycast import room_of_point

        room = room_of_point(
            bank, state.layout_id, state.pos[jnp.array([0, 2])]
        )
        ns = bank.room_segs.shape[3]
        segs4 = jax.lax.dynamic_slice(
            bank.room_segs, (state.layout_id, room, 0, 0), (1, 1, 4, ns)
        )[0, 0]
        if self.procgen:
            # open walls' closed-quad segments stop colliding this
            # episode (codes -1 = always solid)
            codes = jax.lax.dynamic_slice(
                bank.room_seg_wall, (state.layout_id, room, 0), (1, 1, ns)
            )[0, 0]
            segs4 = place_ops.gate_segs4(segs4, codes, state.wall_open)

        if spec.override_physics:
            action_vec = jnp.zeros(6, jnp.float32)
            action_idx = (
                action.astype(jnp.int32) if action.ndim == 0 else jnp.int32(-1)
            )
            if action.ndim > 0:
                action_vec = action_vec.at[: action.shape[0]].set(action)
            state = spec.apply_action(lay, state, action)
            res = StepResult(
                moved=jnp.bool_(False),
                picked_up=jnp.int32(-1),
                dropped=jnp.int32(-1),
            )
        else:
            if self._action_table is not None and action.ndim == 0:
                action_idx = action.astype(jnp.int32)
                action_vec = self._action_table[action_idx]
            else:
                # raw 6-D vector actions always accepted (reference
                # keeps the Box space under discrete mappings,
                # miniworld.py:759-779)
                action_idx = jnp.int32(-1)
                action_vec = physics.clip_action(action.astype(jnp.float32))
            state, res = physics.physics_step(
                lay, state, action_vec,
                segs4=segs4,
                max_forward_step=spec.max_forward_step,
                fwd_step=fwd_step, fwd_drift=fwd_drift, turn_step=turn_step,
                agent_radius=spec.agent_radius,
            )

        truncated = state.step_count >= spec.max_episode_steps
        ctx = Ctx(
            lay=lay, prev=prev, state=state, res=res,
            action=action_vec, action_idx=action_idx, truncated=truncated,
            room_segs=bank.room_segs,
        )
        reward, term, state = spec.transition(ctx)
        reward = jnp.asarray(reward, jnp.float32)
        done = term | truncated

        info = {
            "agent_pos": state.pos,
            "agent_dir": state.dir,
            "cam_pitch": state.cam_pitch,
            "termination": term,
            "truncation": truncated,
        }
        info.update(spec.info(ctx))

        # on-device auto-reset (gymnax-style: obs comes from new episode)
        reset_state = self._reset_one(bank, k_reset)
        state = tree_select(done, reset_state, state)
        return state, reward, done, info

    # -- observation ----------------------------------------------------------

    def _obs_one(self, bank: Layout, atlas, state: EnvState):
        if self.tex_mode == "fourier":
            tex = {"mode": "fourier", "coeffs": atlas, "k": self.fourier_k,
                   "has_gain": self._tex_has_gain}
        else:
            tex = {"mode": "nearest", "atlas": atlas}
        if self.view == "top":
            # view="top" (miniworld.py:470, 1147-1166): the per-step
            # observation is the orthographic top view, agent marker
            # included
            from miniworld_tpu.render.topview import render_top_view

            lay = lay_view(bank, state.layout_id)
            out = render_top_view(
                bank, state, tex,
                width=self.obs_width, height=self.obs_height,
                extents=lay.extents, agent_radius=self.spec.agent_radius,
                render_agent=True, with_depth=self.with_depth,
            )
            rgb, depth = out if self.with_depth else (out, None)
            return self._wrap_obs_one(rgb, depth, state)
        use_sched = self._pvs_packed or self._chunk_vis is not None
        rgb, depth = render_rgbd(
            bank, state, tex,
            width=self.obs_width, height=self.obs_height,
            tri_chunk=self.tri_chunk, with_depth=self.with_depth,
            shapes_present=self._shapes_present,
            chunk_vis=self._chunk_vis,
            sched_len=self._sched_len if use_sched else None,
            pvs_packed=self._pvs_packed,
            domain_rand=self.domain_rand,
            supersample=self.supersample,
            procgen=self.procgen,
            all_quads=self._all_quads,
        )
        return self._wrap_obs_one(rgb, depth, state)

    def _wrap_obs_one(self, rgb, depth, state):
        rgb = self.spec.post_render(rgb, state)
        if self.spec.dict_obs:
            obs = {"obs": rgb, "goal": jnp.int32(self.spec.goal)}
        else:
            obs = rgb
        if self.with_depth:
            return obs, depth
        return obs, None

    def _render_batch(self, bank: Layout, atlas, state: EnvState):
        """Batched observation render (vmapped XLA raycaster)."""
        mb = self.render_microbatch
        if mb > 1:
            def sub(s):
                return jax.vmap(self._obs_one, in_axes=(None, None, 0))(
                    bank, atlas, s
                )

            parts = jax.tree.map(
                lambda x: x.reshape(mb, x.shape[0] // mb, *x.shape[1:]),
                state,
            )
            obs, depth = jax.lax.map(sub, parts)
            merge = lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
            return jax.tree.map(merge, obs), (
                jax.tree.map(merge, depth) if depth is not None else None
            )
        return jax.vmap(self._obs_one, in_axes=(None, None, 0))(
            bank, atlas, state
        )

    def visible_ents(self, state):
        """(B, E) bool visibility mask (get_visible_ents parity,
        miniworld/miniworld.py:1576-1670): per-pixel occlusion queries
        at the env's obs resolution, like the reference's obs_fb."""
        from miniworld_tpu.render.visibility import visible_ents

        if not hasattr(self, "_vis_jit"):
            fn = partial(visible_ents, width=self.obs_width,
                         height=self.obs_height)
            self._vis_jit = jax.jit(jax.vmap(fn, in_axes=(None, 0)))
        return self._vis_jit(self._bank, state)

    # -- public API -------------------------------------------------------------

    def reset(self, key: jax.Array):
        """Returns (state, obs) [obs includes depth when with_depth]."""
        keys = jax.random.split(key, self.num_envs)
        state = self._reset_jit(self._bank, keys)
        obs, depth = self._render_jit(self._bank, self._atlas, state)
        return state, (obs, depth) if self.with_depth else obs

    def step(self, state, actions):
        """Returns (state, obs, reward, done, info)."""
        state, reward, done, info = self._step_jit(self._bank, state, actions)
        obs, depth = self._render_jit(self._bank, self._atlas, state)
        obs_out = (obs, depth) if self.with_depth else obs
        return state, obs_out, reward, done, info

    def set_discrete_actions(self, discrete_actions):
        """Install (or remove, with None) a runtime discrete-action
        table, like the reference's MiniWorldEnv.set_discrete_actions
        (miniworld/miniworld.py:654-664). Each row is a 6-D action
        vector; scalar actions index into it. The jitted step/rollout
        programs bake the table in at trace time, so their caches are
        dropped here and retrace on the next call.
        """
        if discrete_actions is None:
            self._action_table = None
        else:
            table = jnp.asarray(discrete_actions, jnp.float32)
            assert table.ndim == 2 and table.shape[1] == 6, table.shape
            self._action_table = table
        # step/rollout programs close over the table via self; drop
        # compiled caches so the new table is traced in
        self._step_jit = jax.jit(
            jax.vmap(self._step_one, in_axes=(None, 0, 0))
        )
        self._rollout_cache = {}

    def sample_actions(self, key: jax.Array, num: int | None = None):
        """Random actions with the right dtype/shape for this env."""
        spec = self.spec
        n = self.num_envs if num is None else num
        if self._action_table is not None:
            return jax.random.randint(key, (n,), 0, self._action_table.shape[0])
        if getattr(spec, "num_actions", 0):
            return jax.random.randint(key, (n,), 0, spec.num_actions)
        if getattr(spec, "click_action", False):
            return jax.random.uniform(key, (n, 2))
        return jax.random.uniform(
            key, (n, 6),
            minval=jnp.array([-1, -1, -1, -1, 0, 0], jnp.float32),
            maxval=jnp.array([1, 1, 1, 1, 1, 1], jnp.float32),
        )

    # -- fused rollout ------------------------------------------------------

    def rollout_fn(self, horizon: int, *, policy=None,
                   return_obs: bool = False, return_actions: bool = False):
        """Build a jittable fused rollout: one XLA program scanning
        ``horizon`` env steps on device (step + render per step).

        This is the accelerator-idiomatic execution shape: dispatching
        one program per step leaves the device idle between host
        round-trips, while ``lax.scan`` keeps the whole trajectory on
        device (the reference has no analog — its loop is host-driven
        by construction, miniworld/manual_control.py:288-383).

        Args:
          horizon: steps per call.
          policy: optional ``(obs, depth, key) -> actions`` (batched);
            defaults to uniform-random actions in the env's space.
          return_obs: stack the observations the policy ACTED ON into
            the output (``outs["obs"][t]`` is the obs that produced
            ``actions[t]`` — the (s, a) alignment a learner needs;
            O(T*B*H*W) memory!). Otherwise obs are consumed on device
            and only per-step summaries are returned.
          return_actions: stack per-env per-step ``actions``,
            ``rewards`` and ``done_mask`` into the output (the rest of
            a learner's transition tuple).

        Returns:
          ``fn(bank, atlas, state, obs0, key) -> (state, metrics)``;
          jit it (optionally with shard_map over the env axis).
        """

        def random_policy(obs, depth, key):
            # batch size from obs (per-shard under shard_map)
            return self.sample_actions(key, jax.tree.leaves(obs)[0].shape[0])

        policy = policy or random_policy

        def fn(bank, atlas, state, obs, depth, key):
            def body(carry, key):
                state, obs, depth = carry
                k_act, _ = jax.random.split(key)
                actions = policy(obs, depth, k_act)
                acted_obs, acted_depth = obs, depth
                state, reward, done, info = jax.vmap(
                    self._step_one, in_axes=(None, 0, 0)
                )(bank, state, actions)
                obs, depth = self._render_batch(bank, atlas, state)
                # the IMAGE leaf: tree.leaves sorts dict keys, which
                # put Sign's scalar "goal" first and fed a (B,) array
                # to the pixel-sample checksum below
                rgb_leaf = obs["obs"] if isinstance(obs, dict) else obs
                out = {
                    "reward": jnp.sum(reward),
                    "dones": jnp.sum(done),
                    # obs checksum: forces rendering to be materialized
                    # even when observations aren't returned; a sparse
                    # pixel sample keeps the data dependency without
                    # paying a full-image reduction per step.
                    "obs_sum": jnp.sum(
                        rgb_leaf[:, ::8, ::8].astype(jnp.uint32)
                    ),
                }
                if return_obs:
                    out["obs"] = acted_obs
                    if self.with_depth:
                        out["depth"] = acted_depth
                if return_actions:
                    out["actions"] = actions
                    out["rewards"] = reward
                    out["done_mask"] = done
                return (state, obs, depth), out

            keys = jax.random.split(key, horizon)
            (state, obs, depth), outs = jax.lax.scan(
                body, (state, obs, depth), keys
            )
            return state, obs, depth, outs

        return fn

    def rollout(self, state, obs, key, horizon: int):
        """Run a fused ``horizon``-step random-policy rollout.

        ``obs`` is the (obs, depth) pair from reset/step. Returns
        (state, obs, metrics) with metrics summed per step.
        """
        if not hasattr(self, "_rollout_cache"):
            self._rollout_cache = {}
        if horizon not in self._rollout_cache:
            self._rollout_cache[horizon] = jax.jit(self.rollout_fn(horizon))
        fn = self._rollout_cache[horizon]
        o, d = obs if self.with_depth else (obs, None)
        state, o, d, outs = fn(self._bank, self._atlas, state, o, d, key)
        return state, (o, d) if self.with_depth else o, outs
