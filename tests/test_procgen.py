"""Device-side per-reset maze generation (ops/mazegen, scene/supermaze).

The reference regenerates the maze every reset with a recursive
backtracker (miniworld/envs/maze.py:100-149). These tests check the
vectorized path end to end: the jittable generator's distribution matches the
reference's recursion, the super-bank render is pixel-equal to an
eager compile of the same wall bitmask, and physics/placement respect
the per-env bitmask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from miniworld_tpu import MiniWorldVec
from miniworld_tpu.envs.nav import MazeS3
from miniworld_tpu.ops import mazegen
from miniworld_tpu.scene import supermaze

W, H = 48, 36


# ---------------------------------------------------------------------------
# Generator invariants + distribution


def test_device_generator_spanning_trees():
    rows, cols = 4, 5
    gw = jax.jit(jax.vmap(lambda k: mazegen.gen_walls(k, rows, cols)))
    walls = np.asarray(gw(jax.random.split(jax.random.key(7), 64)))
    assert walls.shape == (64, mazegen.num_walls(rows, cols))
    assert set(np.unique(walls)) <= {0.0, 1.0}
    for w in walls:
        assert mazegen.maze_is_spanning_tree(w > 0.5, rows, cols)
    uniq = len({tuple(w.astype(int)) for w in walls})
    assert uniq >= 60, uniq  # 4x5 has >>64 spanning trees


def _degree_hist(walls, rows, cols, cell):
    """(M, 5) one-hot histogram rows of the cell's open-wall degree."""
    cells = mazegen.wall_cells(rows, cols)
    inc = (cells == cell).any(axis=1)
    deg = walls[:, inc].sum(axis=1).astype(int)
    return np.bincount(deg, minlength=5)


def test_device_matches_reference_distribution():
    """Per-wall open marginals + center-cell degree distribution of the
    device generator match the reference recursion
    (miniworld/envs/maze.py:100-149) within sampling tolerance."""
    rows, cols = 3, 3
    nw = mazegen.num_walls(rows, cols)
    m_dev, m_ref = 512, 4096
    gw = jax.jit(jax.vmap(lambda k: mazegen.gen_walls(k, rows, cols)))
    dev = np.asarray(gw(jax.random.split(jax.random.key(3), m_dev)))
    rng = np.random.default_rng(5)
    ref = np.stack([mazegen.ref_gen_walls(rng, rows, cols)
                    for _ in range(m_ref)]).astype(np.float64)

    p_dev, p_ref = dev.mean(axis=0), ref.mean(axis=0)
    # two-proportion z with Bonferroni-ish margin: sigma of the
    # difference is <= sqrt(.25/m_dev + .25/m_ref) ~= 0.023
    assert np.all(np.abs(p_dev - p_ref) < 5 * 0.023), (
        np.abs(p_dev - p_ref).max(), p_dev, p_ref)
    assert nw == 12 and abs(p_ref.mean() - 8 / 12) < 0.01  # 8 open of 12

    # joint structure probe: degree histogram of the center cell
    h_dev = _degree_hist(dev, rows, cols, 4) / m_dev
    h_ref = _degree_hist(ref, rows, cols, 4) / m_ref
    assert np.all(np.abs(h_dev - h_ref) < 0.09), (h_dev, h_ref)


def test_host_iterative_matches_reference():
    """The iterative host mirror (uniform over currently-unvisited
    neighbors) reproduces the recursion's wall marginals."""
    rows, cols = 3, 4
    m = 3000
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(2)
    a = np.stack([mazegen.host_gen_walls(rng_a, rows, cols)
                  for _ in range(m)]).mean(axis=0)
    b = np.stack([mazegen.ref_gen_walls(rng_b, rows, cols)
                  for _ in range(m)]).mean(axis=0)
    assert np.all(np.abs(a - b) < 5 * np.sqrt(0.5 / m)), np.abs(a - b).max()


# ---------------------------------------------------------------------------
# Super-bank render parity vs an eager compile of the same bitmask


@dataclasses.dataclass
class _FixedMaze(MazeS3):
    """MazeS3 with a frozen wall bitmask (the eager oracle).

    procgen_default must be overridden back to False: this spec IS the
    eager compile the super bank is checked against (the Maze family
    defaults to procgen since round 5)."""
    name: str = "FixedMazeS3"
    gym_id: str = "MiniWorld-FixedMazeS3-v0"
    num_layouts: int = 1
    open_w: tuple = ()
    procgen_default: bool = False

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        supermaze.populate_eager_maze(world, self, np.asarray(self.open_w))
        world.place(world.proto_id("box", "red"))
        world.place_agent()


def _fixed_pose(state, pos, d):
    b = state.pos.shape[0]
    return state.replace(
        pos=jnp.tile(jnp.asarray(pos, jnp.float32)[None], (b, 1)),
        dir=jnp.full((b,), d, jnp.float32),
        cam_pitch=jnp.zeros((b,), jnp.float32),
        ent_alive=jnp.zeros_like(state.ent_alive),
    )


def test_superbank_pixel_parity_vs_eager():
    open_w = mazegen.host_gen_walls(np.random.default_rng(11), 3, 3)
    spec = _FixedMaze(open_w=tuple(bool(x) for x in open_w))

    env_s = MiniWorldVec("MiniWorld-MazeS3-v0", num_envs=1, obs_width=W,
                         obs_height=H, procgen=True)
    env_e = MiniWorldVec(spec, num_envs=1, obs_width=W, obs_height=H)

    st_s, _ = env_s.reset(jax.random.key(0))
    st_e, _ = env_e.reset(jax.random.key(0))
    st_s = st_s.replace(wall_open=jnp.asarray(open_w, jnp.float32)[None])

    size, gap = 3.0, 0.25
    poses = [((1.5, 0.0, 1.5), 0.0),
             ((1.5, 0.0, 1.5), np.pi / 2),
             ((size + gap + 1.5, 0.0, size + gap + 1.5), np.pi),
             ((2 * (size + gap) + 1.5, 0.0, 1.5), -np.pi / 2),
             ((1.5, 0.0, 2 * (size + gap) + 1.5), 1.1)]
    for pos, d in poses:
        rgb_s, dep_s = env_s._render_jit(
            env_s._bank, env_s._atlas, _fixed_pose(st_s, pos, d))
        rgb_e, dep_e = env_e._render_jit(
            env_e._bank, env_e._atlas, _fixed_pose(st_e, pos, d))
        same = np.all(np.asarray(rgb_s) == np.asarray(rgb_e), axis=-1)
        frac = float(same.mean())
        # z-tie winners at coincident edges may differ between the two
        # triangle orderings; everything else must be bit-equal
        assert frac > 0.998, (pos, d, frac)
        dd = np.abs(np.asarray(dep_s) - np.asarray(dep_e))
        assert float(np.quantile(dd, 0.998)) < 1e-3, (pos, d)
        # Pin the residue: every rgb-differing
        # pixel must lie ON a depth-coincident surface pair — both
        # renders agree on depth there to within the keyed-z mantissa
        # quantum (~2^-13 relative) — so a real 3-pixel rendering bug
        # (wrong geometry => wrong depth) cannot hide inside the tie
        # allowance.
        diff = ~same
        if diff.any():
            ds = np.asarray(dep_s)[..., 0][diff]
            de = np.asarray(dep_e)[..., 0][diff]
            rel = np.abs(ds - de) / np.maximum(np.minimum(ds, de), 1e-6)
            assert float(rel.max()) < 2 ** -12, (pos, d, float(rel.max()))

    # sanity: a different bitmask changes the picture at the same pose
    open_w2 = mazegen.host_gen_walls(np.random.default_rng(12), 3, 3)
    assert np.any(open_w2 != open_w)
    st_s2 = st_s.replace(wall_open=jnp.asarray(open_w2, jnp.float32)[None])
    p0 = poses[0]
    r1, _ = env_s._render_jit(env_s._bank, env_s._atlas,
                              _fixed_pose(st_s, *p0))
    r2, _ = env_s._render_jit(env_s._bank, env_s._atlas,
                              _fixed_pose(st_s2, *p0))
    assert np.mean(np.asarray(r1) != np.asarray(r2)) > 0.01


def test_topview_junction_gating():
    """Closed walls' sealed junctions must vanish from the top view
    like the reference's never-built junction rooms."""
    from miniworld_tpu.render.topview import render_top_view

    open_w = mazegen.host_gen_walls(np.random.default_rng(21), 3, 3)
    spec = _FixedMaze(open_w=tuple(bool(x) for x in open_w))
    env_s = MiniWorldVec("MiniWorld-MazeS3-v0", num_envs=1, obs_width=W,
                         obs_height=H, procgen=True)
    env_e = MiniWorldVec(spec, num_envs=1, obs_width=W, obs_height=H)
    st_s, _ = env_s.reset(jax.random.key(0))
    st_e, _ = env_e.reset(jax.random.key(0))
    st_s = st_s.replace(wall_open=jnp.asarray(open_w, jnp.float32)[None])
    pose = ((1.5, 0.0, 1.5), 0.0)
    st_s, st_e = _fixed_pose(st_s, *pose), _fixed_pose(st_e, *pose)

    ext = (0.0, 3 * 3.25 - 0.25, 0.0, 3 * 3.25 - 0.25)
    one = lambda s: jax.tree.map(lambda x: x[0] if hasattr(x, "shape") and x.ndim > 0 else x, s)
    tex = lambda e: {"mode": "fourier", "coeffs": e._atlas, "k": e.fourier_k,
                     "has_gain": e._tex_has_gain}
    tv_s = np.asarray(render_top_view(
        env_s._bank, one(st_s), tex(env_s), width=96, height=96,
        extents=ext, render_agent=False))
    tv_e = np.asarray(render_top_view(
        env_e._bank, one(st_e), tex(env_e), width=96, height=96,
        extents=ext, render_agent=False))
    same = np.all(tv_s == tv_e, axis=-1)
    assert float(same.mean()) > 0.995, float(same.mean())


# ---------------------------------------------------------------------------
# Physics + placement against the per-env bitmask


def _cells_of(pos, rows, cols, size, gap):
    """(B,) cell index; gap strips attach to the lower cell."""
    j = np.clip((pos[:, 0] // (size + gap)).astype(int), 0, cols - 1)
    i = np.clip((pos[:, 2] // (size + gap)).astype(int), 0, rows - 1)
    return i * cols + j


def test_procgen_reset_positions_valid():
    """Agent and box spawn inside cells or OPEN junctions, never inside
    a sealed gap (room weights zero closed junctions,
    miniworld/miniworld.py:957-963)."""
    rows = cols = 3
    size, gap = 3.0, 0.25
    env = MiniWorldVec("MiniWorld-MazeS3-v0", num_envs=64, obs_width=24,
                       obs_height=18, procgen=True)
    state, _ = env.reset(jax.random.key(4))
    wo = np.asarray(state.wall_open) > 0.5

    def check(pos_xz, radius, env_i):
        x, z = float(pos_xz[0]), float(pos_xz[1])
        fx, fz = x % (size + gap), z % (size + gap)
        jx, iz = int(x // (size + gap)), int(z // (size + gap))
        in_gap_x, in_gap_z = fx > size, fz > size
        assert not (in_gap_x and in_gap_z), (x, z)  # corner void
        if in_gap_x:  # horizontal-wall junction between (iz,jx),(iz,jx+1)
            wid = mazegen.hwall_id(iz, jx, cols)
            assert wo[env_i, wid], (env_i, x, z)
        if in_gap_z:
            wid = mazegen.vwall_id(iz, jx, rows, cols)
            assert wo[env_i, wid], (env_i, x, z)

    pos = np.asarray(state.pos)
    for b in range(pos.shape[0]):
        check(pos[b, [0, 2]], 0.4, b)
        ep = np.asarray(state.ent_pos[b])
        alive = np.asarray(state.ent_alive[b])
        for e in range(ep.shape[0]):
            if alive[e]:
                check(ep[e, [0, 2]], 0.4, b)


def test_procgen_rollout_crosses_only_open_walls():
    """Cell transitions during a random-walk rollout only ever cross
    open walls; auto-reset regenerates a fresh bitmask."""
    rows = cols = 2
    size, gap = 3.0, 0.25
    b, steps = 8, 120
    env = MiniWorldVec("MiniWorld-MazeS2-v0", num_envs=b, obs_width=24,
                       obs_height=18, procgen=True)
    state, _ = env.reset(jax.random.key(9))
    wo0 = np.asarray(state.wall_open).copy()
    rng = np.random.default_rng(0)

    prev_cell = _cells_of(np.asarray(state.pos), rows, cols, size, gap)
    cells_tbl = mazegen.wall_cells(rows, cols)
    any_done = np.zeros(b, bool)
    crossings = 0
    for t in range(steps):
        actions = rng.integers(0, 3, size=b)  # turns + forward
        state, (obs, _), rew, done, info = env.step(state, jnp.asarray(actions))
        wo = np.asarray(state.wall_open) > 0.5
        cell = _cells_of(np.asarray(state.pos), rows, cols, size, gap)
        moved = cell != prev_cell
        for i in np.where(moved & ~np.asarray(done))[0]:
            pair = sorted((prev_cell[i], cell[i]))
            wid = np.where((cells_tbl[:, 0] == pair[0])
                           & (cells_tbl[:, 1] == pair[1]))[0]
            assert wid.size == 1, (prev_cell[i], cell[i])  # adjacent cells
            assert wo[i, wid[0]], (t, i, pair)
            crossings += 1
        any_done |= np.asarray(done)
        prev_cell = cell
    assert crossings > 0  # the walk actually explored
    # 2x2 has only 4 spanning trees, so any one env can re-roll the
    # same maze (p=1/4); across all done envs at least one must differ
    done_envs = np.where(any_done)[0]
    assert done_envs.size >= b  # time limit hit for everyone
    wo_now = np.asarray(state.wall_open)
    assert any(not np.array_equal(wo0[i], wo_now[i]) for i in done_envs)


def test_procgen_requires_maze_spec():
    with pytest.raises(ValueError):
        MiniWorldVec("MiniWorld-Hallway-v0", num_envs=1, procgen=True)
