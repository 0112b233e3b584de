"""On-device per-reset maze generation (recursive-backtracker).

The reference builds a fresh recursive-backtracking maze every reset
(miniworld/envs/maze.py:100-149): a DFS from cell (0,0) that shuffles
the 4 neighbor directions per cell and opens the wall to each
yet-unvisited neighbor it recurses into. The batched engine needs the same
*distribution* under jit+vmap with a fixed op budget, so this module
implements the iterative form: a stack-based DFS that, at the top cell,
picks uniformly among the *currently unvisited* neighbors.

Distribution equivalence (tested in tests/test_procgen.py): in the
recursive form, when control returns to a cell, the unconsumed suffix
of its direction permutation is a uniform permutation of the remaining
directions, so the next direction taken is uniform over the remaining
*unvisited* neighbors — exactly what the iterative form samples.

Maze topology: ``rows x cols`` cells; wall ids number the
``rows*(cols-1)`` horizontal walls (between (i,j) and (i,j+1), id =
i*(cols-1)+j) then the ``(rows-1)*cols`` vertical walls (between (i,j)
and (i+1,j), id = H + i*cols + j). A generated maze opens exactly
``rows*cols - 1`` walls (spanning tree).

Device notes: the loop is a ``lax.scan`` over exactly ``2*N - 1`` steps
(each step pushes a new cell or pops — a DFS over N cells does N-1
pushes and N pops). All dynamic indexing is one-hot compare/contract,
a choice made for another chip, whose gathers cost more than the whole
generator; not yet measured on the GPU (ROADMAP A1).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def num_walls(rows: int, cols: int) -> int:
    return rows * (cols - 1) + (rows - 1) * cols


def hwall_id(i: int, j: int, cols: int) -> int:
    """Wall between (i, j) and (i, j+1)."""
    return i * (cols - 1) + j


def vwall_id(i: int, j: int, rows: int, cols: int) -> int:
    """Wall between (i, j) and (i+1, j)."""
    return rows * (cols - 1) + i * cols + j


def wall_cells(rows: int, cols: int) -> np.ndarray:
    """(W, 2) i32: the two cell indices each wall separates."""
    out = []
    for i in range(rows):
        for j in range(cols - 1):
            out.append((i * cols + j, i * cols + j + 1))
    for i in range(rows - 1):
        for j in range(cols):
            out.append((i * cols + j, (i + 1) * cols + j))
    return np.asarray(out, dtype=np.int32)


def neighbor_tables(rows: int, cols: int):
    """Static (N, 4) neighbor cell ids and wall ids (-1 = off-grid).

    Direction order [+x, -x, +z, -z] (east, west, south, north in grid
    terms); the order is irrelevant to the distribution (the pick is
    uniform over valid entries).
    """
    n = rows * cols
    nbr_cell = np.full((n, 4), -1, dtype=np.int32)
    nbr_wall = np.full((n, 4), -1, dtype=np.int32)
    for i in range(rows):
        for j in range(cols):
            c = i * cols + j
            if j + 1 < cols:
                nbr_cell[c, 0] = c + 1
                nbr_wall[c, 0] = hwall_id(i, j, cols)
            if j - 1 >= 0:
                nbr_cell[c, 1] = c - 1
                nbr_wall[c, 1] = hwall_id(i, j - 1, cols)
            if i + 1 < rows:
                nbr_cell[c, 2] = c + cols
                nbr_wall[c, 2] = vwall_id(i, j, rows, cols)
            if i - 1 >= 0:
                nbr_cell[c, 3] = c - cols
                nbr_wall[c, 3] = vwall_id(i - 1, j, rows, cols)
    return nbr_cell, nbr_wall


def gen_walls(key: jax.Array, rows: int, cols: int) -> jax.Array:
    """One maze: (W,) f32 in {0, 1}, 1 = wall open. Jittable/vmappable.

    Exactly ``2*rows*cols - 1`` scan steps; every dynamic index is a
    one-hot contract (no gathers). ``key`` may be a typed PRNG key or a
    () u32 subseed; the per-step choice uniforms are counter-based
    (ops/rng.py — jax.random's rolled threefry while-loops cost more
    than this whole generator when vmapped in the auto-reset path).
    """
    from miniworld_tpu.ops import rng as rng_ops

    n = rows * cols
    w = num_walls(rows, cols)
    nbr_cell_np, nbr_wall_np = neighbor_tables(rows, cols)
    nbr_cell = jnp.asarray(nbr_cell_np, jnp.float32)  # (N, 4)
    nbr_wall = jnp.asarray(nbr_wall_np, jnp.float32)
    iota_n = jnp.arange(n, dtype=jnp.int32)
    iota_w = jnp.arange(w, dtype=jnp.int32)

    if getattr(key, "dtype", None) == jnp.uint32:
        seed = key
    else:
        seed = rng_ops.cheap_seed(key)
    us = rng_ops.uniforms(seed, 2, (2 * n - 1,))

    def body(carry, u):
        visited, stack, sp, walls = carry
        done = sp <= 0
        # cur = stack[sp - 1] (one-hot read)
        pos_oh = iota_n == jnp.maximum(sp - 1, 0)
        cur = jnp.sum(jnp.where(pos_oh, stack, 0))
        cur_oh = (iota_n == cur).astype(jnp.float32)
        nbrs_f = cur_oh @ nbr_cell  # (4,)
        wids_f = cur_oh @ nbr_wall
        nbrs = nbrs_f.astype(jnp.int32)
        in_grid = nbrs >= 0
        # visited lookup for the 4 neighbors, one-hot contract
        nbr_oh = (
            (nbrs[:, None] == iota_n[None, :]) & in_grid[:, None]
        ).astype(jnp.float32)  # (4, N)
        nbr_vis = (nbr_oh @ visited) > 0.5
        cand = in_grid & ~nbr_vis  # unvisited neighbors
        k = jnp.sum(cand.astype(jnp.int32))
        # uniform pick among the k candidates
        pick = jnp.minimum(
            jnp.floor(u * k.astype(jnp.float32)).astype(jnp.int32),
            jnp.maximum(k - 1, 0),
        )
        c_i = cand.astype(jnp.int32)
        rank = jnp.stack([
            jnp.int32(0), c_i[0], c_i[0] + c_i[1], c_i[0] + c_i[1] + c_i[2],
        ])
        choose = cand & (rank == pick)
        nc = jnp.sum(jnp.where(choose, nbrs, 0))
        wid = jnp.sum(jnp.where(choose, wids_f.astype(jnp.int32), 0))

        advance = (k > 0) & ~done
        walls = jnp.where(advance & (iota_w == wid), 1.0, walls)
        visited = jnp.maximum(
            visited, (advance & (iota_n == nc)).astype(jnp.float32)
        )
        stack = jnp.where(advance & (iota_n == sp), nc, stack)
        sp = jnp.where(done, sp, jnp.where(advance, sp + 1, sp - 1))
        return (visited, stack, sp, walls), None

    init = (
        (iota_n == 0).astype(jnp.float32),  # visited
        jnp.zeros(n, jnp.int32),  # stack (cell 0 at slot 0)
        jnp.int32(1),  # sp
        jnp.zeros(w, jnp.float32),  # walls
    )
    (visited, _, sp, walls), _ = jax.lax.scan(body, init, us)
    return walls


# ---------------------------------------------------------------------------
# Host replicas (numpy) — oracles for the distribution/invariant tests.


def host_gen_walls(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """Numpy mirror of gen_walls (iterative DFS, uniform among
    currently-unvisited neighbors)."""
    n = rows * cols
    nbr_cell, nbr_wall = neighbor_tables(rows, cols)
    open_w = np.zeros(num_walls(rows, cols), bool)
    visited = np.zeros(n, bool)
    visited[0] = True
    stack = [0]
    while stack:
        c = stack[-1]
        cand = [
            (nbr_cell[c, d], nbr_wall[c, d])
            for d in range(4)
            if nbr_cell[c, d] >= 0 and not visited[nbr_cell[c, d]]
        ]
        if not cand:
            stack.pop()
            continue
        nc, wid = cand[int(rng.integers(len(cand)))]
        open_w[wid] = True
        visited[nc] = True
        stack.append(int(nc))
    return open_w


def ref_gen_walls(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """The reference's recursive shuffle, rng-consumption order and all
    (miniworld/envs/maze.py:100-149) — the distribution oracle."""
    import sys

    open_w = np.zeros(num_walls(rows, cols), bool)
    visited = set()
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, rows * cols * 8 + 100))
    try:
        def visit(i, j):
            # reference arg order: (i=col, j=row); kept here for a
            # faithful rng-consumption transcription
            visited.add((i, j))
            orders = [(0, 1), (0, -1), (-1, 0), (1, 0)]
            neighbors = []
            while len(neighbors) < 4:
                elem = orders[rng.choice(len(orders))]
                orders.remove(elem)
                neighbors.append(elem)
            for dj, di in neighbors:
                ni, nj = i + di, j + dj
                if nj < 0 or nj >= rows or ni < 0 or ni >= cols:
                    continue
                if (ni, nj) in visited:
                    continue
                if di == 0:  # vertical neighbor
                    open_w[vwall_id(min(j, nj), i, rows, cols)] = True
                else:
                    open_w[hwall_id(j, min(i, ni), cols)] = True
                visit(ni, nj)

        visit(0, 0)
    finally:
        sys.setrecursionlimit(old)
    return open_w


def maze_is_spanning_tree(open_w: np.ndarray, rows: int, cols: int) -> bool:
    """Connectivity + exact edge-count check (union-find)."""
    n = rows * cols
    if int(np.sum(open_w)) != n - 1:
        return False
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cells = wall_cells(rows, cols)
    for wid in np.where(open_w)[0]:
        a, b = cells[wid]
        ra, rb = find(int(a)), find(int(b))
        if ra == rb:
            return False  # cycle
        parent[ra] = rb
    return len({find(c) for c in range(n)}) == 1
