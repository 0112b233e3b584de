"""Device mesh + sharding helpers for multi-device data parallelism.

The reference has no distributed runtime at all (SURVEY.md §2.12: its
"multiple processes" claim is one env per OS process). Here the env
*batch* axis is the parallel axis: state pytrees are sharded over a 1-D
``data`` mesh axis spanning every device (on one host the cards are
joined all to all by NVLink, so one axis needs no topology), stepping
runs under ``shard_map`` with zero cross-env communication, and
collectives appear only in the learner (gradient ``pmean``): pick a
mesh, annotate shardings, let XLA insert collectives.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first n) local+global devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def init_multihost():
    """Join a multi-process run when one is configured; else a no-op.

    A run is configured by ``JAX_COORDINATOR_ADDRESS`` (host:port) with
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Any initialization
    error raises: a silent single-process fallback would train on a
    fraction of the batch.
    """
    address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not address:
        return

    def env_int(name):
        value = os.environ.get(name)
        return int(value) if value else None

    jax.distributed.initialize(
        coordinator_address=address,
        num_processes=env_int("JAX_NUM_PROCESSES"),
        process_id=env_int("JAX_PROCESS_ID"),
    )


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for batched env pytrees: batch axis over ``data``."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_batch(mesh: Mesh, tree):
    """Device-put a batched pytree with the env axis over the mesh."""
    s = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def replicate(mesh: Mesh, tree):
    r = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, r), tree)


def local_rows(draw, key, n_global: int, n_local: int):
    """This shard's rows of ``draw(key, n_global)``, inside shard_map.

    Per-env random draws are made over the GLOBAL batch and sliced, so
    an env's draw depends on its global index and not on how the batch
    is sharded: one device and four produce the same actions. (The
    draws are a few numbers per env, so drawing the whole batch on
    every device costs nothing measurable.)
    """
    start = jax.lax.axis_index(DATA_AXIS) * n_local
    return jax.lax.dynamic_slice_in_dim(
        draw(key, n_global), start, n_local, axis=0
    )
