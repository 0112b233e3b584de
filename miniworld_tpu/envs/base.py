"""Environment specifications.

An ``EnvSpec`` is the jittable analog of a reference env class
(miniworld/envs/*.py): it declares the world builder, the action
interface, and the per-step task logic (reward / termination / state
edits) as pure functions over ``EnvState``. One spec serves both
execution paths:

  * vectorized (record-mode build -> compiled layout bank; task logic
    traced under jit+vmap), and
  * gymnasium adapter (eager-mode build with a numpy Generator,
    reproducing the reference's rng consumption order).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from miniworld_tpu.ops import geom, physics
from miniworld_tpu.params import DEFAULT_PARAMS, DomainParams
from miniworld_tpu.state import EnvState, StepResult


class Ctx(NamedTuple):
    """Inputs to a spec's transition function (all per-env, traced)."""

    lay: Any  # layout view: per-env gathered small arrays
    prev: EnvState  # state before physics
    state: EnvState  # state after physics
    res: StepResult
    action: jax.Array  # (6,) clipped continuous action
    action_idx: jax.Array  # () i32 discrete action index, or -1
    truncated: jax.Array  # () bool — step limit reached this step
    # bank-level (L, R, 4, NS) room-local wall packs (NOT per-env
    # gathered); task logic that re-places entities (CollectHealth
    # respawn) slices by (state.layout_id, room)
    room_segs: Any = None


def default_discrete_actions() -> np.ndarray:
    """turn-/turn+/fwd+/fwd-/strafe-/strafe+ (miniworld.py:642-652)."""
    acts = np.zeros((6, 6), dtype=np.float32)
    acts[0, 2] = -1.0  # turn left
    acts[1, 2] = +1.0  # turn right
    acts[2, 0] = +1.0  # forward
    acts[3, 0] = -1.0  # back
    acts[4, 1] = -1.0  # strafe left
    acts[5, 1] = +1.0  # strafe right
    return acts


def action_from_components(forward=0.0, strafe=0.0, turn=0.0, pitch=0.0,
                           pickup=0.0, drop=0.0) -> np.ndarray:
    """Action-vector builder (miniworld.py:620-640)."""
    return np.array([forward, strafe, turn, pitch, pickup, drop], dtype=np.float32)


@dataclass
class EnvSpec:
    """Base spec; concrete envs subclass and override hooks."""

    name: str = "Base"
    gym_id: str = ""
    max_episode_steps: int = 1500
    params: DomainParams = field(default_factory=lambda: DEFAULT_PARAMS)
    # (D, 6) table for discrete envs, None for the raw 6-D Box space
    discrete_actions: np.ndarray | None = None
    num_layouts: int = 1  # layout bank size (procedural envs > 1)
    obs_width: int = 80
    obs_height: int = 60
    # Sign wraps observations in {"obs": image, "goal": int}
    dict_obs: bool = False
    # CameraControl envs replace agent physics entirely
    override_physics: bool = False
    # Agent bounding radius (RoomObjects overrides to 1.5,
    # roomobjects.py:67; otherwise entity.py:470)
    agent_radius: float = 0.4
    # On-device placement retry budget (ops/place.py). Specs with low
    # per-try acceptance (large agent radius, dense rooms) raise it;
    # exhaustion falls back to an in-room clamped spawn.
    place_budget: int = 16
    # Fourier texture-table terms for this env class; 0 = the global
    # default (textures.FOURIER_TERMS). Glyph-bearing envs (Sign) raise
    # it: K=32 cannot carry legible handwritten strokes even as an SDF
    # (~64 real DOF), K=64 renders readable letters. The cost is paid
    # only by env classes that opt in.
    fourier_k: int = 0
    # MiniWorldVec(procgen=None) resolves to this: the Maze family
    # defaults to device-side per-reset maze generation (reference
    # reset semantics, miniworld/envs/maze.py:100-149); the compiled
    # layout bank remains the opt-in fast path (procgen=False).
    procgen_default: bool = False

    @property
    def max_forward_step(self) -> float:
        return float(self.params.get_max("forward_step"))

    # ---- world construction (override) --------------------------------

    def build(self, world, rng: np.random.Generator | None,
              layout_rng: np.random.Generator | None = None,
              layout_idx: int = 0):
        """Populate the world.

        ``rng`` is None in record mode; in eager mode builders must
        consume it exactly like the reference ``_gen_world``.
        ``layout_rng``/``layout_idx`` identify the bank entry for
        procedural geometry (Maze layouts, Sign color variants).
        """
        raise NotImplementedError

    # ---- optional hooks -------------------------------------------------

    def post_reset(self, lay, state: EnvState, key: jax.Array) -> EnvState:
        """Adjust freshly reset state (CameraControl wall setup)."""
        return state

    def post_render(self, rgb: jax.Array, state: EnvState) -> jax.Array:
        """Observation overlay hook (CameraControl crosshair)."""
        return rgb

    # ---- task logic (override as needed) ------------------------------

    def init_task(self) -> dict:
        """Initial per-episode task pytree (concrete values)."""
        return {}

    def transition(self, ctx: Ctx):
        """Returns (reward f32, termination bool, new_state).

        Runs after base physics each step — like env ``step`` overrides
        wrapping ``super().step`` in the reference.
        """
        return jnp.float32(0.0), jnp.bool_(False), ctx.state

    def apply_action(self, lay, state: EnvState, action: jax.Array) -> EnvState:
        """Custom physics for override_physics specs."""
        raise NotImplementedError

    def info(self, ctx: Ctx) -> dict:
        """Extra per-step info entries (traced arrays)."""
        return {}

    # ---- host-side (gymnasium adapter) hooks ---------------------------
    # Float64 numpy counterparts of the traced task logic, mirroring the
    # reference env step overrides exactly for bit-parity (gym_env.py).

    def host_reset(self, env, rng) -> dict:
        """Per-episode host task state; runs at the end of reset."""
        return {}

    def host_transition(self, env, action, reward, termination):
        """Reference env ``step`` override logic (after base physics)."""
        return reward, termination

    def host_info(self, env) -> dict:
        return {}

    def host_apply_action(self, env, action):
        """Custom physics for override_physics specs (host side)."""
        raise NotImplementedError

    def host_post_render(self, rgb: np.ndarray, env) -> np.ndarray:
        return rgb

    # ---- shared helpers ------------------------------------------------

    def reward(self, state: EnvState) -> jax.Array:
        """Sparse reward shape (miniworld.py:1095-1100)."""
        return 1.0 - 0.2 * (
            state.step_count.astype(jnp.float32) / self.max_episode_steps
        )

    def near(self, state: EnvState, idx0: int, idx1: int | None = None):
        return physics.near(
            state, idx0, idx1, max_forward_step=self.max_forward_step
        )

    def near_agent(self, state: EnvState, idx0: int):
        return self.near(state, idx0, None)

    def agent_in_room(self, lay, state: EnvState, room_idx: int):
        """point_inside test against a fixed room (sidewalk.py:99)."""
        p_xz = jnp.stack([state.pos[0], state.pos[2]])
        return geom.point_inside_convex(
            p_xz,
            lay.room_outline[room_idx],
            lay.room_norms[room_idx],
            lay.room_vmask[room_idx],
        )


class GoToEnvSpec(EnvSpec):
    """Shared 'near the goal entity -> reward and terminate' logic used
    by Hallway/OneRoom/FourRooms/TMaze/YMaze/Maze/WallGap/GreenKey
    (e.g. hallway.py:67-74)."""

    goal_slot: int = 0

    def transition(self, ctx: Ctx):
        reached = self.near_agent(ctx.state, self.goal_slot)
        reward = jnp.where(reached, self.reward(ctx.state), 0.0)
        return reward, reached, ctx.state

    def host_transition(self, env, action, reward, termination):
        if env.near(env.entities[self.goal_slot]):
            reward += env._reward()
            termination = True
        return reward, termination


DIR_QUARTER = (-math.pi / 4, math.pi / 4)
