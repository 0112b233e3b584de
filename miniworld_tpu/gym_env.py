"""Gymnasium adapter: single-env, reference-parity execution.

Drop-in replacement for the reference's ``MiniWorldEnv`` API
(miniworld/miniworld.py:438-813): same observation/action spaces, same
``reset(seed)``/``step`` contract, same ``info`` dict. Physics runs
host-side in float64 numpy, transcribing the reference's exact op order
and ``np_random`` consumption, so trajectories, rewards, and
terminations are bit-exact against the reference under a fixed seed
(the correctness target: bit-exact trajectories, rewards and
terminations vs the reference). Rendering uses the raycaster in
exact-texture mode on whatever backend JAX selects.

The vectorized path (vector.MiniWorldVec) is the performance
engine; this adapter exists for API parity, gym tooling (env-checker,
wrappers), interactive use, and as the golden model for tests.
"""

from __future__ import annotations

import math
from typing import Optional

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from miniworld_tpu.render.textures import TextureCatalog
from miniworld_tpu.scene.world import World
from miniworld_tpu.utils.assets import texture_variant_paths

# module-level texture catalog: texture files are shared across env
# instances like the reference's Texture.tex_cache (opengl.py:142-145)
_CATALOG = TextureCatalog()

# Jitted single-env render programs, keyed by (width, height, depth).
# Eager per-op dispatch measured ~1 s/frame on CPU; the jitted program
# runs in a few ms. Layout/state shapes are BUCKETED (_bucket_sizes)
# so procedural env classes (Maze rebuilds a differently-sized world
# every reset) hit a handful of compiled programs instead of
# retracing per episode.
_RENDER_JIT = {}
_ATLAS_CACHE = {}


def _jitted_render(width: int, height: int, depth: bool):
    key = (width, height, depth)
    if key not in _RENDER_JIT:
        import jax

        from miniworld_tpu.render.raycast import render_rgbd

        def f(bank, atlas, state):
            return render_rgbd(
                bank, state, {"mode": "nearest", "atlas": atlas},
                width=width, height=height, with_depth=depth,
            )

        _RENDER_JIT[key] = jax.jit(f)
    return _RENDER_JIT[key]


def _bucket(n: int, q: int) -> int:
    return max(((n + q - 1) // q) * q, q)


def _bucket_sizes(sizes: dict) -> dict:
    quanta = dict(S=64, W=32, NS=16, R=8, V=4, P=4, M=8, E=4, C=2, T=8)
    return {k: _bucket(v, quanta.get(k, 1)) for k, v in sizes.items()}


def intersect_circle_segs(point, radius, segs) -> bool:
    """Float64 transcription of miniworld/math.py:30-62."""
    if len(segs) == 0:
        return False
    a = segs[:, 0, :]
    b = segs[:, 1, :]
    ab = b - a
    ap = point[None, :] - a
    t = np.clip(
        np.sum(ap * ab, axis=1) / np.sum(ab * ab, axis=1), 0.0, 1.0
    )
    c = a + t[:, None] * ab
    return bool(np.any(np.linalg.norm(c - point[None, :], axis=1) < radius))


class HostEntity:
    """Mutable per-episode entity record (reference Entity analog)."""

    __slots__ = ("pos", "dir", "radius", "height", "color", "proto_id",
                 "static", "pickable", "alive", "size_mul", "slot_idx")

    def __init__(self, pos, direction, radius, height, color, proto_id,
                 static, pickable, size_mul, slot_idx):
        self.pos = np.asarray(pos, dtype=np.float64)
        self.dir = float(direction)
        self.radius = float(radius)
        self.height = float(height)
        self.color = np.asarray(color, dtype=np.float64)
        self.proto_id = int(proto_id)
        self.static = bool(static)
        self.pickable = bool(pickable)
        self.alive = True
        self.size_mul = float(size_mul)
        self.slot_idx = int(slot_idx)


class MiniWorldGym(gym.Env, gym.utils.EzPickle):
    """Single-env gymnasium adapter over an EnvSpec.

    EzPickle like the reference envs (miniworld/envs/*.py call
    EzPickle.__init__; round-trip tested upstream in
    tests/test_miniworld.py:161-174): pickling stores the constructor
    arguments and rebuilds a fresh env — runtime state (world, agent,
    render caches) reinitializes on the next reset, exactly like the
    reference.
    """

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(
        self,
        spec,
        obs_width: int = 80,
        obs_height: int = 60,
        domain_rand: bool = False,
        render_mode: Optional[str] = None,
        max_episode_steps: Optional[int] = None,
        show_controls: bool = False,
        skip_obs: bool = False,
        view: str = "agent",
        **spec_kwargs,
    ):
        # skip_obs: return zero observations instead of raycasting.
        # Rendering consumes no rng, so trajectories are unchanged —
        # used by physics-parity tests that step thousands of times.
        # view="top": observations are the orthographic top view with
        # the agent marker (miniworld.py:470, 524-526, 1147-1166).
        gym.utils.EzPickle.__init__(
            self, spec,
            obs_width=obs_width, obs_height=obs_height,
            domain_rand=domain_rand, render_mode=render_mode,
            max_episode_steps=max_episode_steps,
            show_controls=show_controls, skip_obs=skip_obs, view=view,
            **spec_kwargs,
        )
        assert view in ("agent", "top"), view  # miniworld.py:524-526
        self.view = view
        if isinstance(spec, str):
            from miniworld_tpu.envs import make_spec

            spec = make_spec(spec, **spec_kwargs)
        self.spec_def = spec
        self.obs_width = obs_width
        self.obs_height = obs_height
        self.domain_rand = domain_rand
        self.render_mode = render_mode
        self.max_episode_steps = max_episode_steps or spec.max_episode_steps
        self.params = spec.params

        # 6-D continuous base action space (miniworld.py:483-487) with
        # the spec's discrete table layered on top (miniworld.py:654-664)
        if spec.discrete_actions is not None:
            self._discrete_actions = np.asarray(spec.discrete_actions)
            self.action_space = spaces.Discrete(len(self._discrete_actions))
        elif getattr(spec, "num_actions", 0):
            self._discrete_actions = None
            self.action_space = spaces.Discrete(spec.num_actions)
        elif getattr(spec, "click_action", False):
            self._discrete_actions = None
            self.action_space = spaces.Box(0.0, 1.0, (2,), np.float32)
        else:
            self._discrete_actions = None
            self.action_space = spaces.Box(
                low=np.array([-1, -1, -1, -1, 0, 0], np.float32),
                high=np.array([1, 1, 1, 1, 1, 1], np.float32),
                shape=(6,), dtype=np.float32,
            )

        img_space = spaces.Box(
            0, 255, (obs_height, obs_width, 3), dtype=np.uint8
        )
        if spec.dict_obs:
            self.observation_space = spaces.Dict(
                obs=img_space, goal=spaces.Discrete(2)
            )
        else:
            self.observation_space = img_space

        self.show_controls = show_controls
        self.skip_obs = skip_obs
        # agent state (entity.py:455-529)
        self.agent_radius = spec.agent_radius
        self._render_cache = None
        self.world: World | None = None
        self.step_count = 0

    # -- reset ----------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        rng = self.np_random
        rand = rng if self.domain_rand else None
        self.step_count = 0

        # fresh Agent defaults (entity.py:455-474)
        self.cam_height = 1.5
        self.cam_fwd_disp = 0.0
        self.cam_pitch = 0.0
        self.cam_fov_y = 60.0
        self.carrying: HostEntity | None = None

        # world build == reference _gen_world (rng consumed identically)
        world = World(_CATALOG, rng=rng)
        world.agent_radius = self.agent_radius
        world.set_eager_static_rand(rand)
        self.spec_def.build(world, rng)
        world.gen_static_data(rand=rand)
        self.world = world
        self.max_forward_step = float(self.params.get_max("forward_step"))

        # episode params (miniworld.py:586-592); defaults when rand None
        for name in ["sky_color", "light_pos", "light_color", "light_ambient"]:
            setattr(self, name, np.asarray(self.params.sample(rand, name), dtype=np.float64))

        # entity instantiation in placement order
        self.entities: list[HostEntity] = []
        for i, slot in enumerate(world.slots):
            proto = world.protos[slot.proto_id]
            self.entities.append(HostEntity(
                slot.pos, slot.dir, proto.radius * slot.size_mul,
                proto.height * slot.size_mul, proto.color, slot.proto_id,
                proto.static, proto.pickable, slot.size_mul, i,
            ))
        assert world.agent_slot is not None and world.agent_slot.pos is not None
        self.agent_pos = np.asarray(world.agent_slot.pos, dtype=np.float64)
        self.agent_dir = float(world.agent_slot.dir)

        # per-entity randomization in entity order (miniworld.py:598-599):
        # Box consumes obj_color_bias (entity.py:405-407); TextFrame
        # re-rolls per-char texture variants (entity.py:287-299); the
        # agent — appended by place_agent — consumes 4 camera params
        # (entity.py:519-529).
        for i, (ent, slot) in enumerate(zip(self.entities, world.slots)):
            proto = world.protos[ent.proto_id]
            if proto.colorable:
                bias = self.params.sample(rand, "obj_color_bias")
                ent.color = np.clip(proto.color + bias, 0, 1)
            char_slots = getattr(slot, "char_tex_slots", None)
            if char_slots is not None and rand is not None:
                for cs in char_slots:
                    world._sample_tex_variant(cs, rand)
        if world.agent_in_entities:
            for name in ["cam_height", "cam_fwd_disp", "cam_pitch", "cam_fov_y"]:
                setattr(self, name, float(self.params.sample(rand, name)))

        # floorplan extents (miniworld.py:601-605)
        self.min_x = min(r.min_x for r in world.rooms)
        self.max_x = max(r.max_x for r in world.rooms)
        self.min_z = min(r.min_z for r in world.rooms)
        self.max_z = max(r.max_z for r in world.rooms)

        self.wall_segs = world._wall_segs  # (N,2,2) XZ float64
        self._render_cache = None

        # spec-level per-episode host state (health, camera wall, ...)
        self.task = self.spec_def.host_reset(self, rng)

        obs = self.render_obs()
        return self._wrap_obs(obs), {"agent": self._get_agent_state()}

    # -- reference step transcription ------------------------------------

    @property
    def dir_vec(self):
        return np.array([math.cos(self.agent_dir), 0.0, -math.sin(self.agent_dir)])

    @property
    def right_vec(self):
        return np.array([math.sin(self.agent_dir), 0.0, math.cos(self.agent_dir)])

    def intersect(self, ent, pos, radius):
        """miniworld.py:1020-1046; ``ent`` may be None (the agent)."""
        p = np.array([pos[0], pos[2]])
        if intersect_circle_segs(p, radius, self.wall_segs):
            return True
        for ent2 in self.entities:
            if ent2 is ent or not ent2.alive:
                continue
            d = np.linalg.norm(np.array([ent2.pos[0], ent2.pos[2]]) - p)
            if d < radius + ent2.radius:
                return ent2
        # the agent participates in entity collision when it's not the
        # query subject (reference keeps the agent in self.entities)
        if ent is not None:
            d = np.linalg.norm(np.array([self.agent_pos[0], self.agent_pos[2]]) - p)
            if d < radius + self.agent_radius:
                return True
        return None

    def near(self, ent0, ent1=None):
        """miniworld.py:1048-1058."""
        p1, r1 = (
            (self.agent_pos, self.agent_radius)
            if ent1 is None else (ent1.pos, ent1.radius)
        )
        dist = np.linalg.norm(ent0.pos - p1)
        return dist < ent0.radius + r1 + 1.1 * self.max_forward_step

    def _get_carry_pos(self, agent_pos, ent):
        """miniworld.py:677-689."""
        dist = self.agent_radius + ent.radius + self.max_forward_step
        pos = agent_pos + self.dir_vec * 1.05 * dist
        y_pos = max(self.cam_height - ent.height - 0.3, 0)
        return pos + np.array([0.0, 1.0, 0.0]) * y_pos

    def move_agent(self, fwd_dist, strafe_dist) -> bool:
        """miniworld.py:691-717."""
        next_pos = (
            self.agent_pos + self.dir_vec * fwd_dist + self.right_vec * strafe_dist
        )
        if self.intersect(None, next_pos, self.agent_radius):
            return False
        if self.carrying is not None:
            next_carrying_pos = self._get_carry_pos(next_pos, self.carrying)
            if self.intersect(self.carrying, next_carrying_pos, self.carrying.radius):
                return False
            self.carrying.pos = next_carrying_pos
            self.carrying.dir = self.agent_dir
        self.agent_pos = next_pos
        return True

    def _update_agent_orientation(self, yaw_delta, pitch_delta) -> bool:
        """miniworld.py:719-745."""
        orig_dir, orig_pitch = self.agent_dir, self.cam_pitch
        self.agent_dir += yaw_delta
        self.cam_pitch = float(np.clip(self.cam_pitch + pitch_delta, -89.0, 89.0))
        if self.carrying is not None:
            pos = self._get_carry_pos(self.agent_pos, self.carrying)
            if self.intersect(self.carrying, pos, self.carrying.radius):
                self.agent_dir, self.cam_pitch = orig_dir, orig_pitch
                return False
            self.carrying.pos = pos
            self.carrying.dir = self.agent_dir
        return True

    def _get_agent_state(self):
        """miniworld.py:666-675."""
        return {
            "pos": self.agent_pos.copy(),
            "dir": self.agent_dir,
            "cam_pitch": self.cam_pitch,
        }

    def _reward(self):
        """miniworld.py:1095-1100."""
        return 1.0 - 0.2 * (self.step_count / self.max_episode_steps)

    def step(self, action):
        self.step_count += 1
        rand = self.np_random if self.domain_rand else None
        spec = self.spec_def
        # env step overrides in the reference see the ORIGINAL action
        # (e.g. Sign's end-action scalar check, sign.py:170)
        orig_action = action

        if spec.override_physics:
            spec.host_apply_action(self, action)
        else:
            fwd_step = self.params.sample(rand, "forward_step")
            fwd_drift = self.params.sample(rand, "forward_drift")
            turn_step = self.params.sample(rand, "turn_step")

            action_idx = -1
            if np.isscalar(action) or np.ndim(action) == 0:
                if self._discrete_actions is None:
                    raise ValueError(
                        f"Scalar action {action!r} passed to an env with a "
                        "continuous Box(6) action space; pass a 6-vector or "
                        "install a mapping with set_discrete_actions()."
                    )
                action_idx = int(action)
                if not 0 <= action_idx < len(self._discrete_actions):
                    raise ValueError(
                        f"Discrete action {action_idx} outside valid range"
                    )
                action = self._discrete_actions[action_idx]
            action = np.asarray(action, dtype=np.float32)
            # NaN/inf actions would silently corrupt the agent pose
            # (np.clip passes NaN through)
            action = np.nan_to_num(action, nan=0.0, posinf=1.0, neginf=-1.0)
            # the action vector STAYS float32 through the step math —
            # the reference clips against its float32 Box bounds and
            # multiplies f32 components into the f64 step sizes
            # (miniworld.py:778-787); bit-parity requires the same
            # f32-rounded deltas
            action = np.clip(
                action,
                np.array([-1, -1, -1, -1, 0, 0], np.float32),
                np.array([1, 1, 1, 1, 1, 1], np.float32),
            )

            yaw_delta = action[2] * turn_step * math.pi / 180
            pitch_delta = action[3] * turn_step
            self._update_agent_orientation(yaw_delta, pitch_delta)

            forward_dist = action[0] * fwd_step
            strafe_dist = action[1] * fwd_step + fwd_drift
            self.move_agent(forward_dist, strafe_dist)

            if action[4] > 0.5:  # pickup (miniworld.py:789-793)
                test_pos = self.agent_pos + self.dir_vec * 1.5 * self.agent_radius
                ent = self.intersect(None, test_pos, 1.2 * self.agent_radius)
                if (
                    self.carrying is None
                    and isinstance(ent, HostEntity)
                    and not ent.static
                ):
                    self.carrying = ent
            if action[5] > 0.5 and self.carrying is not None:  # drop
                self.carrying.pos[1] = 0
                self.carrying = None

        obs = self.render_obs()

        if self.step_count >= self.max_episode_steps:
            reward, termination, truncation = 0.0, False, True
        else:
            reward, termination, truncation = 0.0, False, False

        # env-specific task logic (reference env step overrides)
        reward, termination = spec.host_transition(
            self, orig_action, reward, termination
        )
        info = {"agent": self._get_agent_state()}
        info.update(spec.host_info(self))
        return self._wrap_obs(obs), reward, termination, truncation, info

    # -- rendering --------------------------------------------------------

    def _build_render_state(self):
        """Compile the host world + pack an EnvState for the raycaster."""
        import jax
        import jax.numpy as jnp

        from miniworld_tpu.scene.compile import compile_world
        from miniworld_tpu.state import EnvState

        if self._render_cache is None:
            lay = compile_world(self.world)
            # bucket shapes so the jitted render program is reused
            # across resets (and across procedural layout sizes)
            lay = lay.pad_to(_bucket_sizes(lay.sizes))
            bank = jax.tree.map(lambda x: jnp.asarray(x)[None], lay)
            akey = len(_CATALOG.paths)
            if akey not in _ATLAS_CACHE:
                _ATLAS_CACHE[akey] = jnp.asarray(_CATALOG.build_atlas())
            atlas = _ATLAS_CACHE[akey]
            self._render_cache = (bank, atlas)
        bank, atlas = self._render_cache
        E = _bucket(len(self.entities), 4)  # stable jit shapes
        ent_pos = np.zeros((E, 3), np.float32)
        ent_dir = np.zeros(E, np.float32)
        ent_alive = np.zeros(E, bool)
        ent_proto = np.zeros(E, np.int32)
        ent_color = np.zeros((E, 3), np.float32)
        ent_size = np.zeros((E, 3), np.float32)
        ent_radius = np.zeros(E, np.float32)
        ent_height = np.zeros(E, np.float32)
        for i, e in enumerate(self.entities):
            proto = self.world.protos[e.proto_id]
            ent_pos[i] = e.pos
            ent_dir[i] = e.dir
            ent_alive[i] = e.alive
            ent_proto[i] = e.proto_id
            ent_color[i] = e.color
            ent_size[i] = proto.size * e.size_mul
            ent_radius[i] = e.radius
            ent_height[i] = e.height

        state = EnvState(
            pos=jnp.asarray(self.agent_pos, jnp.float32),
            dir=jnp.float32(self.agent_dir),
            cam_pitch=jnp.float32(self.cam_pitch),
            cam_height=jnp.float32(self.cam_height),
            cam_fov_y=jnp.float32(self.cam_fov_y),
            cam_fwd_disp=jnp.float32(self.cam_fwd_disp),
            carrying=jnp.int32(-1),
            ent_pos=jnp.asarray(ent_pos), ent_dir=jnp.asarray(ent_dir),
            ent_alive=jnp.asarray(ent_alive), ent_proto=jnp.asarray(ent_proto),
            ent_color=jnp.asarray(ent_color), ent_size=jnp.asarray(ent_size),
            ent_radius=jnp.asarray(ent_radius), ent_height=jnp.asarray(ent_height),
            step_count=jnp.int32(self.step_count),
            rng=jax.random.key(0), layout_id=jnp.int32(0),
            sky_color=jnp.asarray(self.sky_color, jnp.float32),
            light_pos=jnp.asarray(self.light_pos, jnp.float32),
            light_color=jnp.asarray(self.light_color, jnp.float32),
            light_ambient=jnp.asarray(self.light_ambient, jnp.float32),
            tex_map=jnp.asarray(np.asarray(self.world.tex_map, np.int32)),
            # adapter renders in "nearest" mode, which resolves variants
            # per pixel through tex_map — the fourier-path variant key
            # is unused here
            tri_slots=jnp.uint32(0),
            task={},
        )
        return bank, atlas, state

    def render_obs(self, depth: bool = False):
        """First-person RGB (miniworld.py:1260-1303); exact textures.

        With ``view="top"`` the observation is the orthographic top
        view including the agent marker, exactly as the reference's
        ``_render_world`` does for that mode (miniworld.py:1147-1166);
        ``depth=True`` then returns the vertical hit distance from the
        top camera plane.
        """
        if self.skip_obs:
            rgb = np.zeros((self.obs_height, self.obs_width, 3), np.uint8)
            if depth:
                return rgb, np.zeros(
                    (self.obs_height, self.obs_width, 1), np.float32
                )
            return rgb
        if self.view == "top":
            out = self.render_top_view(render_agent=True, with_depth=depth)
            if depth:
                rgb, d = out
                return np.asarray(rgb), np.asarray(d)
            return np.asarray(out)
        bank, atlas, state = self._build_render_state()
        rgb, d = _jitted_render(self.obs_width, self.obs_height, depth)(
            bank, atlas, state
        )
        rgb = np.asarray(rgb)
        rgb = np.asarray(self.spec_def.host_post_render(rgb, self))
        if depth:
            return rgb, np.asarray(d)
        return rgb

    def render_depth(self):
        """RGB-D observation (miniworld.py:1305-1318); depth in meters."""
        return self.render_obs(depth=True)

    def render_top_view(self, width: int | None = None, height: int | None = None,
                        render_agent: bool = True, return_scale: bool = False,
                        with_depth: bool = False):
        """Orthographic top-down map view (miniworld.py:1171-1258).

        ``render_agent`` toggles the red agent triangle;
        ``return_scale=True`` additionally returns the reference's
        world→pixel mapping dict (miniworld.py:1245-1256):
        ``{"x_scale", "z_scale", "x_offset", "z_offset"}``;
        ``with_depth=True`` returns (rgb, depth) for the view="top"
        observation path.
        """
        import jax
        import jax.numpy as jnp

        w = width or self.obs_width
        h = height or self.obs_height
        key = ("topview", w, h, render_agent, with_depth)
        if key not in _RENDER_JIT:
            from miniworld_tpu.render.topview import render_top_view

            def f(bank, atlas, state, extents, agent_radius):
                return render_top_view(
                    bank, state, {"mode": "nearest", "atlas": atlas},
                    width=w, height=h,
                    extents=extents, agent_radius=agent_radius,
                    render_agent=render_agent, with_depth=with_depth,
                )

            _RENDER_JIT[key] = jax.jit(f)
        bank, atlas, state = self._build_render_state()
        out = _RENDER_JIT[key](
            bank, atlas, state,
            jnp.asarray([self.min_x, self.max_x, self.min_z, self.max_z],
                        jnp.float32),
            jnp.float32(self.agent_radius),
        )
        if with_depth:
            assert not return_scale
            rgb, d = out
            return np.asarray(rgb), np.asarray(d)
        img = np.asarray(out)
        if not return_scale:
            return img
        # world→pixel scale of the aspect-fit view (miniworld.py:1192-
        # 1254): 1-unit margin, then the narrow extent is widened to
        # match the frame-buffer aspect.
        min_x, max_x = self.min_x - 1.0, self.max_x + 1.0
        min_z, max_z = self.min_z - 1.0, self.max_z + 1.0
        aspect = (max_x - min_x) / (max_z - min_z)
        fb_aspect = w / h
        if aspect > fb_aspect:
            h_diff = (max_x - min_x) / fb_aspect - (max_z - min_z)
            min_z -= h_diff / 2
            max_z += h_diff / 2
        elif aspect < fb_aspect:
            w_diff = (max_z - min_z) * fb_aspect - (max_x - min_x)
            min_x -= w_diff / 2
            max_x += w_diff / 2
        x_scale = w / (max_x - min_x)
        z_scale = h / (max_z - min_z)
        scale = {
            "x_scale": x_scale,
            "z_scale": z_scale,
            "x_offset": int(0 - min_x * x_scale),
            "z_offset": int(0 - min_z * z_scale),
        }
        return img, scale

    def set_discrete_actions(self, actions=None):
        """Install (or reset) a discrete action mapping at runtime
        (miniworld.py:654-664). ``actions`` is a list of 6-D vectors;
        None installs the default 6-move table."""
        from miniworld_tpu.envs.base import default_discrete_actions

        if actions is None:
            table = default_discrete_actions()
        else:
            table = np.asarray(actions, dtype=np.float32)
        assert table.ndim == 2 and table.shape[1] == 6, table.shape
        self._discrete_actions = table
        self.action_space = spaces.Discrete(len(table))

    @property
    def control_boxes(self):
        """name -> pixel rect of clickable HUD buttons
        (miniworld.py:1389-1391, 1500-1504)."""
        from miniworld_tpu import hud

        amap = getattr(self.spec_def, "control_action_map", None)
        labels = list(amap) if amap else [n for n, _ in hud.DEFAULT_CONTROLS]
        return hud.control_layout(self.obs_width, self.obs_height, labels)

    def control_action(self, name):
        """Action for a clicked HUD button, or None."""
        from miniworld_tpu import hud

        amap = getattr(self.spec_def, "control_action_map", None)
        if amap:
            return amap[name]  # discrete action index
        for label, (comp, val) in hud.DEFAULT_CONTROLS:
            if label == name:
                vec = np.zeros(6, np.float32)
                vec[comp] = val
                if self._discrete_actions is not None:
                    from miniworld_tpu.manual_control import project_discrete

                    return project_discrete(vec, self._discrete_actions)
                return vec
        return None

    def get_visible_ents(self):
        """Entities visible from the camera (miniworld.py:1576-1670).

        Returns the set of HostEntity objects, like the reference
        returns a set of Entity instances.
        """
        from miniworld_tpu.render.visibility import visible_ents

        bank, atlas, state = self._build_render_state()
        mask = np.asarray(visible_ents(
            bank, state, width=self.obs_width, height=self.obs_height,
        ))
        return {e for e, v in zip(self.entities, mask) if v}

    def render(self):
        if self.render_mode == "rgb_array":
            frame = self.render_obs()
            if self.show_controls:
                from miniworld_tpu import hud

                frame = hud.draw_controls(frame, self.control_boxes)
            return frame
        if self.render_mode == "human":
            # Interactive window with pose readout + top-view PiP, the
            # reference's human render (miniworld.py:1678-1790: agent
            # view into vis_fb, obs thumbnail, pose text). Composed
            # with the pygame/hud stack since there is no GL here.
            from miniworld_tpu import hud

            frame = hud.compose_human_frame(
                self.render_obs(),
                self.render_top_view(),
                pose=(self.agent_pos[0], self.agent_pos[2],
                      math.degrees(self.agent_dir)),
            )
            if self.show_controls:
                frame = hud.draw_controls(frame, self.control_boxes)
            self._blit_human(frame)
            return None
        return None

    def _blit_human(self, frame: np.ndarray):
        """Push a frame to the lazily-created pygame window. Uses the
        SDL dummy driver automatically when no display is available
        (headless CI), where the window is a no-op surface."""
        import os

        import pygame

        if not hasattr(self, "_pygame_screen"):
            if "DISPLAY" not in os.environ and "SDL_VIDEODRIVER" not in os.environ:
                os.environ["SDL_VIDEODRIVER"] = "dummy"
            pygame.init()
            h, w = frame.shape[:2]
            scale = max(1, 600 // max(h, 1))
            self._pygame_scale = scale
            self._pygame_screen = pygame.display.set_mode((w * scale, h * scale))
            pygame.display.set_caption(f"miniworld-tpu: {self.spec_def.name}")
        surf = pygame.surfarray.make_surface(np.transpose(frame, (1, 0, 2)))
        if self._pygame_scale > 1:
            surf = pygame.transform.scale(
                surf, self._pygame_screen.get_size()
            )
        self._pygame_screen.blit(surf, (0, 0))
        pygame.display.flip()
        pygame.event.pump()

    def close(self):
        if hasattr(self, "_pygame_screen"):
            import pygame

            pygame.display.quit()
            del self._pygame_screen

    # -- helpers ----------------------------------------------------------

    def _wrap_obs(self, obs):
        if self.spec_def.dict_obs:
            return {"obs": obs, "goal": int(self.spec_def.goal)}
        return obs


def register_gym(prefix: str = ""):
    """Register all env IDs with gymnasium (envs/__init__.py:52-185).

    With the default empty prefix the IDs match the reference exactly
    (``MiniWorld-Hallway-v0`` ...), so downstream code can switch from
    the reference package by changing only the import.
    """
    from miniworld_tpu.envs import SPEC_CLASSES

    for cls in SPEC_CLASSES:
        inst = cls()
        gym_id = prefix + inst.gym_id
        if gym_id in gym.registry:
            continue
        gym.register(
            id=gym_id,
            entry_point="miniworld_tpu.gym_env:MiniWorldGym",
            kwargs={"spec": inst.name},
        )
