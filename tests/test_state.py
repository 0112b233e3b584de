"""EnvState/StepResult: pytree dataclasses without flax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from miniworld_tpu.state import EnvState, StepResult


def _state(**over):
    f = jnp.float32
    kw = dict(
        pos=jnp.zeros(3, f), dir=f(0.5), cam_pitch=f(0), cam_height=f(1.5),
        cam_fov_y=f(60), cam_fwd_disp=f(0), carrying=jnp.int32(-1),
        ent_pos=jnp.zeros((2, 3), f), ent_dir=jnp.zeros(2, f),
        ent_alive=jnp.ones(2, bool), ent_proto=jnp.zeros(2, jnp.int32),
        ent_color=jnp.ones((2, 3), f), ent_size=jnp.ones((2, 3), f),
        ent_radius=jnp.ones(2, f), ent_height=jnp.ones(2, f),
        step_count=jnp.int32(0), rng=jax.random.key(0),
        layout_id=jnp.int32(0), sky_color=jnp.ones(3, f),
        light_pos=jnp.ones(3, f), light_color=jnp.ones(3, f),
        light_ambient=jnp.ones(3, f), tex_map=jnp.arange(4),
        tri_slots=jnp.uint32(0),
    )
    kw.update(over)
    return EnvState(**kw)


def test_leaves_follow_field_order_and_defaults():
    s = _state(task={"goal": jnp.int32(3)})
    names = [f.name for f in dataclasses.fields(EnvState)]
    assert names[-2:] == ["wall_open", "task"]
    leaves = jax.tree.leaves(s)
    # wall_open=None contributes no leaf; task's dict leaf comes last
    want = [getattr(s, n) for n in names[:-2]] + [s.task["goal"]]
    assert len(leaves) == len(want)
    assert all(a is b for a, b in zip(leaves, want))
    plain = _state()
    assert plain.wall_open is None and plain.task == {}
    assert _state().task is not plain.task  # a fresh dict per instance


def test_replace_is_functional():
    s = _state()
    s2 = s.replace(step_count=jnp.int32(7), wall_open=jnp.ones(4))
    assert int(s.step_count) == 0 and s.wall_open is None
    assert int(s2.step_count) == 7 and s2.wall_open.shape == (4,)
    r = StepResult(moved=jnp.bool_(True), picked_up=jnp.int32(-1),
                   dropped=jnp.int32(2))
    assert int(r.replace(dropped=jnp.int32(-1)).dropped) == -1


def test_jit_round_trip_with_and_without_wall_open():
    @jax.jit
    def bump(s):
        return s.replace(pos=s.pos + 1.0, step_count=s.step_count + 1)

    out = bump(_state())
    assert isinstance(out, EnvState) and out.wall_open is None
    np.testing.assert_array_equal(np.asarray(out.pos), np.ones(3))
    out = bump(_state(wall_open=jnp.zeros(5)))
    assert out.wall_open.shape == (5,)
    # vmap over a batched state keeps the structure
    batched = jax.tree.map(lambda x: jnp.stack([x, x]), _state())
    assert jax.vmap(bump)(batched).pos.shape == (2, 3)
