"""The main path's dependencies and the entry points' compile cache.

Each case runs in a fresh interpreter: blocking imports and switching on
JAX's persistent cache are process-wide.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what may be missing where the GPU runs: only numpy, scipy, optax,
# chex, einops, pytest and hypothesis are sure to be installed beside JAX
OPTIONAL = ("flax", "PIL", "gymnasium", "orbax", "pyarrow", "imageio",
            "pygame", "torch", "tensorflow")


def _run(code, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_engine_and_trainer_need_no_optional_package():
    code = f"""
import sys
for m in {OPTIONAL!r}:
    sys.modules[m] = None  # any import of these now raises ImportError
import jax, numpy as np
from miniworld_tpu import MiniWorldVec
from miniworld_tpu.parallel import make_mesh, make_ppo_step, make_train_step
env = MiniWorldVec("MiniWorld-Hallway-v0", 4, obs_width=32, obs_height=24)
state, obs = env.reset(jax.random.key(0))
state, obs, outs = env.rollout(state, obs, jax.random.key(1), 2)
assert np.isfinite(np.asarray(outs["obs_sum"])).all()
mesh = make_mesh(1)
for make in (make_train_step, make_ppo_step):
    kw = dict(minibatches=2, epochs=1) if make is make_ppo_step else {{}}
    step, init = make(env, mesh, horizon=2, **kw)
    ts, s, o, d = init(jax.random.key(2))
    *_, m = step(ts, s, o, d, jax.random.key(3))
    assert np.isfinite(float(m["loss"]))
print(sorted(m for m in {OPTIONAL!r} if sys.modules.get(m) is not None))
"""
    assert _run(code)[-1] == "[]"


def test_compile_cache_follows_env_var(tmp_path):
    code = """
import jax
from miniworld_tpu.utils import compile_cache
print(compile_cache.enable())
print(jax.config.jax_compilation_cache_dir)
"""
    want = str(tmp_path / "cache")
    assert _run(code, {"JAX_COMPILATION_CACHE_DIR": want}) == [want, want]


def test_compile_cache_default_is_fixed_in_checkout():
    code = """
import jax
import miniworld_tpu
assert not jax.config.jax_compilation_cache_dir  # import enables nothing
from miniworld_tpu.utils import compile_cache
print(compile_cache.enable())
print(compile_cache.enable())
print(jax.config.jax_compilation_cache_dir)
"""
    want = os.path.join(REPO, ".jax_cache")
    got = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == [want, want, want]


def test_compile_cache_keeps_a_directory_set_in_code(tmp_path):
    code = f"""
import jax
jax.config.update("jax_compilation_cache_dir", {str(tmp_path)!r})
from miniworld_tpu.utils import compile_cache
print(compile_cache.enable())
print(jax.config.jax_compilation_cache_dir)
"""
    got = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == [str(tmp_path), str(tmp_path)]


@pytest.mark.parametrize("path", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_refuse_the_cpu(path):
    """Measurement scripts fail, with no result line, where JAX finds
    no GPU."""
    out = subprocess.run(
        [sys.executable, path], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
