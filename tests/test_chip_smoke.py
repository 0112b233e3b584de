"""chip_smoke.py's comparison helpers and device check, on the CPU.

The phases themselves need the card; here the tolerances they apply are
checked on synthetic arrays: within tolerance passes, beyond fails.
"""

import types

import numpy as np
import pytest

import chip_smoke as cs


def _state(pos, dir_, ent):
    return types.SimpleNamespace(pos=np.asarray(pos), dir=np.asarray(dir_),
                                 ent_pos=np.asarray(ent))


def _frames(seed=0, n=2, h=6, w=8):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 20.0, (n, h, w, 1)).astype(np.float32)
    depth[:, 0, 0] = cs.FAR  # sky pixels
    return rgb, depth


def test_state_within_tolerance_passes():
    g = _state([[1.0, 0, 2.0]], [0.3], [[[0.5, 0, 0.5]]])
    c = _state([[1.0 + 4e-4, 0, 2.0]], [0.3 - 4e-4], [[[0.5, 0, 0.5]]])
    out = cs.state_deltas(g, c, np.array([0.0]), np.array([0.0]),
                          np.array([False]), np.array([False]))
    assert out["pos"] == pytest.approx(4e-4) and out["ent_pos"] == 0.0


@pytest.mark.parametrize("case", ["pos", "reward", "done"])
def test_state_beyond_tolerance_fails(case):
    g = _state([[1.0, 0, 2.0]], [0.3], [[[0.5, 0, 0.5]]])
    c = _state([[1.0 + (1e-3 if case == "pos" else 0), 0, 2.0]], [0.3],
               [[[0.5, 0, 0.5]]])
    rew_c = np.array([1.0 if case == "reward" else 0.0])
    done_c = np.array([case == "done"])
    with pytest.raises(cs.ParityError):
        cs.state_deltas(g, c, np.array([0.0]), rew_c, np.array([False]),
                        done_c)


def test_render_within_tolerance_passes():
    rgb, depth = _frames()
    rgb2 = rgb.astype(np.int16)
    rgb2[..., 0] += np.where(rgb2[..., 0] < 255, 1, -1)  # one level
    rgb2 = rgb2.astype(np.uint8)
    depth2 = depth * (1 + 5e-4)
    out = cs.render_deltas(rgb, rgb2, depth, depth2)
    assert out["rgb_mean_abs"] <= 1.0 and out["rgb_big_frac"] == 0.0
    assert out["depth_rel"] == pytest.approx(5e-4, rel=1e-3)


def test_render_ignores_depth_where_rgb_disagrees():
    rgb, depth = _frames(n=4, h=10, w=10)  # 400 px: 1% budget = 4 px
    rgb2, depth2 = rgb.copy(), depth.copy()
    rgb2[0, 2, 2] = (rgb2[0, 2, 2].astype(int) + 128) % 256  # a flip
    depth2[0, 2, 2] *= 3.0  # its depth jumps to another surface
    out = cs.render_deltas(rgb, rgb2, depth, depth2)
    assert out["rgb_big_frac"] == pytest.approx(1 / 400)
    assert out["depth_rel"] == 0.0


@pytest.mark.parametrize("case", ["mean", "big", "depth"])
def test_render_beyond_tolerance_fails(case):
    rgb, depth = _frames(n=4, h=10, w=10)
    rgb2, depth2 = rgb.astype(np.int16), depth.copy()
    if case == "mean":
        rgb2 = rgb2 + np.where(rgb2 < 250, 2, -2)  # 2 levels everywhere
    elif case == "big":  # 5 of 400 px off by 128 levels: over 1%
        rgb2[0, 0, :5] = (rgb2[0, 0, :5] + 128) % 256
    else:
        depth2 = depth * (1 + 2e-3)
    with pytest.raises(cs.ParityError):
        cs.render_deltas(rgb, np.clip(rgb2, 0, 255).astype(np.uint8),
                         depth, depth2)


@pytest.mark.parametrize("argv", [[], ["--gpus", "4"]])
def test_main_refuses_the_cpu(argv, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main(argv)
    assert '"ok"' not in capsys.readouterr().out
