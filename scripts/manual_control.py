#!/usr/bin/env python3
"""Interactive env driver (reference: scripts/manual_control.py:16-160).

Examples:
    python scripts/manual_control.py MiniWorld-Hallway-v0
    python scripts/manual_control.py MiniWorld-Maze-v0 --top-view \
        --record-dir /tmp/ds --obs-width 512 --obs-height 512
    python scripts/manual_control.py MiniWorld-OneRoom-v0 --headless \
        --steps 500 --record-dir /tmp/ds    # no display needed
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


import argparse


def main():
    p = argparse.ArgumentParser(description=__doc__)
    # both the positional form and the reference's --env-name flag
    # (scripts/manual_control.py:18) are accepted
    p.add_argument("env_name", nargs="?", default=None)
    p.add_argument("--env-name", dest="env_name_flag", default=None)
    p.add_argument("--domain-rand", action="store_true",
                   help="enable domain randomization")
    p.add_argument("--no-time-limit", action="store_true",
                   help="ignore time step limits")
    p.add_argument("--top-view", "--top_view", action="store_true",
                   dest="top_view",
                   help="show the top view instead of the agent view")
    p.add_argument("--mouse-sensitivity", type=float, default=0.15,
                   help="mouse sensitivity for yaw/pitch, degrees per "
                        "pixel (reference uses 0.0025 rad/px ~ 0.14)")
    p.add_argument("--fullscreen", action="store_true",
                   help="start the viewer in fullscreen mode")
    p.add_argument("--window-size", type=str, default=None,
                   help="initial window size as WIDTHxHEIGHT (e.g. "
                        "1920x1080); ignored when --fullscreen is set")
    p.add_argument("--hide-hud", action="store_true",
                   help="run the viewer without the HUD overlay")
    p.add_argument("--show-controls", dest="show_controls",
                   default=None, action="store_true",
                   help="enable the on-screen movement/look buttons")
    p.add_argument("--no-show-controls", dest="show_controls",
                   action="store_false",
                   help="disable the on-screen movement/look buttons")
    p.add_argument("--task", type=str,
                   default="Center and zoom on the target.",
                   help="task description recorded in tasks.parquet")
    p.add_argument("--append", action="store_true",
                   help="append recorded episodes to an existing dataset")
    p.add_argument("--automatic-recording", action="store_true",
                   help="start recording immediately, auto-split episodes")
    p.add_argument("--no-mouse-recenter", action="store_true",
                   help="disable mouse cursor grab/re-centering")
    p.add_argument("--obs-width", type=int, default=512)
    p.add_argument("--obs-height", type=int, default=512)
    p.add_argument("--window-scale", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--record-dir", type=str, default=None)
    p.add_argument("--record-fps", type=int, default=30)
    p.add_argument("--headless", action="store_true",
                   help="scripted random policy, no display")
    p.add_argument("--steps", type=int, default=1000,
                   help="steps for --headless mode")
    args = p.parse_args()
    env_name = (args.env_name_flag or args.env_name
                or "MiniWorld-Hallway-v0")

    from miniworld_tpu.gym_env import MiniWorldGym

    env = MiniWorldGym(
        env_name.replace("MiniWorld-", "").replace("-v0", ""),
        obs_width=args.obs_width, obs_height=args.obs_height,
        domain_rand=args.domain_rand,
        max_episode_steps=10**9 if args.no_time_limit else None,
    )

    if args.headless:
        from miniworld_tpu.manual_control import ScriptedControl

        ScriptedControl(env, "random", args.record_dir,
                        fps=args.record_fps).run(args.steps, seed=args.seed)
        print(f"ran {args.steps} steps"
              + (f"; dataset at {args.record_dir}" if args.record_dir else ""))
        return

    window_size = None
    if args.window_size:
        ww, wh = args.window_size.lower().split("x")
        window_size = (int(ww), int(wh))

    from miniworld_tpu.manual_control import ManualControl

    ManualControl(env, record_dir=args.record_dir, fps=args.record_fps,
                  top_view=args.top_view,
                  window_scale=args.window_scale,
                  show_hud=not args.hide_hud,
                  show_controls=args.show_controls,
                  mouse_sensitivity=args.mouse_sensitivity,
                  fullscreen=args.fullscreen,
                  window_size=window_size,
                  mouse_recenter=not args.no_mouse_recenter,
                  automatic_recording=args.automatic_recording,
                  task=args.task,
                  append=args.append).run(seed=args.seed)


if __name__ == "__main__":
    main()
