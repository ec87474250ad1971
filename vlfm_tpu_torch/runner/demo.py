"""Closed-loop demo: ``python -m vlfm_tpu_torch.runner.demo [--episodes N] [--cpu]``.

Counterpart of ``vlfm_tpu/runner/demo.py``, with its flags and its printed
lines and JSON. Runs full ObjectNav episodes of the synthetic environment
through the port's stack (obstacle, value and object maps, frontier
selection, the PointNav or greedy controller) on the card, or on the CPU
with ``--cpu``, and prints per-episode results and the aggregate.
"""

from __future__ import annotations

import argparse
import json
import os


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--episodes", type=int, default=3)
    parser.add_argument("--max-steps", type=int, default=200)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    parser.add_argument("--plan", choices=["open", "two_room"], default="open")
    parser.add_argument("--image-height", type=int, default=240)
    parser.add_argument("--image-width", type=int, default=320)
    parser.add_argument(
        "--controller",
        choices=["neural", "greedy"],
        default="greedy",
        help="'neural' uses the PointNav net (random weights from seed 0); "
        "'greedy' is the deterministic rho-theta controller",
    )
    parser.add_argument(
        "--save-dir",
        default=None,
        help="write per-episode obstacle/value map renders and a composed "
        "frame to this directory",
    )
    parser.add_argument(
        "--save-video",
        default=None,
        help="write a per-episode mp4 (egocentric view + live maps) to this "
        "directory",
    )
    args = parser.parse_args()

    import cv2
    import numpy as np

    from vlfm_tpu_torch.config import CameraConfig, VLFMConfig
    from vlfm_tpu_torch.device import default_device
    from vlfm_tpu_torch.mapping import object_map as OBJ
    from vlfm_tpu_torch.mapping.grid import GridSpec2D
    from vlfm_tpu_torch.models.pointnav import PointNavPolicy
    from vlfm_tpu_torch.runner import metrics as M
    from vlfm_tpu_torch.runner.episode_driver import run_episode
    from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, open_room_plan, two_room_plan
    from vlfm_tpu_torch.utils import visualization as VIS
    from vlfm_tpu_torch.utils.video import VideoCollector, write_video

    device = "cpu" if args.cpu else default_device()
    cfg = VLFMConfig(camera=CameraConfig(height=args.image_height, width=args.image_width))
    spec = GridSpec2D(size=1024, pixels_per_meter=20, pad=160)
    if args.controller == "neural":
        pointnav = PointNavPolicy.init_random(0, depth_shape=tuple(cfg.depth_image_shape), device=device)
    else:
        pointnav = "greedy"

    env_cfg = EnvConfig(width=args.image_width, height=args.image_height, max_steps=args.max_steps)
    make_plan = open_room_plan if args.plan == "open" else two_room_plan

    def grid(t, ds=1):
        """A lane-0 storage grid as a logical numpy map, every ds-th cell."""
        return spec.crop_logical(t[0])[::ds, ::ds].cpu().numpy()

    def render_maps(st, ds=4):
        om = VIS.render_obstacle_map(grid(st.obstacle.obstacles, ds), grid(st.obstacle.navigable, ds),
                                     grid(st.obstacle.explored, ds))
        if bool(OBJ.has_object(st.objmap)[0]):
            # detected-object cloud painted onto the map
            # (habitat_visualizer.py:228-253 role)
            pts, mask = OBJ.get_target_cloud(st.objmap)
            VIS.paint_target_cloud(om, spec, pts[0][mask[0], :2].cpu().numpy(), downsample=ds)
        return [om, VIS.render_value_map(grid(st.value.values, ds).max(axis=-1), spec)]

    results = []
    for ep in range(args.episodes):
        env = FakeObjectNavEnv(make_plan(seed=ep), env_cfg)
        trail = []
        last = {}
        collector = VideoCollector() if args.save_video else None

        def on_step(env_, o, info, st, _trail=trail, _last=last):
            _trail.append(np.array([env_.x, env_.y]))
            _last["obs"] = o
            _last["yaw"] = env_.yaw
            if collector is not None:
                collector.collect(o["rgb"], o["depth"], render_maps(st))

        result, stats = run_episode(
            env, pointnav, spec, cfg, seed=ep,
            on_step=on_step if (args.save_dir or args.save_video) else None,
            keep_state=bool(args.save_dir), device=device,
        )
        if collector is not None:
            os.makedirs(args.save_video, exist_ok=True)
            path = write_video(collector.flush(result.failure_cause), f"{args.save_video}/ep{ep}.mp4")
            print(f"wrote {path}")
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
            st = stats.final_state
            traj = VIS.TrajectoryVisualizer(spec)
            frontiers = spec.xy_to_px(st.obstacle.frontiers_xy[0])[st.obstacle.frontiers_valid[0]]
            om = VIS.render_obstacle_map(
                grid(st.obstacle.obstacles), grid(st.obstacle.navigable), grid(st.obstacle.explored),
                frontiers.cpu().numpy(), traj=traj, positions=trail, yaw=last.get("yaw", 0.0),
            )
            vm = VIS.render_value_map(grid(st.value.values)[..., 0], spec, traj=traj, positions=trail,
                                      yaw=last.get("yaw", 0.0))
            cv2.imwrite(f"{args.save_dir}/ep{ep}_obstacle_map.png", om)
            cv2.imwrite(f"{args.save_dir}/ep{ep}_value_map.png", vm)
            o = last["obs"]
            frame = VIS.compose_frame(
                o["rgb"][..., ::-1].copy(), o["depth"], [om, vm],
                texts=[f"episode {ep} | success={result.success} spl={result.spl:.2f}"],
            )
            cv2.imwrite(f"{args.save_dir}/ep{ep}_frame.png", frame)
        results.append(result)
        print(
            f"episode {ep}: success={result.success} spl={result.spl:.3f} "
            f"steps={result.steps} dist={result.distance_to_goal:.2f} "
            f"cause={result.failure_cause} "
            f"({stats.steps_per_sec:.2f} steps/s)"
        )
    print(json.dumps(M.aggregate(results), indent=2))


if __name__ == "__main__":
    main()
