"""SemExp (habitat 0.1.5 / Gibson) harness: the stack behind the reference's
Gibson ObjectNav row.

Counterpart of ``vlfm_tpu/adapters/semexp.py`` (reference:
vlfm/semexp_env/eval.py, the whole file). Host code over the port's own
``HabitatVLFMAgent``, ``log_saver``, ``video`` and ``visualization``.

Protocol (SemExp's make_vec_envs duck type, eval.py:78-121):
    obs, infos = envs.reset()
    obs, rew, done, infos = envs.step(action)   # action: (1,) int
where ``obs`` is a (1, 4, H, W) float stack (rgb 0-255 + depth) and
``infos[0]`` carries gps/compass/heading (numpy), goal_name (Gibson
"pottedplant"-style names with '-' separators), episode_id/scene_id, and on
done success/spl/distance_to_goal.

Frames go through ``utils/video.py`` (the reference uses moviepy), and the
policy is the batched ``policy/itm.py:step`` at B = 1 on ``device``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vlfm_tpu_torch.adapters.habitat import HabitatVLFMAgent
from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.runner import log_saver
from vlfm_tpu_torch.utils.video import write_video
from vlfm_tpu_torch.utils.visualization import add_text_to_image

# SemExp / Gibson ObjectNav categories (the 6 COCO-overlap classes)
GIBSON_ID_TO_NAME = ["chair", "couch", "potted plant", "bed", "toilet", "tv"]

STOP_ACTION = 0


def merge_obs_infos(obs: np.ndarray, infos: Tuple[Dict, ...]) -> Dict[str, Any]:
    """(1, 4, H, W) stack + infos -> the policy's observation dict
    (eval.py:128-148)."""
    rgb = np.transpose(obs[0, :3], (1, 2, 0)).astype(np.uint8)
    depth = np.transpose(obs[0, 3:4], (1, 2, 0))[..., 0].astype(np.float32)
    info = infos[0]
    return {
        "rgb": rgb,
        "depth": depth,
        "objectgoal": str(info["goal_name"]).replace("-", " "),
        "gps": np.asarray(info["gps"], np.float32),
        "compass": np.asarray(info["compass"], np.float32),
        "heading": np.asarray(info["heading"], np.float32),
    }


class SemExpVLFMAgent:
    """SemExp-protocol agent: observation dicts (the goal as a name, not an
    id) -> action.

    The SemExpITMPolicyV2/V3 role; V3 is selected the reference's way,
    through the EXPLORATION_THRESH environment variable (eval.py:63-71)."""

    def __init__(self, cfg: VLFMConfig, spec: GridSpec2D, pointnav, perceive, version: Optional[str] = None,
                 device: torch.device | str = default_device()):
        exp_thresh = float(os.environ.get("EXPLORATION_THRESH", 0.0))
        if version is None:
            version = "v3" if exp_thresh > 0.0 else "v2"
        if version == "v3" and exp_thresh > 0.0:
            cfg = dataclasses.replace(
                cfg,
                exploration_thresh=exp_thresh,
                text_prompt=("Seems like there is a target_object ahead.|"
                             "There is a lot of area to explore ahead."),
            )
        self._inner = HabitatVLFMAgent(cfg, spec, pointnav, perceive, version=version, device=device)
        self.version = version
        self.cfg = cfg

    def reset(self) -> None:
        self._inner.reset()

    @property
    def spec(self):
        return self._inner.spec

    @property
    def state(self):
        return self._inner.state

    @property
    def last_info(self):
        return self._inner.last_info

    def act(self, obs: Dict[str, Any]) -> int:
        # the habitat agent's step with a name-keyed target: SemExp hands
        # names where habitat hands ids
        target = obs["objectgoal"]
        inner = self._inner
        orig = inner.adapter.target_object
        inner.adapter.target_object = lambda o: target
        try:
            return inner.act(obs)
        finally:
            inner.adapter.target_object = orig


def evaluate_semexp(
    envs,
    agent: SemExpVLFMAgent,
    num_episodes: int,
    max_episode_length: int = 500,
    *,
    log_dir: Optional[str] = None,
    video_dir: Optional[str] = None,
    print_fn=print,
) -> List[Dict[str, Any]]:
    """The eval loop of semexp_env/eval.py:78-126: step-0 episode identity,
    the already-evaluated fast-forward with a STOP action, per-episode logs
    and named videos."""
    results = []
    obs, infos = envs.reset()
    for _ in range(num_episodes):
        vis_frames = []
        agent.reset()
        ep_id = scene_id = target_object = ""
        skipped = False
        for step in range(max_episode_length):
            if step == 0:
                ep_id, scene_id = infos[0]["episode_id"], infos[0]["scene_id"]
                target_object = infos[0]["goal_name"]
                print_fn(f"Episode: {ep_id} Scene: {scene_id}")

            if log_dir and log_saver.is_evaluated(ep_id, scene_id, log_dir):
                print_fn(f"Episode {ep_id} in scene {scene_id} already evaluated")
                # fast-forward with STOP; this process did not evaluate the
                # episode, so its 1-step metrics stay out of the results
                # (another shard owns them, semexp eval.py:90-93)
                skipped = True
                obs, rew, done, infos = envs.step(STOP_ACTION)
            else:
                obs_dict = merge_obs_infos(obs, infos)
                action = agent.act(obs_dict)
                if video_dir:
                    vis_frames.append(add_text_to_image(obs_dict["rgb"].copy(), f"Step: {step}", top=True))
                obs, rew, done, infos = envs.step(int(action))

            if done:
                if skipped:
                    break
                data = {
                    "success": infos[0]["success"],
                    "spl": infos[0]["spl"],
                    "distance_to_goal": infos[0]["distance_to_goal"],
                    "target_object": target_object,
                }
                print_fn(f"Success: {data['success']}  SPL: {data['spl']}")
                if video_dir and vis_frames:
                    # the reference's file name schema (eval.py:188-195)
                    name = (f"epid={int(ep_id):03d}-scid={scene_id}"
                            f"-succ={int(data['success'])}-spl={data['spl']:.2f}"
                            f"-dtg={data['distance_to_goal']:.2f}"
                            f"-target={target_object}.mp4")
                    write_video(vis_frames, os.path.join(video_dir, name), fps=10)
                if log_dir and not log_saver.is_evaluated(ep_id, scene_id, log_dir):
                    log_saver.log_episode(ep_id, scene_id, data, log_dir)
                results.append({"episode_id": ep_id, "scene_id": scene_id, **data})
                break
    return results


class FakeSemExpVecEnv:
    """``runner/fake_env.FakeObjectNavEnv`` behind the SemExp vec-env
    protocol (a test double)."""

    def __init__(self, env_factory, num_episodes: int, goal_name: str = "toilet"):
        self._factory = env_factory
        self._i = 0
        self._n = num_episodes
        self._goal = goal_name
        self._env = None

    def _info(self, o, done: bool) -> Dict[str, Any]:
        e = self._env
        info = {
            "episode_id": str(self._i),
            "scene_id": "fake_scene",
            "goal_name": self._goal,
            "gps": np.array([o["robot_xy"][0], -o["robot_xy"][1]], np.float32),
            "compass": np.array([o["heading"]], np.float32),
            "heading": np.array([o["heading"]], np.float32),
        }
        if done:
            shortest = e.shortest_path_length()
            success = e.called_stop and o["distance_to_goal"] <= e.cfg.success_radius
            denom = max(e.path_length, shortest, 1e-6)
            info.update(
                success=float(success),
                spl=float(success) * shortest / denom,
                distance_to_goal=o["distance_to_goal"],
            )
        return info

    def _stack(self, o) -> np.ndarray:
        rgb = np.transpose(o["rgb"], (2, 0, 1)).astype(np.float32)
        depth = o["depth"][None]
        return np.concatenate([rgb, depth], axis=0)[None]

    def reset(self):
        self._env = self._factory(self._i)
        o = self._env.reset()
        return self._stack(o), (self._info(o, False),)

    def step(self, action):
        o = self._env.step(int(action))
        done = bool(o["done"])
        info = self._info(o, done)
        if done and self._i + 1 < self._n:
            # auto-reset: the done step's info keeps the finished episode's
            # metrics but carries the next episode's identity (the loop
            # reads episode_id from it at the next step 0, eval.py:84-86)
            metrics = {k: info[k] for k in ("success", "spl", "distance_to_goal")}
            self._i += 1
            self._env = self._factory(self._i)
            o = self._env.reset()
            info = {**self._info(o, False), **metrics}
        return self._stack(o), 0.0, done, (info,)
