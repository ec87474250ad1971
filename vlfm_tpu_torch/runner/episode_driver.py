"""Host-side episode drivers: the batched policy step against environments.

Counterpart of ``vlfm_tpu/runner/episode_driver.py`` (reference: the
VLFMTrainer eval loop, vlfm_trainer.py:164-325). The policy step runs on
the device for all lanes at once; per step the host makes one
host-to-device copy (the lanes' depth, pose, cosine and oracle target mask,
packed into one byte buffer) and one device-to-host read (each lane's
action, ``target_detected`` and goal, packed into one (B, 4) tensor).

Which perception each driver takes:

- the environment's oracle (its cosine on every prompt channel and its
  target mask as detection 0): ``run_episode``, ``run_episodes_batched``,
  ``run_episodes_recycled`` here, and ``runner/sim_farm.py``'s
  ``run_episodes_farm`` without ``perception``;
- the real models (BLIP2-ITM, OWL-ViT with the COCO route, gated
  MobileSAM): ``runner/full_stack.py``'s ``run_full_stack_episode`` and
  ``make_fused_step``, and ``run_episodes_farm`` with ``perception``.

Keys:

- ``run_episode``: one episode (B = 1), keys ``fold_in(PRNGKey(seed), step)``.
- ``run_episodes_batched``: N episodes in lockstep; a finished lane idles
  until all are done; keys ``split(split(rng)[1], N)`` per step.
- ``run_episodes_recycled``: continuous batching; a finished lane is reset
  in place (a per-lane ``torch.where`` against a fresh episode) and takes
  the next episode; keys ``fold_in(PRNGKey(episode seed), step)``
  (``step_keys``), so a recycled lane reproduces a fresh ``run_episode``,
  and so do the full-stack drivers and the farm.

The helpers the drivers share with ``full_stack.py`` and ``sim_farm.py``:
``observation`` (device pose and depth to an ``Observation``),
``step_keys``, ``pack_outputs`` / ``read_back`` (the (B, 4) output) and
``episode_result`` (the reference's taxonomy).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.pointnav import PointNavPolicy
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.policy import itm
from vlfm_tpu_torch.runner import metrics as M
from vlfm_tpu_torch.runner.fake_env import FakeObjectNavEnv
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix
from vlfm_tpu_torch.utils.measurements import TraveledStairs


@dataclass
class DriverStats:
    env_steps: int = 0
    wall_time: float = 0.0
    final_state: object = None  # set when run_episode(keep_state=True)

    @property
    def steps_per_sec(self) -> float:
        return self.env_steps / self.wall_time if self.wall_time else 0.0


def observation(depth: torch.Tensor, xy: torch.Tensor, heading: torch.Tensor, cfg: VLFMConfig) -> itm.Observation:
    """(B, H, W) depth, (B, 2) position and (B,) heading on the device ->
    the step's ``Observation``, the camera at ``cfg.camera.camera_height``."""
    xyz = torch.stack([xy[:, 0], xy[:, 1], torch.full_like(heading, cfg.camera.camera_height)])
    return itm.Observation(
        depth=depth,
        tf_camera_to_episodic=xyz_yaw_to_tf_matrix(xyz, heading).permute(2, 0, 1),
        robot_xy=xy,
        robot_heading=heading,
    )


def step_keys(seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """(B, 2) keys ``fold_in(PRNGKey(seed), step)`` from (B,) integer
    tensors, computed on their device: each episode's stream, whatever lane
    or batch it runs in."""
    return threefry.fold_in(threefry.PRNGKey(seeds), steps)


def step_inputs(obs_list, cfg: VLFMConfig, device):
    """The lanes' observations on the device from one copy: (Observation,
    (B, C) cosines, (B, K, H, W) masks, (B, K) valid). Each lane's cosine
    goes on every prompt channel and its oracle target mask, when the
    target is visible, in detection slot 0."""
    b = len(obs_list)
    h, w = obs_list[0]["depth"].shape
    floats = np.empty((b, h * w + 4), np.float32)  # depth, x, y, heading, cosine
    for i, o in enumerate(obs_list):
        floats[i, : h * w] = o["depth"].reshape(-1)
        floats[i, h * w :] = (o["robot_xy"][0], o["robot_xy"][1], o["heading"], o["cosine"])
    flags = np.zeros((b, h * w + 1), np.uint8)  # target mask, target visible
    for i, o in enumerate(obs_list):
        if o["target_visible"]:
            flags[i, : h * w] = o["target_mask"].reshape(-1)
            flags[i, -1] = 1
    host = np.concatenate([floats.view(np.uint8).reshape(-1), flags.reshape(-1)])
    dev = torch.from_numpy(host).to(device)
    n_float = floats.size * 4
    fl = dev[:n_float].view(torch.float32).reshape(b, h * w + 4)
    fg = dev[n_float:].reshape(b, h * w + 1).to(torch.bool)
    obs = observation(fl[:, : h * w].reshape(b, h, w), fl[:, h * w : h * w + 2], fl[:, h * w + 2], cfg)
    cosines = fl[:, h * w + 3, None].expand(b, cfg.value_channels)
    k = cfg.max_detections_per_frame
    masks = torch.zeros((b, k, h, w), dtype=torch.bool, device=device)
    masks[:, 0] = fg[:, : h * w].reshape(b, h, w)
    valid = torch.zeros((b, k), dtype=torch.bool, device=device)
    valid[:, 0] = fg[:, -1]
    return obs, cosines, masks, valid


def pack_outputs(action: torch.Tensor, info: itm.StepInfo) -> torch.Tensor:
    """(B, 4) f32 on the device: each lane's action, target_detected and
    goal (small integers are exact in f32)."""
    return torch.cat([action[:, None].to(torch.float32), info.target_detected[:, None].to(torch.float32),
                      info.goal], dim=1)


def read_back(action: torch.Tensor, info: itm.StepInfo) -> np.ndarray:
    """(B, 4) host array of each lane's action, target_detected and goal,
    from one device-to-host read."""
    return pack_outputs(action, info).cpu().numpy()


def episode_result(*, called_stop, distance_to_goal, success_radius, shortest_path, path_length, steps,
                   max_steps, collisions, feasible, target, target_radius, detected, seen, stairs, last_goal,
                   explored, spec):
    """The episode's result with the reference's taxonomy inputs
    (episode_stats_logger.py:44-111): map-based 'seen' (the lane's explored
    area, a device tensor of which only the target's window is read, covers
    the target) and the nav-goal-in-target-bbox false-positive test."""
    seen_map = M.was_target_seen(explored, spec, target) if target is not None else False
    fp = None
    if target is not None and detected and last_goal is not None:
        fp = M.was_false_positive(last_goal, target, target_radius)
    return M.compute_result(
        called_stop=called_stop,
        distance_to_goal=distance_to_goal,
        success_radius=success_radius,
        shortest_path=shortest_path,
        path_length=path_length,
        steps=steps,
        max_steps=max_steps,
        target_detected=detected,
        target_seen=seen or seen_map,
        collisions=collisions,
        false_positive=fp,
        traveled_stairs=stairs.traveled_stairs,
        feasible=feasible,
    )


def env_result(env, final_obs, shortest, limit, **taxonomy):
    """``episode_result`` of an environment at its episode's end."""
    target = getattr(env.plan, "target", None) if hasattr(env, "plan") else None
    return episode_result(
        called_stop=env.called_stop, distance_to_goal=final_obs["distance_to_goal"],
        success_radius=env.cfg.success_radius, shortest_path=shortest, path_length=env.path_length,
        steps=env.steps, max_steps=limit, collisions=env.collisions,
        feasible=getattr(env, "path_feasible", True), target=target,
        target_radius=env.plan.target_radius if target is not None else 0.0, **taxonomy)


def run_episodes_recycled(
    env_factory,
    episode_seeds,
    lanes: int,
    pointnav,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    *,
    version: str = "v2",
    max_steps: Optional[int] = None,
    device: torch.device | str = default_device(),
):
    """Continuous batching: a finished lane is reset in place and takes the
    next episode from the queue, so the batch never shrinks while episodes
    remain (the reference's envs_to_pause shrinking, vlfm_trainer.py:
    232-246, does not exist here). An idle lane, once the queue is empty,
    steps on its last observation and is reset after every step.

    ``env_factory(seed) -> env``. Returns ({seed: EpisodeResult}, DriverStats)."""
    bstate = itm.create_state(spec, cfg, batch=lanes, device=device)
    queue = list(episode_seeds)
    if lanes > len(queue):
        raise ValueError("need at least one episode per lane")
    lane_seed = [queue.pop(0) for _ in range(lanes)]
    lane_env = [env_factory(s) for s in lane_seed]
    lane_active = [True] * lanes
    obs_list = [e.reset() for e in lane_env]
    shortest = [e.shortest_path_length() for e in lane_env]
    lane_step = [0] * lanes
    seen = [False] * lanes
    detected = [False] * lanes
    stairs = [TraveledStairs() for _ in range(lanes)]
    last_goal = [None] * lanes
    limit = max_steps or lane_env[0].cfg.max_steps

    results = {}
    stats = DriverStats()
    t0 = time.time()
    while any(lane_active):
        obs, cos, masks, valid = step_inputs(obs_list, cfg, device)
        keys = step_keys(torch.tensor(lane_seed, device=device), torch.tensor(lane_step, device=device))
        action, info, bstate = itm.step(bstate, obs, cos, masks, valid, keys,
                                        pointnav=pointnav, spec=spec, cfg=cfg, version=version)
        back = read_back(action, info)

        done_mask = np.zeros(lanes, bool)
        for i in range(lanes):
            if not lane_active[i]:
                done_mask[i] = True  # keep idle lanes fresh
                continue
            o = obs_list[i]
            seen[i] = seen[i] or o["target_visible"]
            detected[i] = detected[i] or bool(back[i, 1])
            stairs[i].update(o.get("agent_z", 0.0))
            last_goal[i] = back[i, 2:]
            obs_list[i] = lane_env[i].step(int(back[i, 0]))
            lane_step[i] += 1
            stats.env_steps += 1
            if obs_list[i]["done"] or lane_step[i] >= limit:
                results[lane_seed[i]] = env_result(
                    lane_env[i], obs_list[i], shortest[i], limit, detected=detected[i], seen=seen[i],
                    stairs=stairs[i], last_goal=last_goal[i], explored=bstate.obstacle.explored[i], spec=spec)
                done_mask[i] = True
                if queue:  # recycle the lane in place
                    lane_seed[i] = queue.pop(0)
                    lane_env[i] = env_factory(lane_seed[i])
                    obs_list[i] = lane_env[i].reset()
                    shortest[i] = lane_env[i].shortest_path_length()
                    lane_step[i] = 0
                    seen[i] = detected[i] = False
                    stairs[i] = TraveledStairs()
                    last_goal[i] = None
                else:
                    lane_active[i] = False
        if done_mask.any():
            bstate = itm.reset_lanes(bstate, torch.from_numpy(done_mask).to(device))
    stats.wall_time = time.time() - t0
    return results, stats


def run_episodes_batched(
    envs: List[FakeObjectNavEnv],
    pointnav,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    *,
    version: str = "v2",
    max_steps: Optional[int] = None,
    seed: int = 0,
    device: torch.device | str = default_device(),
):
    """N episodes in lockstep, one batched step per env step; a finished
    episode idles (its action is ignored) until the whole batch is done.

    Returns (results, DriverStats), the stats counting active env steps."""
    batch = len(envs)
    limit = max_steps or envs[0].cfg.max_steps
    bstate = itm.create_state(spec, cfg, batch=batch, device=device)
    obs_list = [e.reset() for e in envs]
    shortest = [e.shortest_path_length() for e in envs]
    target_seen = [False] * batch
    target_detected = [False] * batch
    rng = threefry.PRNGKey(seed, device=device)
    stats = DriverStats()
    t0 = time.time()
    while not all(o["done"] for o in obs_list):
        obs, cos, masks, valid = step_inputs(obs_list, cfg, device)
        rng, sub = threefry.split(rng)
        action, info, bstate = itm.step(bstate, obs, cos, masks, valid, threefry.split(sub, batch),
                                        pointnav=pointnav, spec=spec, cfg=cfg, version=version)
        back = read_back(action, info)
        for i, (env, o) in enumerate(zip(envs, obs_list)):
            if o["done"]:
                continue
            target_seen[i] = target_seen[i] or o["target_visible"]
            target_detected[i] = target_detected[i] or bool(back[i, 1])
            obs_list[i] = env.step(int(back[i, 0]))
            stats.env_steps += 1
    stats.wall_time = time.time() - t0
    results = [
        M.compute_result(
            called_stop=e.called_stop,
            distance_to_goal=o["distance_to_goal"],
            success_radius=e.cfg.success_radius,
            shortest_path=shortest[i],
            path_length=e.path_length,
            steps=e.steps,
            max_steps=limit,
            target_detected=target_detected[i],
            target_seen=target_seen[i],
            collisions=e.collisions,
        )
        for i, (e, o) in enumerate(zip(envs, obs_list))
    ]
    return results, stats


def run_episode(
    env: FakeObjectNavEnv,
    pointnav: PointNavPolicy | str,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    *,
    version: str = "v2",
    max_steps: Optional[int] = None,
    seed: int = 0,
    on_step: Optional[Callable] = None,
    keep_state: bool = False,
    device: torch.device | str = default_device(),
) -> tuple:
    """One episode to its end, as one lane (B = 1). ``on_step(env, obs,
    info, state)`` sees every step; ``keep_state`` keeps the final state in
    the stats. Returns (EpisodeResult, DriverStats)."""
    o = env.reset()
    state = itm.create_state(spec, cfg, device=device)
    stats = DriverStats()
    target_seen = target_detected = False
    stairs = TraveledStairs()
    last_goal = None
    limit = max_steps or env.cfg.max_steps
    shortest = env.shortest_path_length()
    key = threefry.PRNGKey(seed, device=device)
    t0 = time.time()
    while not o["done"] and env.steps < limit:
        stairs.update(o.get("agent_z", 0.0))
        obs, cos, masks, valid = step_inputs([o], cfg, device)
        # per-(episode, step) key: the recycled driver's stream
        sub = threefry.fold_in(key, stats.env_steps)[None]
        action, info, state = itm.step(state, obs, cos, masks, valid, sub,
                                       pointnav=pointnav, spec=spec, cfg=cfg, version=version)
        back = read_back(action, info)
        target_seen = target_seen or o["target_visible"]
        target_detected = target_detected or bool(back[0, 1])
        if on_step is not None:
            on_step(env, o, info, state)
        last_goal = back[0, 2:]
        o = env.step(int(back[0, 0]))
        stats.env_steps += 1
    stats.wall_time = time.time() - t0
    if keep_state:
        stats.final_state = state
    result = env_result(env, o, shortest, limit, detected=target_detected, seen=target_seen, stairs=stairs,
                        last_goal=last_goal, explored=state.obstacle.explored[0], spec=spec)
    return result, stats
