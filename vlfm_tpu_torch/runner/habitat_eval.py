"""Habitat-protocol evaluation loop.

Counterpart of ``vlfm_tpu/runner/habitat_eval.py`` (reference:
VLFMTrainer._eval_checkpoint's eval loop, vlfm/utils/vlfm_trainer.py:164-325):
episode iteration with ledger-based claims (multi-process sharding),
reset/step against the habitat Env duck type, per-episode stats + running
success print, failure-cause logging, video generation with the
reference's one-step-delayed map collection.

The loop runs against the PROTOCOL, not habitat itself:

    env.reset() -> obs dict {rgb, depth, gps, compass, objectgoal}
    env.step(action) -> obs dict
    env.episode_over -> bool
    env.get_metrics() -> {success, spl, soft_spl, distance_to_goal, ...}
    env.current_episode -> object with episode_id / scene_id / object_category

``make_habitat_env`` builds the real habitat env (fails only at
``import habitat`` when habitat-lab is absent); ``FakeHabitatEnv`` backs the
same protocol with the synthetic FakeObjectNavEnv so the loop runs
offline. Everything here is host code but ``render_policy_maps``, which
reads the agent's lane of device state into numpy, and the agent's step.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from vlfm_tpu_torch.runner import log_saver
from vlfm_tpu_torch.runner import metrics as M
from vlfm_tpu_torch.runner.fake_env import FakeObjectNavEnv
from vlfm_tpu_torch.utils.video import VideoCollector, write_video

HM3D_NAME_TO_ID = {"chair": 0, "bed": 1, "potted plant": 2, "toilet": 3, "tv": 4, "couch": 5}


@dataclass
class FakeEpisode:
    episode_id: str
    scene_id: str
    object_category: str


class FakeHabitatEnv:
    """FakeObjectNavEnv behind the habitat Env duck type."""

    def __init__(self, env: FakeObjectNavEnv, episode_id: str = "0",
                 scene_id: str = "fake_scene", object_category: str = "toilet"):
        self._env = env
        self.current_episode = FakeEpisode(episode_id, scene_id, object_category)
        self._shortest = env.shortest_path_length()
        self._target_seen = False

    def reset(self) -> Dict[str, Any]:
        return self._to_habitat(self._env.reset())

    def step(self, action: int) -> Dict[str, Any]:
        return self._to_habitat(self._env.step(int(action)))

    @property
    def episode_over(self) -> bool:
        return self._env.done

    def _to_habitat(self, o: Dict[str, Any]) -> Dict[str, Any]:
        self._target_seen = self._target_seen or o["target_visible"]
        # habitat gps: (x, y) with y NEGATED relative to the episodic frame
        # (the adapter flips it back, habitat_policies.py:186-187)
        return {
            "rgb": o["rgb"],
            "depth": o["depth"][..., None],
            "gps": np.array([o["robot_xy"][0], -o["robot_xy"][1]], np.float32),
            "compass": np.array([o["heading"]], np.float32),
            # the synthetic env's episodic frame IS the global frame, so the
            # heading sensor coincides with the compass here; real habitat's
            # compass is 0 at reset while heading carries the global yaw
            "heading": np.array([o["heading"]], np.float32),
            "objectgoal": np.array(
                [HM3D_NAME_TO_ID[self.current_episode.object_category]], np.int64
            ),
        }

    def get_metrics(self) -> Dict[str, Any]:
        e = self._env
        o = e._observe()
        success = e.called_stop and o["distance_to_goal"] <= e.cfg.success_radius
        denom = max(e.path_length, self._shortest, 1e-6)
        spl = float(success) * self._shortest / denom
        progress = max(0.0, 1.0 - o["distance_to_goal"] / max(self._shortest, 1e-6))
        return {
            "success": float(success),
            "spl": spl,
            "soft_spl": progress * self._shortest / denom,
            "distance_to_goal": o["distance_to_goal"],
            "called_stop": e.called_stop,
            "steps": e.steps,
            "max_steps": e.cfg.max_steps,
            "target_seen": self._target_seen,
            "shortest_path": self._shortest,
            "path_length": e.path_length,
            "success_radius": e.cfg.success_radius,
        }


DEFAULT_HABITAT_CONFIG = "benchmark/nav/objectnav/objectnav_hm3d.yaml"
# Discrete ObjectNav action order — STOP/FORWARD/LEFT/RIGHT, the ordering
# TorchActionIDs encodes (habitat_policies.py:54-58).
ACTION_NAMES = ("stop", "move_forward", "turn_left", "turn_right")


def _dilate_bool(mask: np.ndarray, k: int) -> np.ndarray:
    """Boolean dilation by a (2k+1) square via an integral image — the role of
    cv2.dilate(mask, np.ones((10, 10))) in episode_stats_logger.py:78."""
    m = np.asarray(mask, bool)
    pad = np.zeros((m.shape[0] + 2 * k + 1, m.shape[1] + 2 * k + 1), np.int64)
    pad[k + 1 : k + 1 + m.shape[0], k + 1 : k + 1 + m.shape[1]] = m
    ii = pad.cumsum(0).cumsum(1)
    w = 2 * k + 1
    tot = (
        ii[w:, w:] - ii[:-w, w:] - ii[w:, :-w] + ii[:-w, :-w]
    )[: m.shape[0], : m.shape[1]]
    return tot > 0


def habitat_target_seen(top_down_map: Dict[str, Any]) -> bool:
    """episode_stats_logger.was_target_seen (:75-81): fog-of-war overlap with
    the 10-px-dilated target bounding boxes on the habitat top-down map."""
    bboxes = top_down_map.get("target_bboxes_mask")
    fog = top_down_map.get("fog_of_war_mask")
    if bboxes is None or fog is None:
        return False
    return bool(np.logical_and(np.asarray(fog, bool), _dilate_bool(bboxes, 5)).any())


def _xyz_to_habitat(points: np.ndarray) -> np.ndarray:
    """Episodic-global (x fwd, y left, z up) -> habitat axes (y up, -z fwd):
    the role of frontier_exploration.utils.general_utils.xyz_to_habitat as
    consumed at episode_stats_logger.py:97."""
    p = np.asarray(points, np.float64)
    return np.stack([-p[:, 1], p[:, 2], -p[:, 0]], axis=1)


def _sim_xy_to_grid_xy(upper_bound, lower_bound, grid_resolution, sim_xy):
    """habitat_visualizer.sim_xy_to_grid_xy (:195-225): habitat-sim (z, x)
    coordinates -> top-down-map grid indices."""
    lower = np.asarray(lower_bound, np.float64)
    upper = np.asarray(upper_bound, np.float64)
    grid_size = np.array(
        [
            abs(upper[1] - lower[1]) / grid_resolution[0],
            abs(upper[0] - lower[0]) / grid_resolution[1],
        ]
    )
    return ((np.asarray(sim_xy, np.float64) - lower[::-1]) / grid_size).astype(int)


def habitat_false_positive(top_down_map: Dict[str, Any], nav_goal_xy) -> Optional[bool]:
    """episode_stats_logger.was_false_positive (:84-111): is the final nav
    goal OUTSIDE every target bounding box on the habitat top-down map?
    Returns None when the map measure lacks the required fields."""
    needed = ("target_bboxes_mask", "upper_bound", "lower_bound",
              "grid_resolution", "tf_episodic_to_global")
    if any(top_down_map.get(k) is None for k in needed):
        return None
    goal = np.asarray(nav_goal_xy, np.float64)[:2]
    goal_xyz = np.array([[goal[0], goal[1], 0.0]])
    tf = np.asarray(top_down_map["tf_episodic_to_global"], np.float64)
    global_xyz = (tf @ np.concatenate([goal_xyz, np.ones((1, 1))], axis=1).T).T[:, :3]
    hab = _xyz_to_habitat(global_xyz)
    grid_xy = _sim_xy_to_grid_xy(
        top_down_map["upper_bound"],
        top_down_map["lower_bound"],
        top_down_map["grid_resolution"],
        hab[:, [2, 0]],
    )
    bboxes = np.asarray(top_down_map["target_bboxes_mask"])
    r, c = int(grid_xy[0, 0]), int(grid_xy[0, 1])
    if not (0 <= r < bboxes.shape[0] and 0 <= c < bboxes.shape[1]):
        return True  # goal off the map -> assumed false positive (:108-111)
    return bool(bboxes[r, c] == 0)


class HabitatEnvWrapper:
    """A real ``habitat.Env`` behind the protocol at the top of this module.

    Mirrors the per-step observation/metrics traffic of the reference's eval
    loop (vlfm_trainer.py:164-325) for one env, and supplies the failure
    taxonomy inputs of episode_stats_logger.py:44-111 (map-based target-seen,
    nav-goal false-positive test, traveled-stairs, feasibility).
    """

    def __init__(
        self,
        env,
        *,
        success_radius: float = 0.2,
        max_steps: int = 500,
        pass_action_names: bool = False,
    ):
        self._env = env
        self._radius = float(success_radius)
        self._max_steps = int(max_steps)
        self._pass_names = pass_action_names
        self._steps = 0
        self._path = 0.0
        self._last_gps: Optional[np.ndarray] = None
        self._called_stop = False
        self._pending_obs: Optional[Dict[str, Any]] = None

    def advance(self) -> "HabitatEnvWrapper":
        """Advance the underlying env to its next episode. habitat assigns
        episodes on reset, but the eval loop reads ``current_episode`` BEFORE
        reset for ledger claims — so the env factory calls advance() and the
        subsequent reset() consumes the buffered observations."""
        self._pending_obs = self._env.reset()
        return self

    @property
    def current_episode(self):
        ep = self._env.current_episode
        category = getattr(ep, "object_category", "") or ""
        return FakeEpisode(str(ep.episode_id), str(ep.scene_id), category)

    @property
    def episode_over(self) -> bool:
        return bool(self._env.episode_over)

    def reset(self) -> Dict[str, Any]:
        self._steps = 0
        self._path = 0.0
        self._called_stop = False
        obs = self._pending_obs if self._pending_obs is not None else self._env.reset()
        self._pending_obs = None
        self._last_gps = np.asarray(obs["gps"], np.float64)[:2]
        return self._adapt(obs)

    def step(self, action: int) -> Dict[str, Any]:
        action = int(action)
        self._called_stop = self._called_stop or action == 0
        obs = self._env.step(ACTION_NAMES[action] if self._pass_names else action)
        self._steps += 1
        gps = np.asarray(obs["gps"], np.float64)[:2]
        if self._last_gps is not None:
            self._path += float(np.linalg.norm(gps - self._last_gps))
        self._last_gps = gps
        return self._adapt(obs)

    def _adapt(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        """Normalize dtypes/shapes into the protocol (the role of batch_obs +
        obs extraction in habitat_policies._cache_observations:173-237; the
        gps y-flip itself lives in the policy-side HabitatObsAdapter)."""
        depth = np.asarray(obs["depth"], np.float32)
        if depth.ndim == 2:
            depth = depth[..., None]
        out = {
            "rgb": np.asarray(obs["rgb"], np.uint8),
            "depth": depth,
            "gps": np.asarray(obs["gps"], np.float32)[:2],
            "compass": np.asarray(obs["compass"], np.float32).reshape(1),
            "objectgoal": np.asarray(obs["objectgoal"], np.int64).reshape(1),
        }
        if "heading" in obs:  # global yaw (heading_sensor); start-yaw source
            out["heading"] = np.asarray(obs["heading"], np.float32).reshape(1)
        return out

    def get_metrics(self) -> Dict[str, Any]:
        m = self._env.get_metrics()
        tdm = m.get("top_down_map") or {}
        ep = self._env.current_episode
        shortest = float(
            (getattr(ep, "info", None) or {}).get("geodesic_distance", 0.0)
        )
        return {
            "success": float(m.get("success", 0.0)),
            "spl": float(m.get("spl", 0.0)),
            # habitat's SoftSPL uuid is "softspl"; accept both spellings
            "soft_spl": float(m.get("soft_spl", m.get("softspl", 0.0))),
            "distance_to_goal": float(m.get("distance_to_goal", np.inf)),
            "called_stop": self._called_stop,
            "steps": self._steps,
            "max_steps": self._max_steps,
            "shortest_path": shortest,
            "path_length": self._path,
            "success_radius": self._radius,
            "target_seen": habitat_target_seen(tdm),
            "traveled_stairs": bool(m.get("traveled_stairs", False)),
            "feasible": bool(tdm.get("is_feasible", True)),
        }

    def false_positive(self, nav_goal_xy) -> Optional[bool]:
        tdm = self._env.get_metrics().get("top_down_map") or {}
        return habitat_false_positive(tdm, nav_goal_xy)


def make_habitat_env(
    config_path: Optional[str] = None,
    *,
    overrides: tuple = (),
    pass_action_names: bool = False,
):
    """Build a REAL habitat env for the protocol above. Requires habitat-lab;
    this function is the only place the dependency is touched (the role of
    VLFMTrainer env init, vlfm_trainer.py:99-105, and of vlfm/run.py:37-55's
    config patching)."""
    import habitat

    cfg = habitat.get_config(config_path or DEFAULT_HABITAT_CONFIG, list(overrides))
    from habitat.config import read_write

    with read_write(cfg):
        # drop the semantic sensor exactly like the reference entry
        # (vlfm/run.py:50-54) — VLFM never consumes it
        try:
            cfg.habitat.simulator.agents.main_agent.sim_sensors.pop("semantic_sensor")
        except KeyError:
            pass
    env = habitat.Env(config=cfg)
    hab = cfg.habitat
    radius = float(hab.task.measurements.success.success_distance)
    max_steps = int(hab.environment.max_episode_steps)
    return HabitatEnvWrapper(
        env,
        success_radius=radius,
        max_steps=max_steps,
        pass_action_names=pass_action_names,
    )


def render_policy_maps(
    agent, downsample: int = 2, start_yaw: float = 0.0
) -> List[np.ndarray]:
    """Obstacle + value map renderings of the agent's lane (B = 1) of
    device state, read into numpy, with the detected-target point cloud
    painted onto the obstacle map (habitat_visualizer.color_point_cloud_on_map
    role, :228-253) and both maps reoriented by the episode start yaw
    (_reorient_rescale_habitat_map role, :122-137)."""
    from vlfm_tpu_torch.mapping import object_map as OBJ
    from vlfm_tpu_torch.utils.visualization import (
        paint_target_cloud,
        render_obstacle_map,
        render_value_map,
        rotate_image,
    )

    spec = agent.spec
    st = agent.state

    def grid(t):
        return spec.crop_logical(t[0])[::downsample, ::downsample].cpu().numpy()

    obst_img = render_obstacle_map(
        grid(st.obstacle.obstacles), grid(st.obstacle.navigable), grid(st.obstacle.explored)
    )
    if bool(OBJ.has_object(st.objmap)[0]):
        pts, mask = OBJ.get_target_cloud(st.objmap)
        pts_xy = pts[0][mask[0], :2].cpu().numpy()
        paint_target_cloud(obst_img, spec, pts_xy, downsample=downsample)
    maps = [obst_img, render_value_map(grid(st.value.values).max(axis=-1), spec)]
    if start_yaw != 0.0:
        maps = [rotate_image(m, start_yaw) for m in maps]
    return maps


def evaluate(
    env_factory: Callable[[int], Any],
    agent,
    num_episodes: int,
    *,
    log_dir: Optional[str] = None,
    video_dir: Optional[str] = None,
    print_fn: Callable[[str], None] = print,
) -> List[M.EpisodeResult]:
    """The eval loop (vlfm_trainer.py:164-325 analogue).

    ``env_factory(i)`` yields the i-th episode's env (habitat protocol).
    ``log_dir`` enables ledger claims + per-episode JSON (multi-process
    episode sharding, log_saver role). ``video_dir`` enables per-episode mp4s
    with the reference's one-step-delayed map collection.
    """
    results: List[M.EpisodeResult] = []
    successes = 0
    collector = VideoCollector(maps_delayed=True) if video_dir else None

    for i in range(num_episodes):
        env = env_factory(i)
        ep = env.current_episode
        if log_dir and not log_saver.claim_episode(ep.episode_id, ep.scene_id, log_dir):
            continue  # another worker owns it (log_saver.is_evaluated role)

        obs = env.reset()
        agent.reset()
        # GLOBAL heading sensor, like the reference's habitat_start_yaw
        # (habitat_policies.py:236). The compass is episodic heading and is
        # identically 0 at reset on real habitat — it must NOT be used here
        # (envs without a heading sensor get 0.0, i.e. no reorientation).
        start_yaw = float(np.asarray(obs.get("heading", [0.0])).reshape(-1)[0])
        target_detected = False
        while not env.episode_over:
            action = agent.act(obs)
            target_detected = target_detected or bool(agent.last_info.target_detected[0])
            maps = (
                render_policy_maps(agent, start_yaw=start_yaw) if collector else None
            )
            obs = env.step(action)
            if collector:
                # reference ordering: obs(t+1) collected with policy maps(t)
                # (flush realigns, habitat_visualizer.py:92-97)
                collector.collect(
                    obs["rgb"], obs["depth"][..., 0], maps,
                    [f"target: {ep.object_category}"],
                )

        m = env.get_metrics()
        # nav-goal-in-target-bbox false-positive test when the env can run it
        # (episode_stats_logger.py:84-111); None falls back to the distance
        # heuristic inside compute_result.
        fp = None
        if hasattr(env, "false_positive") and hasattr(agent, "last_info"):
            fp = env.false_positive(agent.last_info.goal[0].cpu().numpy())
        result = M.compute_result(
            called_stop=bool(m["called_stop"]),
            distance_to_goal=float(m["distance_to_goal"]),
            success_radius=_success_radius_from(m),
            success_override=bool(m["success"]) if "success" in m else None,
            shortest_path=float(m["shortest_path"]),
            path_length=float(m["path_length"]),
            steps=int(m["steps"]),
            max_steps=int(m["max_steps"]),
            target_detected=target_detected,
            target_seen=bool(m["target_seen"]),
            false_positive=fp,
            traveled_stairs=bool(m.get("traveled_stairs", False)),
            feasible=bool(m.get("feasible", True)),
        )
        results.append(result)
        successes += int(result.success)
        print_fn(
            f"episode {ep.episode_id}: success={result.success} "
            f"spl={result.spl:.3f} cause={result.failure_cause} "
            f"running_success={successes}/{len(results)}"
        )
        if log_dir:
            log_saver.log_episode(
                ep.episode_id, ep.scene_id,
                {**result.to_dict(), "target_object": ep.object_category},
                log_dir,
            )
        if collector:
            frames = collector.flush(result.failure_cause)
            if frames:
                write_video(
                    frames,
                    os.path.join(video_dir, f"episode_{ep.episode_id}.mp4"),
                )
    return results


def _success_radius_from(m: Dict[str, Any]) -> float:
    # Both provided envs report the radius directly (HabitatEnvWrapper reads
    # it from the task config). A foreign env that only exposes the success
    # bit gets the habitat default radius — its success bit flows through
    # compute_result's success_override, so the radius only feeds the
    # false-positive fallback heuristic, never the success decision.
    return float(m.get("success_radius", 0.2))
