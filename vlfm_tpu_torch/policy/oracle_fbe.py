"""Oracle FBE baseline policies: the port's copy of
``vlfm_tpu/policy/oracle_fbe.py``, the reference's debugging / upper-bound
baselines (vlfm/policy/habitat_policies.py:240-261).

- **OracleFBEPolicy** role: explore-mode actions come from classic
  frontier-based exploration instead of ITM value scoring. In the port this
  is ``policy/itm.py:step(..., version="fbe")`` (nearest frontier wins;
  initialize / navigate / STOP machinery unchanged), available from every
  driver and ``run.py --version fbe``.
- **SuperOracleFBEPolicy** role: EVERY action comes from the environment's
  shortest-path follower — the reference passes through the
  frontier_exploration ``BaseExplorer`` sensor's action
  (habitat_policies.py:248-261). ``FakeObjectNavEnv.oracle_action()`` plays
  the sensor's part here (BFS geodesic descent + turn-toward controller).

Host-side: no tensor is touched.
"""

from __future__ import annotations

from typing import Optional

from vlfm_tpu_torch.runner import metrics as M


class SuperOracleFBEPolicy:
    """Pass-through of the env-provided oracle action (the reference returns
    ``observations[BaseExplorer.cls_uuid]`` verbatim)."""

    def act(self, observations) -> int:
        return int(observations["oracle_action"])

    def reset(self) -> None:  # stateless, mirrors the reference's no-op state
        pass


def run_super_oracle_episode(env, max_steps: Optional[int] = None):
    """Drive one episode entirely on the env's shortest-path follower.

    The upper-bound baseline: perfect exploration and stopping, no
    perception. Returns an EpisodeResult (success should be ~1 on feasible
    plans — useful for sanity-checking env + metrics plumbing).
    """
    env.reset()
    policy = SuperOracleFBEPolicy()
    limit = max_steps or env.cfg.max_steps
    shortest = env.shortest_path_length()
    o = env._observe()
    while not o["done"] and env.steps < limit:
        action = policy.act({"oracle_action": env.oracle_action()})
        o = env.step(action)
    return M.compute_result(
        called_stop=env.called_stop,
        distance_to_goal=o["distance_to_goal"],
        success_radius=env.cfg.success_radius,
        shortest_path=shortest,
        path_length=env.path_length,
        steps=env.steps,
        max_steps=limit,
        target_detected=True,  # the oracle knows the target location
        target_seen=True,
        collisions=env.collisions,
    )
