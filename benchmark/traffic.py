"""Traffic made from a mix file and the run's seed: one general generator.

A mix (``benchmark/workloads/<name>.json``) names its ``driver`` and the
parameters below; nothing here knows a cell. The scenes are the frozen
copy in ``benchmark/frozen`` (``runner/fake_env.py``), so later changes
to the port cannot move them.

``replay_pool``: ``episodes`` episodes of exactly ``steps`` frames each, every
one the ``spin``-turn spin and then its scene's own oracle path
(``FakeObjectNavEnv.oracle_action``); where the oracle would STOP, the agent
turns left instead, so every episode has the same length whatever the seed
and the seed changes only which frames are shown. Scenes alternate through
``plans``; each scene's layout is drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.frozen.runner import fake_env

STOP, TURN_LEFT = 0, 2


def episode_seeds(seed: int, n: int, salt: int = 0) -> List[int]:
    """``n`` scene seeds drawn from the run's seed (any whole number)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), salt])
    return [int(s) for s in rng.integers(0, 1 << 31, size=n)]


def replay_pool(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """[{"depth" (T, H, W) f32, "rgb" (T, H, W, 3) u8, "heading" (T,) f32,
    "xy" (T, 2) f32, "seed": int}] for the mix's episodes, T = ``steps``."""
    env_cfg = fake_env.EnvConfig(**mix.get("env", {}))
    pool = []
    for e, s in enumerate(episode_seeds(seed, mix["episodes"])):
        plan = getattr(fake_env, mix["plans"][e % len(mix["plans"])])(seed=s)
        env = fake_env.FakeObjectNavEnv(plan, env_cfg)
        frames = [env.reset()]
        for k in range(mix["steps"] - 1):
            action = TURN_LEFT if k < mix["spin"] else env.oracle_action()
            frames.append(env.step(TURN_LEFT if action == STOP else action))
        pool.append(dict(
            depth=np.stack([f["depth"] for f in frames]).astype(np.float32),
            rgb=np.stack([f["rgb"] for f in frames]),
            heading=np.asarray([f["heading"] for f in frames], np.float32),
            xy=np.stack([f["robot_xy"] for f in frames]).astype(np.float32),
            seed=s % (1 << 31),
        ))
    return pool


class LaneSchedule:
    """Which episode and frame each lane shows at each dispatch.

    Lane i starts on episode i at frame ``stagger * i`` (mod the episode
    length), so lanes reach their episode ends at different dispatches; a
    lane that has shown its episode's last frame takes the next episode not
    yet started (round the pool), from frame 0, with its reset flag set."""

    def __init__(self, lanes: int, episodes: int, steps: int, stagger: int):
        self.steps, self.episodes = steps, episodes
        self.episode = list(range(lanes))
        self.frame = [(stagger * i) % steps for i in range(lanes)]
        self.reset = [True] * lanes  # the first dispatch starts every lane anew
        self.next_episode = lanes

    def current(self):
        """[(episode % pool size, frame, reset)] per lane, for this dispatch."""
        return [(e % self.episodes, f, r) for e, f, r in zip(self.episode, self.frame, self.reset)]

    def advance(self) -> None:
        for i in range(len(self.frame)):
            self.reset[i] = False
            self.frame[i] += 1
            if self.frame[i] == self.steps:
                self.episode[i], self.frame[i], self.reset[i] = self.next_episode, 0, True
                self.next_episode += 1
