"""Deterministic action recording and replay: the port's copy of
``vlfm_tpu/policy/action_replay.py`` (host-side, standard library only).

Parity target: vlfm/policy/action_replay_policy.py — record the action
sequence of a run (the reference records via VLFM_RECORD_ACTIONS_DIR,
vlfm_trainer.py:175-185), then replay it deterministically, optionally
re-quantizing turn/step sizes when the replay platform uses different motion
primitives (action_replay_policy.py:174-181).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3


class ActionRecorder:
    def __init__(self, directory: Optional[str] = None):
        self.dir = directory or os.environ.get("VLFM_RECORD_ACTIONS_DIR", "action_recordings")
        os.makedirs(self.dir, exist_ok=True)
        self.actions: List[int] = []

    def record(self, action: int) -> None:
        self.actions.append(int(action))

    def flush(self, episode_id="episode") -> str:
        path = os.path.join(self.dir, f"{episode_id}_actions.json")
        with open(path, "w") as f:
            json.dump(self.actions, f)
        return path


def repeat_elements(actions: List[int], factor: int) -> List[int]:
    """Repeat each motion action ``factor`` times (turn/step re-quantization:
    e.g. a 30-degree-turn recording replayed on a 15-degree platform uses
    factor 2). STOP is never repeated."""
    out: List[int] = []
    for a in actions:
        out.extend([a] * (1 if a == STOP else factor))
    return out


class ActionReplayPolicy:
    """Drop-in policy that ignores observations and replays a recording."""

    def __init__(self, path: str, turn_factor: int = 1, step_factor: int = 1):
        with open(path) as f:
            actions = json.load(f)
        out: List[int] = []
        for a in actions:
            if a == TURN_LEFT or a == TURN_RIGHT:
                out.extend([a] * turn_factor)
            elif a == MOVE_FORWARD:
                out.extend([a] * step_factor)
            else:
                out.append(a)
        self.actions = out
        self._i = 0

    def act(self, *_args, **_kwargs) -> int:
        if self._i >= len(self.actions):
            return STOP
        a = self.actions[self._i]
        self._i += 1
        return a
