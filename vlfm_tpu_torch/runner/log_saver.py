"""Per-episode JSON logging and the multi-worker episode ledger: the
port's copy of ``vlfm_tpu/runner/log_saver.py`` (host-side, standard
library only).

Parity target: vlfm/utils/log_saver.py — ``log_episode`` writes one JSON per
episode into $ZSOS_LOG_DIR; ``is_evaluated`` lets multiple eval processes
shard episodes over a shared directory and resume after crashes (empty files
older than 5 minutes are treated as stale claims and deleted). The file
names and the JSON are the JAX package's byte for byte.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

STALE_CLAIM_SECONDS = 300


def _path(log_dir: str, episode_id, scene_id) -> Path:
    return Path(log_dir) / f"{episode_id}_{Path(str(scene_id)).stem}.json"


def claim_episode(episode_id, scene_id, log_dir: Optional[str] = None) -> bool:
    """Atomically claim an episode by creating an empty marker file.

    Returns False if another worker already claimed/evaluated it.
    """
    log_dir = log_dir or os.environ.get("ZSOS_LOG_DIR", "episode_logs")
    os.makedirs(log_dir, exist_ok=True)
    p = _path(log_dir, episode_id, scene_id)
    if is_evaluated(episode_id, scene_id, log_dir):
        return False
    try:
        fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        return True
    except FileExistsError:
        return False


def log_episode(episode_id, scene_id, data: Dict, log_dir: Optional[str] = None) -> None:
    log_dir = log_dir or os.environ.get("ZSOS_LOG_DIR", "episode_logs")
    os.makedirs(log_dir, exist_ok=True)
    with open(_path(log_dir, episode_id, scene_id), "w") as f:
        json.dump({"episode_id": episode_id, "scene_id": str(scene_id), **data}, f)


def is_evaluated(episode_id, scene_id, log_dir: Optional[str] = None) -> bool:
    """True if a non-stale record exists (log_saver.py:25-44 semantics):
    completed files count; empty claim files older than 5 min are deleted."""
    log_dir = log_dir or os.environ.get("ZSOS_LOG_DIR", "episode_logs")
    p = _path(log_dir, episode_id, scene_id)
    if not p.exists():
        return False
    try:
        st = p.stat()
    except FileNotFoundError:
        return False
    if st.st_size > 0:
        return True
    if time.time() - st.st_mtime > STALE_CLAIM_SECONDS:
        try:
            p.unlink()
        except FileNotFoundError:
            pass
        return False
    return True
