"""Value-map record and replay: the golden-trace regression harness.

Counterpart of ``vlfm_tpu/mapping/value_map_io.py`` (reference: the
RECORD_VALUE_MAP / PLAY_VALUE_MAP machinery of vlfm/mapping/value_map.py:
26-30,77-94,130-144,448-481): record every value-map update's inputs
during a run (a depth image and a JSON entry of values, transform, depth
range and fov), then replay them update by update to compare the maps two
versions build. The files are the JAX package's (``kwargs.json``,
``data.json``, ``NNNN.png``), so a recording made by either package
replays in the other. Depth is a 16-bit PNG (the reference's is 8-bit,
which loses ~0.02 m); a depth of all ones, the robot's, comes back exact.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Iterator, Optional, Tuple

import cv2
import numpy as np
import torch

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D

RECORDING_DIR_ENV = "RECORD_VALUE_MAP_DIR"
DEFAULT_DIR = "value_map_recordings"


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (numpy, a number or a tensor on any device)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ValueMapRecorder:
    def __init__(self, directory: Optional[str] = None, kwargs: Optional[dict] = None):
        self.dir = directory or os.environ.get(RECORDING_DIR_ENV, DEFAULT_DIR)
        os.makedirs(self.dir, exist_ok=True)
        self._idx = 0
        self._data = {}
        if kwargs is not None:
            with open(osp.join(self.dir, "kwargs.json"), "w") as f:
                json.dump(kwargs, f)

    def record(self, values, depth, tf_camera_to_episodic, min_depth, max_depth, fov) -> None:
        """One update's inputs: values (C,), depth (H, W) in [0, 1], the
        (4, 4) camera transform, the depth range and the fov."""
        name = f"{self._idx:04d}.png"
        cv2.imwrite(osp.join(self.dir, name), (_host(depth) * 65535).astype(np.uint16))
        self._data[name] = {
            "values": _host(values).tolist(),
            "tf_camera_to_episodic": _host(tf_camera_to_episodic).tolist(),
            "min_depth": float(min_depth),
            "max_depth": float(max_depth),
            "fov": float(fov),
        }
        self._idx += 1
        with open(osp.join(self.dir, "data.json"), "w") as f:
            json.dump(self._data, f)


def iter_recording(directory: str) -> Iterator[Tuple[np.ndarray, dict]]:
    """(depth, meta) of each recorded update, in recording order."""
    with open(osp.join(directory, "data.json")) as f:
        data = json.load(f)
    for name in sorted(data.keys()):
        img = cv2.imread(osp.join(directory, name), cv2.IMREAD_UNCHANGED)
        if img.dtype == np.uint16:
            depth = img.astype(np.float32) / 65535.0
        else:
            depth = img.astype(np.float32) / 255.0
        yield depth, data[name]


def replay(directory: str, spec: Optional[GridSpec2D] = None, value_channels: Optional[int] = None, *,
           device: torch.device | str = default_device()) -> VM.ValueMapState:
    """Re-run a recording through ``value_map.update``, one lane (B = 1) on
    ``device``; returns the final state."""
    spec = spec or GridSpec2D()
    frames = list(iter_recording(directory))
    if value_channels is None:
        value_channels = len(frames[0][1]["values"]) if frames else 1
    state = VM.create(spec, value_channels, device=device)

    def lane(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.float32), device=device)[None]

    for depth, meta in frames:
        state = VM.update(state, spec, lane(meta["values"]), lane(depth), lane(meta["tf_camera_to_episodic"]),
                          float(meta["min_depth"]), float(meta["max_depth"]), float(meta["fov"]))
    return state
