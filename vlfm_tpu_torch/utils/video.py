"""Per-episode video pipeline: the port's copy of ``vlfm_tpu/utils/video.py``
(host-side, numpy and cv2): frame collection, one-step-delay compensation,
mp4 writing.

Parity target: vlfm/utils/habitat_visualizer.py (HabitatVis.collect_data /
flush_frames) + vlfm_trainer.py:283-297 (generate_video). The reference
collects policy-side renderings one step LATE (policy_info from act(t) is
collected together with observation t+1), so flush rotates the delayed
streams by one frame and drops the trailing frame (habitat_visualizer.py:92-97).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import cv2
import numpy as np

from vlfm_tpu_torch.utils.visualization import add_text_to_image, compose_frame


class VideoCollector:
    """Collects per-step (rgb, depth, maps, texts) and composes frames.

    ``maps_delayed=True`` reproduces the reference's collection ordering —
    map renderings lag the egocentric frames by one step and are realigned at
    flush time (habitat_visualizer.py:92-97).
    """

    def __init__(self, maps_delayed: bool = False):
        self.maps_delayed = maps_delayed
        self.reset()

    def reset(self) -> None:
        self.rgb: List[np.ndarray] = []
        self.depth: List[np.ndarray] = []
        self.maps: List[List[np.ndarray]] = []
        self.texts: List[List[str]] = []

    def collect(self, rgb, depth, maps: Sequence[np.ndarray], texts: Sequence[str] = ()):
        self.rgb.append(np.asarray(rgb))
        self.depth.append(np.asarray(depth))
        self.maps.append(list(maps))
        self.texts.append(list(texts))

    def flush(self, failure_cause: Optional[str] = None) -> List[np.ndarray]:
        """Compose all frames; applies the one-step-delay realignment when
        ``maps_delayed`` (rotate the delayed stream forward by one, drop the
        final frame — habitat_visualizer.py:92-97)."""
        rgb, depth, maps, texts = self.rgb, self.depth, self.maps, self.texts
        n = len(rgb)
        if self.maps_delayed and n > 1:
            maps = maps[1:] + maps[:1]
            n -= 1  # trailing frame pairs obs T with maps from step 0: drop
        frames = []
        for i in range(n):
            frame = compose_frame(rgb[i], depth[i], maps[i], texts[i])
            if failure_cause:
                frame = add_text_to_image(frame, f"Failure cause: {failure_cause}", top=True)
            frames.append(frame)
        # uniform size for the encoder
        if frames:
            h = max(f.shape[0] for f in frames)
            w = max(f.shape[1] for f in frames)
            frames = [
                np.pad(f, ((0, h - f.shape[0]), (0, w - f.shape[1]), (0, 0)),
                       constant_values=255)
                for f in frames
            ]
        self.reset()
        return frames


def write_video(frames: Sequence[np.ndarray], path: str, fps: int = 5) -> str:
    """Encode frames (H, W, 3) uint8 RGB to an mp4 (vlfm_trainer generate_video
    role). Returns the path."""
    assert len(frames) > 0, "no frames to write"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    # even dimensions keep every codec happy
    w2, h2 = w - w % 2, h - h % 2
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w2, h2))
    if not writer.isOpened():  # codec fallback
        path = os.path.splitext(path)[0] + ".avi"
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w2, h2))
    for f in frames:
        writer.write(cv2.cvtColor(f[:h2, :w2], cv2.COLOR_RGB2BGR))
    writer.release()
    return path
