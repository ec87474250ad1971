"""The detection container (fixed capacity, mask-based) and its JSON wire
format.

Counterpart of ``vlfm_tpu/models/detections.py`` (reference:
vlfm/vlm/detections.py, ``ObjectDetections``): normalized xyxy boxes,
scores and class ids in fixed-capacity tensors with a validity mask, so
filtering stays on the device; phrases are class ids into a host-side
vocabulary. ``to_json`` / ``from_json`` speak the reference servers' wire
format (boxes, logits, phrases), key for key as the JAX package writes it,
so a payload crosses between the packages unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from vlfm_tpu_torch.device import default_device


class Detections(NamedTuple):
    boxes: torch.Tensor  # (K, 4) normalized xyxy in [0, 1]
    scores: torch.Tensor  # (K,)
    class_ids: torch.Tensor  # (K,) int32 into a host-side class list
    valid: torch.Tensor  # (K,) bool


def empty(capacity: int, device: torch.device | str = default_device()) -> Detections:
    return Detections(
        boxes=torch.zeros((capacity, 4), device=device),
        scores=torch.zeros(capacity, device=device),
        class_ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def filter_by_class(d: Detections, keep_ids: torch.Tensor) -> Detections:
    """Keep the detections whose class id is in ``keep_ids`` (padded with
    -1), as ObjectDetections.filter_by_class (detections.py:64-77)."""
    m = (d.class_ids[:, None] == keep_ids[None, :]).any(dim=1)
    return d._replace(valid=d.valid & m)


def filter_by_conf(d: Detections, threshold: float) -> Detections:
    """ObjectDetections.filter_by_conf (detections.py:79-91)."""
    return d._replace(valid=d.valid & (d.scores >= threshold))


def num_detections(d: Detections) -> torch.Tensor:
    return d.valid.sum()


def denormalize_boxes(d: Detections, width: int, height: int) -> torch.Tensor:
    scale = torch.tensor([width, height, width, height], dtype=d.boxes.dtype, device=d.boxes.device)
    return d.boxes * scale


@dataclass
class DetectionVocab:
    """String class names for a Detections batch (host side)."""

    classes: List[str] = field(default_factory=list)

    def ids_for(self, names: Sequence[str]) -> np.ndarray:
        return np.array([self.classes.index(n) if n in self.classes else -1 for n in names], np.int32)

    def phrases(self, d: Detections) -> List[str]:
        ids = d.class_ids.cpu().numpy()
        v = d.valid.cpu().numpy()
        return [self.classes[i] if v[k] and 0 <= i < len(self.classes) else "" for k, i in enumerate(ids)]


def to_json(d: Detections, vocab: DetectionVocab) -> dict:
    """The reference's wire format (detections.py:93-126): the valid
    detections' normalized boxes, logits and phrases."""
    v = d.valid.cpu().numpy()
    return {
        "boxes": d.boxes.cpu().numpy()[v].tolist(),
        "logits": d.scores.cpu().numpy()[v].tolist(),
        "phrases": [p for p, ok in zip(vocab.phrases(d), v) if ok],
    }


def from_json(payload: dict, vocab: DetectionVocab, capacity: int,
              device: torch.device | str = default_device()) -> Detections:
    """A payload's first ``capacity`` detections as f32 boxes and scores;
    a phrase outside ``vocab`` gets class id -1."""
    n = min(len(payload["boxes"]), capacity)
    boxes = np.zeros((capacity, 4), np.float32)
    scores = np.zeros(capacity, np.float32)
    ids = np.full(capacity, -1, np.int32)
    valid = np.zeros(capacity, bool)
    if n:
        boxes[:n] = np.asarray(payload["boxes"], np.float32)[:n]
        scores[:n] = np.asarray(payload["logits"], np.float32)[:n]
        ids[:n] = vocab.ids_for(payload["phrases"][:n])
        valid[:n] = True
    return Detections(*(torch.from_numpy(a).to(device) for a in (boxes, scores, ids, valid)))
