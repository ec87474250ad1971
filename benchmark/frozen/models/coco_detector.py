"""COCO-classes detection path (the YOLOv7 role).

Counterpart of ``vlfm_tpu/models/coco_detector.py`` (reference:
vlfm/vlm/yolov7.py and the routing in base_objectnav_policy.py:221-241):
COCO targets are detected at the high confidence threshold (0.8) by the
open-vocabulary detector queried with the fixed 80-class COCO prompt set,
encoded once and cached.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import torch

from benchmark.frozen.models.coco_classes import COCO_CLASSES
from benchmark.frozen.models.owl_vit import OwlViTDetector, top_detections


@dataclass
class CocoDetector:
    """Closed-vocabulary detector over the 80 COCO classes."""

    detector: OwlViTDetector
    encode_queries: Callable  # List[str] -> (ids (T, L), mask (T, L))
    conf_threshold: float = 0.8  # reference coco_threshold
    max_detections: int = 8
    _queries: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(default=None, init=False, repr=False)

    def _coco_queries(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._queries is None:
            ids, mask = self.encode_queries(COCO_CLASSES)
            dev = self.detector.device
            self._queries = (torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))
        return self._queries

    def predict(self, rgb_uint8: torch.Tensor):
        """(B, H, W, 3) -> (xyxy, scores, class ids into COCO_CLASSES, valid)."""
        ids, mask = self._coco_queries()
        boxes, logits = self.detector.detect(self.detector.preprocess(rgb_uint8), ids, mask)
        return top_detections(boxes, logits, capacity=self.max_detections, threshold=self.conf_threshold)
