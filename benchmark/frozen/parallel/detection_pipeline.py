"""Detect -> route -> segment: the object perception of one batched step.

Counterpart of ``vlfm_tpu/parallel/detection_pipeline.py``
(``DetectionPipeline``; reference: BaseObjectNavPolicy._get_object_detections
and _update_object_map, base_objectnav_policy.py:221-241, 311-335), without
the GroundingDINO adapter and the VQA veto, which no cell of the benchmark
runs:

- The open-vocabulary ``detector`` is OWL-ViT (``OwlViTDetector``).
- COCO-class targets use the closed-vocabulary COCO route at
  ``coco_threshold`` (0.8); other targets use the open-vocabulary detector at
  ``non_coco_threshold`` (0.4). A COCO-route miss retries the
  open-vocabulary detector at 0.4, per image: both branches run batched and
  the retry is a per-image select between their outputs.
- Every surviving box is segmented by SAM in one batched call (the image is
  encoded once), or, with ``sam_frame_capacity``, in gated passes over the
  frames that hold a detection (``SAM.segment_boxes_gated``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from benchmark.frozen.models.coco_classes import COCO_CLASSES, is_coco_target
from benchmark.frozen.models.coco_detector import CocoDetector
from benchmark.frozen.models.owl_vit import OwlViTDetector, top_detections
from benchmark.frozen.models.sam import SAM
from benchmark.frozen.ops.resize import resize_bilinear, resize_bilinear_hw


@dataclass
class DetectionPipeline:
    detector: OwlViTDetector
    sam: SAM
    encode_queries: Callable  # List[str] -> (ids (T, L) int, mask (T, L) bool); T = 1 for a caption
    coco_detector: Optional[CocoDetector] = None
    coco_threshold: float = 0.8
    non_coco_threshold: float = 0.4
    max_detections: int = 8
    # Frames per SAM pass (None: segment every frame in one call). With a
    # capacity, frames holding a valid detection are compacted and segmented
    # in ceil(n / capacity) passes, so SAM's cost follows the detection
    # density and no detection is dropped.
    sam_frame_capacity: Optional[int] = None
    _query_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, init=False, repr=False)

    def _queries(self, target: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if target not in self._query_cache:
            ids, mask = self.encode_queries(target.split("|"))
            dev = self.detector.device
            self._query_cache[target] = (torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))
        return self._query_cache[target]

    def _open_vocab(self, rgb: torch.Tensor, target: str, threshold: float):
        ids, qmask = self._queries(target)
        boxes, logits = self.detector.detect(self.detector.preprocess(rgb), ids, qmask)
        return top_detections(boxes, logits, capacity=self.max_detections, threshold=threshold)

    def _coco_path(self, rgb: torch.Tensor, target: str):
        """Closed-vocabulary detections filtered to the target class(es)
        (detections.filter_by_class, base_objectnav_policy.py:231)."""
        xyxy, scores, cls, valid = self.coco_detector.predict(rgb)
        target_ids = torch.tensor(
            [COCO_CLASSES.index(n) for n in target.split("|") if n in COCO_CLASSES],
            dtype=torch.int32, device=cls.device,
        )
        keep = (cls[..., None] == target_ids[None, None, :]).any(-1)
        return xyxy, scores, cls, valid & keep

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, target: str, out_hw: Optional[Tuple[int, int]] = None):
        """(B, H, W, 3) uint8 -> (masks (B, K, H, W) bool, valid (B, K),
        (xyxy (B, K, 4) in [0, 1], scores (B, K), cls (B, K))). With
        ``out_hw``, SAM's masks are resampled to that grid instead of the
        frame's: the camera grid, for frames that crossed at half size."""
        b, fh, fw = rgb.shape[:3]
        h, w = out_hw or (fh, fw)
        if is_coco_target(target):
            # The high-precision threshold first; a miss retries open-vocab
            # at the lower threshold. Without a COCO detector the first pass
            # is the open-vocab detector at the same 0.8.
            if self.coco_detector is not None:
                xyxy, scores, cls, valid = self._coco_path(rgb, target)
            else:
                xyxy, scores, cls, valid = self._open_vocab(rgb, target, self.coco_threshold)
            xyxy2, scores2, cls2, valid2 = self._open_vocab(rgb, target, self.non_coco_threshold)
            missed = ~valid.any(dim=1)  # (B,)
            xyxy = torch.where(missed[:, None, None], xyxy2, xyxy)
            scores = torch.where(missed[:, None], scores2, scores)
            cls = torch.where(missed[:, None], cls2, cls)
            valid = torch.where(missed[:, None], valid2, valid)
        else:
            xyxy, scores, cls, valid = self._open_vocab(rgb, target, self.non_coco_threshold)

        s = self.sam.cfg.vision.image_size
        sam_imgs = resize_bilinear(rgb.to(torch.float32), s, s)
        cap = self.sam_frame_capacity
        if cap is not None and cap < b:
            masks_lr, valid = self.sam.segment_boxes_gated(sam_imgs, xyxy, valid, cap)
        else:
            masks_lr, _ = self.sam.segment_boxes(sam_imgs, xyxy)  # (B, K, 4G, 4G)
        masks = resize_bilinear_hw(masks_lr.to(torch.float32), h, w) > 0.5
        masks = masks & valid[:, :, None, None]
        return masks, valid, (xyxy, scores, cls)
