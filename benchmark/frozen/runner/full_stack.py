"""The real perception models of the full stack.

Counterpart of ``vlfm_tpu/runner/full_stack.py``'s ``FullStackPerception``:
BLIP2-ITM scores, OWL-ViT detection with the COCO route and its
open-vocabulary retry, gated MobileSAM masks. Only what the benchmark's
reference runs is copied: the models' wiring and ``_perceive``; the fused
dispatch, the VQA veto and monocular depth are not.
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.frozen.config import VLFMConfig
from benchmark.frozen.device import default_device
from benchmark.frozen.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from benchmark.frozen.models.coco_detector import CocoDetector
from benchmark.frozen.models.owl_vit import OwlViTDetConfig, OwlViTDetector
from benchmark.frozen.models.sam import SAM, SamConfig
from benchmark.frozen.models.tokenizer import WordPieceTokenizer, toy_vocab
from benchmark.frozen.parallel.detection_pipeline import DetectionPipeline
from benchmark.frozen.parallel.engine import PerceptionEngine


class FullStackPerception:
    """(B, H, W, 3) uint8 frames and a target -> (cosines, detection masks,
    validity) through the real model architectures."""

    def __init__(
        self,
        cfg: VLFMConfig,
        itm: Optional[BLIP2ITM] = None,
        detector: Optional[OwlViTDetector] = None,
        sam: Optional[SAM] = None,
        det_threshold: float = 0.0,
        *,
        device: torch.device | str = default_device(),
    ):
        if cfg.use_vqa:
            raise ValueError("the VQA veto is not in the benchmark's frozen copy")
        self.cfg = cfg
        self.device = torch.device(device)
        self.itm = itm or BLIP2ITM.init_random(BLIP2ITMConfig.tiny(), seed=0, device=device)
        detector = detector or OwlViTDetector.init_random(OwlViTDetConfig.tiny(), seed=0, device=device)
        # MobileSAM (TinyViT encoder), the reference's vit_t (vlfm/vlm/sam.py:24-57)
        sam = sam or SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device=device)
        self.tokenizer = WordPieceTokenizer(toy_vocab(), max_len=8)
        self.engine = PerceptionEngine(itm=self.itm, tokenizer=self.tokenizer, text_prompt=cfg.text_prompt)

        det_vocab = detector.cfg.text.vocab_size

        def encode_queries(names):
            ids, mask = self.tokenizer.encode_batch(names)
            if det_vocab < 1000:  # toy configs: fold the real ids into the tiny vocabulary
                ids = ids % (det_vocab - 1) + 1
            return ids, mask

        coco = CocoDetector(detector, encode_queries, conf_threshold=cfg.coco_threshold,
                            max_detections=cfg.max_detections_per_frame)
        self.pipeline = DetectionPipeline(
            detector, sam, encode_queries,
            coco_detector=coco,
            coco_threshold=cfg.coco_threshold,
            non_coco_threshold=det_threshold,
            max_detections=cfg.max_detections_per_frame,
            sam_frame_capacity=cfg.sam_frame_capacity,
        )
