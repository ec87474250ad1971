"""Detect -> route -> segment -> (optionally) VQA-verify: the object
perception of one batched step.

Counterpart of ``vlfm_tpu/parallel/detection_pipeline.py``
(``VQAVeto``, ``DetectionPipeline``; reference:
BaseObjectNavPolicy._get_object_detections and _update_object_map,
base_objectnav_policy.py:221-241, 311-335):

- The open-vocabulary ``detector`` is OWL-ViT (``OwlViTDetector``) or
  GroundingDINO through its query adapter (``GroundingDinoQueryAdapter``);
  both have ``device``, ``preprocess`` and ``detect``.
- COCO-class targets use the closed-vocabulary COCO route at
  ``coco_threshold`` (0.8); other targets use the open-vocabulary detector at
  ``non_coco_threshold`` (0.4). A COCO-route miss retries the
  open-vocabulary detector at 0.4, per image: both branches run batched and
  the retry is a per-image select between their outputs.
- Every surviving box is segmented by SAM in one batched call (the image is
  encoded once), or, with ``sam_frame_capacity``, in gated passes over the
  frames that hold a detection (``SAM.segment_boxes_gated``).
- With ``use_vqa``, ``VQAVeto`` verifies each detection: its mask's contour
  is painted red on the frame and BLIP-2 / flan-T5 is asked
  "Question: {vqa_prompt}[a ]{phrase}? Answer:" about the name the
  detection matched; an answer that does not start with "yes" drops it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from vlfm_tpu_torch.models.coco_classes import COCO_CLASSES, is_coco_target
from vlfm_tpu_torch.models.coco_detector import CocoDetector
from vlfm_tpu_torch.models.grounding_dino import GroundingDinoQueryAdapter
from vlfm_tpu_torch.models.owl_vit import OwlViTDetector, top_detections
from vlfm_tpu_torch.models.sam import SAM
from vlfm_tpu_torch.models.t5_vqa import T5VQA
from vlfm_tpu_torch.ops.morphology import dilate, erode
from vlfm_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_hw
from vlfm_tpu_torch.utils.profiling import count, span

RED = (255, 0, 0)


@dataclass
class VQAVeto:
    """Visual verification of detections (the reference's ``use_vqa``).

    ``image_prefix`` maps annotated (N, H, W, 3) uint8 frames to the (N, P,
    d_model) visual prefix of the T5 encoder: BLIP-2's ViT, Q-Former and
    language projection (``BLIP2VQA.image_prefix`` after its
    ``preprocess``). ``encode_text`` maps a question to (ids (L,), mask
    (L,)).

    ``slot_capacity`` compacts the veto to the valid detection slots: they
    sort first (a stable sort), and ``ceil(n_valid / capacity)`` passes each
    ask a ``capacity``-slot window of that order, so the veto's cost follows
    the detection count (the batched form of the reference's one VQA call
    per detection). The last window is clamped to ``[0, B*K - capacity]``,
    as ``jax.lax.dynamic_slice_in_dim`` clamps it. The pass count needs one
    host read of the valid count per call. None, or a capacity of B*K or
    more, asks every slot in one batch.

    Each pass's visual prefix is a ``vlfm.veto.prefix`` span, and T5's
    ``generate`` adds its own (``vlfm.t5.encode``, ``vlfm.t5.decode``).
    Counters per call: ``veto.passes`` and ``veto.slots`` (the slots asked,
    ``passes * capacity`` with the clamped last window's, or B*K in one
    batch); ``veto.valid_slots``, the valid count the gated form reads
    (the one-batch form reads nothing and does not count it).
    """

    vqa: T5VQA
    encode_text: Callable  # str -> (ids (L,), mask (L,))
    yes_token_id: int
    image_prefix: Optional[Callable] = None
    vqa_prompt: str = "Is this "
    max_answer_tokens: int = 4
    slot_capacity: Optional[int] = None
    _q_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict, init=False, repr=False)

    def question_for(self, phrase: str) -> str:
        """base_objectnav_policy.py:329-332, with its "a " for a phrase that
        does not end in "ing"."""
        q = f"Question: {self.vqa_prompt}"
        if not phrase.endswith("ing"):
            q += "a "
        return q + phrase + "? Answer:"

    def _question_tokens(self, phrase: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if phrase not in self._q_cache:
            ids, mask = self.encode_text(self.question_for(phrase))
            dev = self.vqa.device
            self._q_cache[phrase] = (torch.as_tensor(ids, device=dev).to(torch.int64),
                                     torch.as_tensor(mask, device=dev).to(torch.bool))
        return self._q_cache[phrase]

    @staticmethod
    def annotate(rgb: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 and (B, K, H, W) masks -> (B*K, H, W, 3): each
        frame with its mask's contour in red. cv2.drawContours(thickness=2)
        centres its line on the boundary, about 1 px either side, which
        dilate & ~erode is (base_objectnav_policy.py:327-328)."""
        ring = dilate(masks, 3) & ~erode(masks, 3)
        with span("vlfm.wait.veto_paint"):
            red = torch.tensor(RED, dtype=torch.uint8, device=rgb.device)
        return torch.where(ring[..., None], red, rgb[:, None]).reshape(-1, *rgb.shape[1:])

    def _ask(self, images: torch.Tensor, ids: torch.Tensor, qmask: torch.Tensor) -> torch.Tensor:
        prefix = None
        if self.image_prefix is not None:
            with span("vlfm.veto.prefix", images=images):
                prefix = self.image_prefix(images)
        gen = self.vqa.generate(ids, qmask, max_new_tokens=self.max_answer_tokens, prefix=prefix)
        return self.vqa.answer_starts_with_yes(gen, self.yes_token_id)

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, masks: torch.Tensor, valid: torch.Tensor,
                 phrases: Union[str, List[str]], cls: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, 3) uint8, (B, K, H, W) bool masks on the frame's grid,
        (B, K) bool -> the vetoed validity (B, K).

        ``phrases``: one str asks the same question about every detection;
        a list is a phrase bank indexed by ``cls`` (B, K), clipped to the
        bank, the batched form of the reference asking about the
        detector's matched phrase (base_objectnav_policy.py:330-333)."""
        b, k = valid.shape
        if isinstance(phrases, str):
            phrases, cls = [phrases], None
        bank = [self._question_tokens(p) for p in phrases]
        ids_bank = torch.stack([i for i, _ in bank])  # (T, L)
        mask_bank = torch.stack([m for _, m in bank])
        if cls is None or len(phrases) == 1:
            ids = ids_bank[0].expand(b * k, -1)
            qmask = mask_bank[0].expand(b * k, -1)
        else:
            c = torch.clamp(cls, 0, len(phrases) - 1).reshape(b * k).to(ids_bank.device)
            ids, qmask = ids_bank[c], mask_bank[c]
        flat = self.annotate(rgb, masks)
        cap = self.slot_capacity
        if cap is None or cap >= b * k:
            count("veto.passes")
            count("veto.slots", b * k)
            return valid & self._ask(flat, ids, qmask).reshape(b, k)
        flatv = valid.reshape(b * k)
        order = torch.argsort((~flatv).to(torch.uint8), stable=True)  # valid slots first
        with span("vlfm.wait.veto"):
            n_valid = int(flatv.sum())
        passes = -(-n_valid // cap)
        count("veto.valid_slots", n_valid)
        count("veto.passes", passes)
        count("veto.slots", passes * cap)
        yes = torch.zeros(b * k, dtype=torch.bool, device=valid.device)
        for p in range(passes):
            start = min(p * cap, b * k - cap)
            sel = order[start:start + cap]
            yes[sel] = self._ask(flat[sel], ids[sel], qmask[sel])
        return valid & yes.reshape(b, k)


def matched_name(coco_cls: torch.Tensor, names: List[str]) -> torch.Tensor:
    """The index into ``names`` of the name each COCO-route detection
    matched (its class indexes ``COCO_CLASSES``); 0 where none does, as
    ``argmax`` of an all-false row."""
    with span("vlfm.wait.veto_names"):
        tids = torch.tensor([COCO_CLASSES.index(n) if n in COCO_CLASSES else -1 for n in names],
                            dtype=coco_cls.dtype, device=coco_cls.device)
    return torch.argmax((coco_cls[..., None] == tids).to(torch.uint8), dim=-1).to(coco_cls.dtype)


@dataclass
class DetectionPipeline:
    detector: Union[OwlViTDetector, GroundingDinoQueryAdapter]
    sam: SAM
    encode_queries: Callable  # List[str] -> (ids (T, L) int, mask (T, L) bool); T = 1 for a caption
    coco_detector: Optional[CocoDetector] = None
    vqa_veto: Optional[VQAVeto] = None
    use_vqa: bool = False
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

    def __post_init__(self):
        if self.use_vqa and self.vqa_veto is None:
            raise ValueError("use_vqa needs a vqa_veto")

    def _queries(self, target: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if target not in self._query_cache:
            ids, mask = self.encode_queries(target.split("|"))
            dev = self.detector.device
            self._query_cache[target] = (torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))
        return self._query_cache[target]

    def _open_vocab(self, rgb: torch.Tensor, target: str, threshold: float):
        with span("vlfm.detect.open_vocab", frames=rgb.shape[0]):
            ids, qmask = self._queries(target)
            boxes, logits = self.detector.detect(self.detector.preprocess(rgb), ids, qmask)
            return top_detections(boxes, logits, capacity=self.max_detections, threshold=threshold)

    def _coco_path(self, rgb: torch.Tensor, target: str):
        """Closed-vocabulary detections filtered to the target class(es)
        (detections.filter_by_class, base_objectnav_policy.py:231)."""
        with span("vlfm.detect.coco", frames=rgb.shape[0]):
            xyxy, scores, cls, valid = self.coco_detector.predict(rgb)
            with span("vlfm.wait.coco_ids"):
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
        coco_lanes = None  # (B,) frames whose detections came from the COCO route
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
            if self.coco_detector is not None:
                coco_lanes = ~missed
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
        if self.use_vqa:
            # The veto paints the contours on the frame it was given, so it
            # sees masks on the frame's grid; ``out_hw`` masks follow it.
            masks = (resize_bilinear_hw(masks_lr.to(torch.float32), fh, fw) > 0.5) & valid[:, :, None, None]
            names = target.split("|")
            phrase_cls = cls if coco_lanes is None else torch.where(coco_lanes[:, None], matched_name(cls, names), cls)
            with span("vlfm.veto"):
                valid = self.vqa_veto(rgb, masks, valid, names, phrase_cls)
            if (h, w) == (fh, fw):
                return masks & valid[:, :, None, None], valid, (xyxy, scores, cls)
        masks = resize_bilinear_hw(masks_lr.to(torch.float32), h, w) > 0.5
        masks = masks & valid[:, :, None, None]
        return masks, valid, (xyxy, scores, cls)
