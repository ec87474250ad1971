"""Batched ITM scoring engine: the in-process replacement for the
reference's BLIP2-ITM HTTP server.

Counterpart of the ITM half of ``vlfm_tpu/parallel/engine.py``: each
decision step makes ONE batched call over the whole image batch, and the
per-target prompt text features are encoded once and cached (the reference
re-sends the prompt text every step). Detection joins it when the detector
is ported.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.frozen.models.blip2_itm import BLIP2ITM
from benchmark.frozen.models.tokenizer import WordPieceTokenizer

PROMPT_SEPARATOR = "|"


class PerceptionEngine:
    """Scores ITM prompt channels for a batch of RGB frames."""

    def __init__(
        self,
        itm: BLIP2ITM,
        tokenizer: WordPieceTokenizer,
        text_prompt: str = "Seems like there is a target_object ahead.",
    ):
        self.itm = itm
        self.tokenizer = tokenizer
        self.text_prompt = text_prompt
        self._text_feat_cache: Dict[str, torch.Tensor] = {}

    def prompts_for_target(self, target: str) -> List[str]:
        # itm_policy.py:195-201 — substitute and split on '|'
        return [
            p.replace("target_object", target.replace("|", "/"))
            for p in self.text_prompt.split(PROMPT_SEPARATOR)
        ]

    def text_features(self, target: str) -> torch.Tensor:
        """(C, E) prompt features, encoded on first use per target."""
        if target not in self._text_feat_cache:
            ids, mask = self.tokenizer.encode_batch(self.prompts_for_target(target))
            dev = self.itm.device
            self._text_feat_cache[target] = self.itm.encode_texts(ids.to(dev), mask.to(dev))
        return self._text_feat_cache[target]

    def score(self, rgb: torch.Tensor, target: str) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, C) ITM cosines in one batched call."""
        feats = self.text_features(target)
        return self.itm.cosine_cached_text(self.itm.preprocess(rgb), feats)
