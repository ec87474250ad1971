"""The benchmark's own spans around the calls into the port's layers.

Each proxy stands where the port reads a model or the pipeline at each call
(``FullStackPerception.itm``, ``.pipeline``, the pipeline's detector),
opens a ``torch.profiler.record_function`` span named after
the layer, and, while its ``Capture`` is armed, keeps what the call
returned for the check. Outside a profiler a span costs a few microseconds
of host time, the same in every run.
"""

from __future__ import annotations

from typing import Dict, List

import torch


class Capture:
    """What one armed decision's calls returned, and per pipeline call the
    number of frames with a valid detection (a device scalar)."""

    def __init__(self):
        self.armed = False
        self.data: Dict[str, object] = {}
        self.frames: List[torch.Tensor] = []

    def arm(self) -> None:
        self.armed, self.data = True, {"detects": []}

    def take(self) -> Dict[str, object]:
        self.armed = False
        data, self.data = self.data, {}
        return data


class ModelProxy:
    """``obj`` with ``methods`` in a span named ``span``; the output of the
    last of them is kept under ``key`` while armed."""

    def __init__(self, obj, span: str, capture: Capture, methods, key: str = "cos"):
        self._obj, self._span, self._capture, self._methods, self._key = obj, span, capture, methods, key

    def __getattr__(self, name):
        fn = getattr(self._obj, name)
        if name not in self._methods:
            return fn

        def wrapped(*a, **kw):
            with torch.profiler.record_function(self._span):
                out = fn(*a, **kw)
            if self._capture.armed:
                self._capture.data[self._key] = out
            return out
        return wrapped


class DetectorProxy:
    """The open-vocabulary detector: every ``detect`` call's (query ids,
    boxes, logits) is kept while armed, in call order."""

    def __init__(self, det, capture: Capture):
        self._det, self._capture = det, capture

    def __getattr__(self, name):
        return getattr(self._det, name)

    def detect(self, images, input_ids, attention_mask):
        boxes, logits = self._det.detect(images, input_ids, attention_mask)
        if self._capture.armed:
            self._capture.data["detects"].append((input_ids, boxes, logits))
        return boxes, logits


class PipelineProxy:
    """The detection pipeline in a ``perception.pipeline`` span."""

    def __init__(self, pipe, capture: Capture):
        self._pipe, self._capture = pipe, capture

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, rgb, target, out_hw=None):
        with torch.profiler.record_function("perception.pipeline"):
            masks, valid, boxes = self._pipe(rgb, target, out_hw)
        self._capture.frames.append(valid.any(dim=1).sum())
        if self._capture.armed:
            self._capture.data.update(masks=masks, valid=valid, boxes=boxes)
        return masks, valid, boxes
