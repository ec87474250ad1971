"""vlfm_tpu_torch's detection container and JSON wire format against
vlfm_tpu's, on the CPU.

The same seeded detections go through both packages' filters, counts and
denormalisation (equal, boxes to f32 bit equality); ``to_json`` gives
JAX's payload key for key and value for value; a payload written by either
package and read by the other gives the same detections.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import detections as JD
from vlfm_tpu_torch.models import detections as D

CLASSES = ["chair", "couch", "potted plant", "bed", "toilet", "tv"]


def _pair(capacity=8, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 0.5, (capacity, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.5, (capacity, 2))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, capacity).astype(np.float32)
    ids = rng.integers(-1, len(CLASSES) + 1, capacity).astype(np.int32)  # -1 and one past the vocabulary too
    valid = rng.uniform(size=capacity) < 0.7
    return (JD.Detections(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(valid)),
            D.Detections(*(torch.from_numpy(a) for a in (boxes, scores, ids, valid))))


def _same(t: D.Detections, j: JD.Detections):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
def test_filters_counts_and_boxes_match_jax(seed):
    j, t = _pair(seed=seed)
    keep = np.array([4, 0, -1, -1], np.int32)
    _same(D.filter_by_class(t, torch.from_numpy(keep)), JD.filter_by_class(j, jnp.asarray(keep)))
    _same(D.filter_by_conf(t, 0.4), JD.filter_by_conf(j, 0.4))
    assert int(D.num_detections(t)) == int(JD.num_detections(j))
    np.testing.assert_array_equal(D.denormalize_boxes(t, 640, 480).numpy(),
                                  np.asarray(JD.denormalize_boxes(j, 640, 480)))
    _same(D.empty(5, device="cpu"), JD.empty(5))
    vocab, jvocab = D.DetectionVocab(CLASSES), JD.DetectionVocab(CLASSES)
    assert vocab.phrases(t) == jvocab.phrases(j)
    np.testing.assert_array_equal(vocab.ids_for(["tv", "sofa", "chair"]), jvocab.ids_for(["tv", "sofa", "chair"]))


@pytest.mark.parametrize("seed", range(4))
def test_json_round_trip_across_the_packages(seed):
    j, t = _pair(seed=seed)
    vocab, jvocab = D.DetectionVocab(CLASSES), JD.DetectionVocab(CLASSES)
    payload = D.to_json(t, vocab)
    jpayload = JD.to_json(j, jvocab)
    assert json.dumps(payload, sort_keys=False) == json.dumps(jpayload, sort_keys=False)
    wire = json.loads(json.dumps(jpayload))  # JAX writes, the port reads
    _same(D.from_json(wire, vocab, 8, device="cpu"), JD.from_json(wire, jvocab, 8))
    wire = json.loads(json.dumps(payload))  # the port writes, JAX reads
    back = D.from_json(wire, vocab, 8, device="cpu")
    _same(back, JD.from_json(wire, jvocab, 8))
    assert D.to_json(back, vocab) == payload  # a second trip changes nothing
    _same(D.from_json(wire, vocab, 2, device="cpu"), JD.from_json(wire, jvocab, 2))  # truncated to capacity
    empty = {"boxes": [], "logits": [], "phrases": []}
    _same(D.from_json(empty, vocab, 3, device="cpu"), JD.from_json(empty, jvocab, 3))
