"""The port's detection slice as a whole against vlfm_tpu's, on the CPU:
frames in, per-frame boxes and MobileSAM masks out.

Tiny OWL-ViT and tiny MobileSAM are initialised by JAX and loaded into the
port with ``from_jax_params``; both ``DetectionPipeline``s run on the same
uint8 frames at the ``VLFMConfig`` thresholds (0.8 COCO, 0.4 open
vocabulary). With these seeds the COCO route finds the toilet on frames 0
and 4 only (scores 0.994 and 0.876), so frames 1-3 take the
open-vocabulary retry. ``xyxy`` and ``scores`` are held to 1e-5, ``cls``
and ``valid`` exactly, and masks to a flip fraction of 1e-3 (f32 logits
agree to 1e-4; a pixel flips only where its logit is that close to 0).
Gated SAM is held bit for bit to the port's own ungated masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import coco_detector as JCD
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.models import sam as JS
from vlfm_tpu.parallel import detection_pipeline as JP
from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.models import coco_detector as CD
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.parallel import detection_pipeline as P

BOX_ATOL = 1e-5
MASK_FLIPS = 1e-3


def fake_encode(names):
    """Token ids (T, 8) seeded by the names, ending in the EOT (max) id."""
    rng = np.random.default_rng(sum(map(ord, "|".join(names))))
    ids = rng.integers(1, 98, (len(names), 8)).astype(np.int32)
    ids[:, -1] = 99
    return ids, np.ones_like(ids, bool)


@pytest.fixture(scope="module")
def models():
    ocfg, scfg = JO.OwlViTDetConfig.tiny(), JS.SamConfig.tiny_mobile_sam()
    det_p = jax.jit(JO.OwlViTDetectionModule(ocfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 4), jnp.int32),
        jnp.ones((1, 4), bool))["params"]
    sam_p = jax.jit(JS.SamModule(scfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))["params"]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (
        (JO.OwlViTDetector(ocfg, det_p), JS.SAM(scfg, sam_p)),
        (O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(), np_tree(det_p), device="cpu"),
         S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), np_tree(sam_p), device="cpu")),
    )


def _pipelines(models, capacity, coco=True):
    (jdet, jsam), (tdet, tsam) = models
    cfg = VLFMConfig()
    kw = dict(coco_threshold=cfg.coco_threshold, non_coco_threshold=cfg.non_coco_threshold,
              max_detections=cfg.max_detections_per_frame, sam_frame_capacity=capacity)
    jcoco = JCD.CocoDetector(jdet, fake_encode, max_detections=kw["max_detections"]) if coco else None
    tcoco = CD.CocoDetector(tdet, fake_encode, max_detections=kw["max_detections"]) if coco else None
    return (JP.DetectionPipeline(jdet, jsam, fake_encode, coco_detector=jcoco, **kw),
            P.DetectionPipeline(tdet, tsam, fake_encode, coco_detector=tcoco, **kw))


def _frames():
    return np.random.default_rng(2).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("target,capacity,coco", [
    ("toilet", None, True),     # COCO route + per-image open-vocab retry, ungated SAM
    ("toilet", 2, True),        # the same, gated at capacity 2 (last window clamped)
    ("toilet", None, False),    # no COCO detector: open vocab at 0.8, then the retry
    ("fireplace", None, True),  # open vocabulary only
    ("fireplace", 2, True),
])
def test_pipeline_matches_jax(models, target, capacity, coco):
    jpipe, tpipe = _pipelines(models, capacity, coco)
    rgb = _frames()
    want_masks, want_valid, (want_xyxy, want_scores, want_cls) = jpipe(jnp.asarray(rgb), target)
    masks, valid, (xyxy, scores, cls) = tpipe(torch.from_numpy(rgb), target)
    assert masks.shape == (5, 8, 48, 64) and masks.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    np.testing.assert_allclose(xyxy.numpy(), np.asarray(want_xyxy), atol=BOX_ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=BOX_ATOL)
    assert float(np.mean(masks.numpy() != np.asarray(want_masks))) <= MASK_FLIPS
    assert not masks[~valid].any()
    assert valid.any(), "the fixture's seeds give detections"


def test_coco_route_hits_some_frames_and_retries_the_rest(models):
    _, tpipe = _pipelines(models, None)
    rgb = torch.from_numpy(_frames())
    _, _, _, coco_valid = tpipe._coco_path(rgb, "toilet")
    np.testing.assert_array_equal(coco_valid.any(1).numpy(), [True, False, False, False, True])
    masks, valid, (xyxy, _, _) = tpipe(rgb, "toilet")
    _, _, _, retry_valid = tpipe._open_vocab(rgb, "toilet", tpipe.non_coco_threshold)
    for i in (0, 4):
        np.testing.assert_array_equal(valid[i].numpy(), coco_valid[i].numpy())
    for i in (1, 2, 3):
        np.testing.assert_array_equal(valid[i].numpy(), retry_valid[i].numpy())


def test_gated_pipeline_equals_ungated(models):
    _, plain = _pipelines(models, None)
    rgb = torch.from_numpy(_frames())
    for target in ("toilet", "fireplace"):
        m0, v0, box0 = plain(rgb, target)
        for cap in (1, 2, 4):
            _, gated = _pipelines(models, cap)
            m1, v1, box1 = gated(rgb, target)
            assert torch.equal(v1, v0) and torch.equal(m1, m0)
            assert all(torch.equal(a, b) for a, b in zip(box0, box1))


def test_query_cache_and_vqa(models):
    _, tpipe = _pipelines(models, None)
    rgb = torch.from_numpy(_frames()[:2])
    tpipe(rgb, "toilet")
    tpipe(rgb, "toilet")
    assert list(tpipe._query_cache) == ["toilet"]
    tpipe(rgb, "fireplace")
    assert list(tpipe._query_cache) == ["toilet", "fireplace"]
    (_, _), (tdet, tsam) = models
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        P.DetectionPipeline(tdet, tsam, fake_encode, use_vqa=True)
