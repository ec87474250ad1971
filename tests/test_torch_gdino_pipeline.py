"""GroundingDINO as the port's open-vocabulary detector, through the whole
detection pipeline, against vlfm_tpu's on the CPU.

The tiny GroundingDINO (the seeded numpy tree of
``test_torch_grounding_dino.jax_params``) and the JAX-initialised tiny
MobileSAM go into both packages' ``DetectionPipeline`` behind
``GroundingDinoQueryAdapter`` (64-px model input, 8 detections per frame,
no COCO detector). The JAX pipeline cannot run GroundingDINO on more than
one frame (its adapter passes the batch-1 caption as it is), so the port
runs both frames at once and JAX runs them one at a time. The
bi-directional attention's max is over the whole batch; a batch of two
differs from two single calls only where its +-50000 clip bites, which it
does not here. ``xyxy`` and ``scores`` are held to 1e-5, ``cls`` and
``valid`` exactly, masks to a flip fraction of 1e-3 (f32).

The JAX adapter keeps the spans of the last caption it encoded, and the
pipeline caches captions per target, so targets A, B, A make JAX's second
call for A read B's spans. The port keys spans by the caption: its
answers for A do not change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_grounding_dino import jax_params
from vlfm_tpu.models import grounding_dino as JG
from vlfm_tpu.models import sam as JS
from vlfm_tpu.parallel import detection_pipeline as JP
from vlfm_tpu_torch.models import grounding_dino as G
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.parallel import detection_pipeline as P

BOX_ATOL = 1e-5
MASK_FLIPS = 1e-3
K = 8


def tokenize(name):
    """Three token ids per class name, seeded by the name, clear of the
    special ids."""
    return np.random.default_rng(sum(map(ord, name))).integers(2, 99, 3)


@pytest.fixture(scope="module")
def models():
    cfg = JG.GroundingDinoJaxConfig.tiny_test()
    params = jax_params(cfg, seed=1)
    scfg = JS.SamConfig.tiny_mobile_sam()
    sam_p = jax.jit(JS.SamModule(scfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))["params"]
    return (
        (JG.GroundingDinoDetector(cfg, jax.tree_util.tree_map(jnp.asarray, params)), JS.SAM(scfg, sam_p)),
        (G.GroundingDinoDetector.from_jax_params(G.GroundingDinoConfig.tiny_test(), params, device="cpu"),
         S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), jax.tree_util.tree_map(np.asarray, sam_p),
                               device="cpu")),
    )


def _pipelines(models, threshold, coco_threshold=0.8):
    (jdet, jsam), (tdet, tsam) = models
    ja, ta = JG.GroundingDinoQueryAdapter(jdet, image_size=64), G.GroundingDinoQueryAdapter(tdet, image_size=64)
    kw = dict(coco_threshold=coco_threshold, non_coco_threshold=threshold, max_detections=K)
    return (JP.DetectionPipeline(ja, jsam, ja.make_query_encoder(tokenize), **kw),
            P.DetectionPipeline(ta, tsam, ta.make_query_encoder(tokenize), **kw))


def _frames():
    return np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)


def _assert_same(got, want):
    masks, valid, (xyxy, scores, cls) = got
    want_masks, want_valid, (want_xyxy, want_scores, want_cls) = want
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    np.testing.assert_allclose(xyxy.numpy(), np.asarray(want_xyxy), atol=BOX_ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=BOX_ATOL)
    assert float(np.mean(masks.numpy() != np.asarray(want_masks))) <= MASK_FLIPS


# Random weights put every score above 0.9, so the thresholds sit where
# these seeds' scores split with margins of 1e-4 or more.
@pytest.mark.parametrize("target,coco_threshold,threshold,n_valid", [
    ("fireplace|seating|stairs", 0.8, 0.0, [8, 8]),    # every slot valid: SAM segments all of them
    ("fireplace|seating|stairs", 0.8, 0.999, [7, 5]),
    # A COCO target without a COCO detector: frame 0 misses at 0.999 and
    # takes the retry at 0.99, frame 1 keeps its first pass.
    ("bed", 0.999, 0.99, [6, 3]),
])
def test_batched_pipeline_matches_jax_frame_by_frame(models, target, coco_threshold, threshold, n_valid):
    jpipe, tpipe = _pipelines(models, threshold, coco_threshold)
    rgb = _frames()
    got = tpipe(torch.from_numpy(rgb), target)
    masks, valid, (xyxy, _, cls) = got
    assert masks.shape == (2, K, 48, 64) and masks.dtype == torch.bool
    assert valid.sum(1).tolist() == n_valid
    assert int(cls[valid].max()) < len(target.split("|"))  # class ids index the caption's phrases
    assert not masks[~valid].any()
    for i in range(2):
        want = jpipe(jnp.asarray(rgb[i:i + 1]), target)
        _assert_same(tuple(t[i:i + 1] for t in got[:2]) + (tuple(t[i:i + 1] for t in got[2]),), want)


def test_spans_follow_the_cached_caption(models):
    """Targets A, B, A: the port's second call for A answers as its first."""
    jpipe, tpipe = _pipelines(models, 0.0)
    rgb = torch.from_numpy(_frames())
    a, b = "fireplace|seating|stairs", "bed"
    first = tpipe(rgb, a)
    other = tpipe(rgb, b)
    again = tpipe(rgb, a)
    assert list(tpipe._query_cache) == [a, b]
    assert int(other[2][2].max()) == 0
    assert int(first[2][2].max()) > 0  # a second or third phrase wins somewhere
    for x, y in zip(first[:2] + first[2], again[:2] + again[2]):
        assert torch.equal(x, y)
    # JAX's adapter reads B's single span on the cached call for A.
    jpipe(jnp.asarray(rgb[:1].numpy()), a)
    jpipe(jnp.asarray(rgb[:1].numpy()), b)
    stale = jpipe(jnp.asarray(rgb[:1].numpy()), a)
    assert int(np.asarray(stale[2][2]).max()) == 0


def test_adapter_surface(models):
    (jdet, _), (tdet, _) = models
    ta = G.GroundingDinoQueryAdapter(tdet, image_size=64)
    assert ta.device == tdet.device == torch.device("cpu")
    rgb = _frames()
    np.testing.assert_allclose(ta.preprocess(torch.from_numpy(rgb)).numpy(),
                               np.asarray(JG.GroundingDinoQueryAdapter(jdet, 64).preprocess(jnp.asarray(rgb))),
                               atol=1e-6)
    ids, mask = ta.make_query_encoder(tokenize)(["chair", "bed"])
    assert ids.shape == mask.shape == (1, 16) and ids[0, 0] == 101
    boxes, logits = ta.detect(ta.preprocess(torch.from_numpy(rgb)), torch.as_tensor(ids), torch.as_tensor(mask))
    assert boxes.shape == (2, 10, 4) and logits.shape == (2, 10, 2)
