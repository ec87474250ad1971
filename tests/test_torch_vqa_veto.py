"""vlfm_tpu_torch's VQA veto against vlfm_tpu's, on the CPU.

The veto of both packages asks the same tiny T5 (seeded numpy weights in
JAX's tree, tests/test_torch_t5_vqa.py) about the same annotated frames.
Its visual prefix is JAX's test projection (``_toy_image_prefix``: frames
pooled to 4x4 by a linear resize, times a fixed N(0, 0.02²) matrix drawn by
``jax.random``); the port takes that matrix as numpy behind its own
callable. Held against JAX: the questions (JAX's own cases), the contour
ring exactly, the dense veto exactly, the gated veto at capacities 1, 2, 3,
6 and 8 against JAX's dense result exactly, and the per-detection phrase
bank. At the pipeline (tiny OWL-ViT with the COCO route and MobileSAM,
seeded numpy trees): the phrase index handed to the veto on every valid
slot (the COCO route's remap to the matched name, the open-vocabulary
retry's class, the select between them per frame) and the vetoed validity,
exactly. Port only: a half-size frame with ``out_hw`` is vetoed on its own
grid and its masks come out on the camera grid, and the no-VQA path is
unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_detection_pipeline import fake_encode
from tests.test_torch_full_stack import numpy_params
from tests.test_torch_t5_vqa import t5_params
from vlfm_tpu.models import coco_detector as JCD
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.models import sam as JS
from vlfm_tpu.models import t5_vqa as JT
from vlfm_tpu.ops import morphology as JM
from vlfm_tpu.parallel import detection_pipeline as JP
from vlfm_tpu.runner.full_stack import _toy_image_prefix
from vlfm_tpu_torch.models import coco_detector as CD
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.models import t5_vqa as T
from vlfm_tpu_torch.ops.morphology import dilate, erode
from vlfm_tpu_torch.ops.resize import resize_bilinear
from vlfm_tpu_torch.parallel import detection_pipeline as P

D_MODEL = T.T5Config.tiny().d_model
H, W = 32, 40


def encode_text(text):
    """JAX's test tokenizer (tests/test_vqa_veto.py): 8 ids from the
    question's first characters, EOS 1, padding 0."""
    ids = np.array([(3 + (ord(c) % 90)) for c in text[:8]] + [1], np.int32)[:8]
    pad = np.zeros(8, np.int32)
    pad[: len(ids)] = ids
    return pad, pad != 0


def toy_prefix(d_model=D_MODEL, tokens=4):
    """The port's twin of ``_toy_image_prefix``, on JAX's matrix."""
    w = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (48, tokens * d_model)) * 0.02))

    def prefix(rgb):
        b = rgb.shape[0]
        pooled = resize_bilinear(rgb.to(torch.float32) / 255.0, 4, 4).reshape(b, 48)
        return (pooled @ w.to(pooled.device)).reshape(b, tokens, d_model)

    return prefix


@pytest.fixture(scope="module")
def t5s():
    p = t5_params()
    return (JT.T5VQA(JT.T5Config.tiny(), jax.tree_util.tree_map(jnp.asarray, p)),
            T.T5VQA.from_jax_params(T.T5Config.tiny(), p, device="cpu"))


def vetoes(t5s, yes, **kw):
    jt5, tt5 = t5s
    return (JP.VQAVeto(vqa=jt5, encode_text=lambda t: tuple(map(jnp.asarray, encode_text(t))), yes_token_id=yes,
                       image_prefix=_toy_image_prefix(D_MODEL), **kw),
            P.VQAVeto(vqa=tt5, encode_text=encode_text, yes_token_id=yes, image_prefix=toy_prefix(), **kw))


def _inputs(b=3, k=2, seed=1):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
    masks = np.zeros((b, k, H, W), bool)
    for i in range(b):
        for j in range(k):
            y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
            masks[i, j, y:y + rng.integers(3, 9), x:x + rng.integers(3, 9)] = True
    valid = np.array([[1, 0], [1, 1], [0, 1]], bool) if (b, k) == (3, 2) else rng.random((b, k)) < 0.7
    return rgb, masks, valid


def _answers(jveto, rgb, masks, phrase="toilet"):
    """JAX's first answer token per slot of the dense batch."""
    ring = jax.vmap(jax.vmap(lambda m: JM.dilate(m, 3) & ~JM.erode(m, 3)))(jnp.asarray(masks))
    flat = jnp.where(ring[..., None], jnp.asarray([255, 0, 0], jnp.uint8), jnp.asarray(rgb)[:, None])
    flat = flat.reshape(-1, *rgb.shape[1:])
    ids, m = encode_text(jveto.question_for(phrase))
    n = flat.shape[0]
    gen = jveto.vqa.generate(jnp.broadcast_to(ids, (n, 8)), jnp.broadcast_to(m, (n, 8)), 4,
                             jveto.image_prefix(flat))
    return np.asarray(gen)[:, 0]


def test_question_formatting_matches_jax(t5s):
    jveto, tveto = vetoes(t5s, 0)
    for phrase in ("toilet", "sitting", "potted plant"):
        assert tveto.question_for(phrase) == jveto.question_for(phrase)
    assert tveto.question_for("toilet") == "Question: Is this a toilet? Answer:"
    assert tveto.question_for("sitting") == "Question: Is this sitting? Answer:"
    tveto.vqa_prompt = jveto.vqa_prompt = "Would you say this is "
    assert tveto.question_for("bed") == jveto.question_for("bed") == "Question: Would you say this is a bed? Answer:"


def test_contour_ring_matches_jax():
    _, masks, _ = _inputs(b=2, k=3, seed=4)
    want = jax.vmap(jax.vmap(lambda m: JM.dilate(m, 3) & ~JM.erode(m, 3)))(jnp.asarray(masks))
    m = torch.from_numpy(masks)
    got = dilate(m, 3) & ~erode(m, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not (got & ~dilate(m, 3)).any()


@pytest.fixture(scope="module")
def dense(t5s):
    """JAX's dense veto on 6 slots (4 valid), with the yes token the model
    gives slot 0, so that some slots keep and some drop."""
    rgb, masks, valid = _inputs()
    first = _answers(vetoes(t5s, 0)[0], rgb, masks)
    yes = int(first[0])
    jveto, _ = vetoes(t5s, yes)
    want = np.asarray(jveto(jnp.asarray(rgb), jnp.asarray(masks), jnp.asarray(valid), "toilet"))
    assert want.any() and (valid & ~want).any(), "the case needs a kept and a dropped valid slot"
    return yes, (rgb, masks, valid), want


def test_dense_veto_matches_jax(t5s, dense):
    yes, (rgb, masks, valid), want = dense
    _, tveto = vetoes(t5s, yes)
    got = tveto(torch.from_numpy(rgb), torch.from_numpy(masks), torch.from_numpy(valid), "toilet")
    np.testing.assert_array_equal(got.numpy(), want)
    assert tveto(torch.from_numpy(rgb), torch.from_numpy(masks), torch.zeros(3, 2, dtype=torch.bool),
                 "toilet").sum() == 0


@pytest.mark.parametrize("cap", [1, 2, 3, 6, 8])
def test_gated_veto_matches_jax_dense(t5s, dense, cap):
    yes, (rgb, masks, valid), want = dense
    _, tveto = vetoes(t5s, yes, slot_capacity=cap)
    asked = []
    ask = tveto._ask
    tveto._ask = lambda *a: asked.append(a[0].shape[0]) or ask(*a)
    got = tveto(torch.from_numpy(rgb), torch.from_numpy(masks), torch.from_numpy(valid), "toilet")
    np.testing.assert_array_equal(got.numpy(), want)
    n_valid = int(valid.sum())
    assert asked == ([6] if cap >= 6 else [cap] * -(-n_valid // cap)), asked


def test_phrase_bank_per_detection_cls_matches_jax(t5s, dense):
    yes, (rgb, masks, valid), _ = dense
    phrases = ["toilet", "sitting", "bed"]
    cls = np.array([[2, 0], [1, 5], [0, 1]], np.int32)  # 5 clips to the bank's last phrase
    jveto, tveto = vetoes(t5s, yes)
    want = np.asarray(jveto(jnp.asarray(rgb), jnp.asarray(masks), jnp.asarray(valid), phrases, jnp.asarray(cls)))
    got = tveto(torch.from_numpy(rgb), torch.from_numpy(masks), torch.from_numpy(valid), phrases,
                torch.from_numpy(cls))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(tveto._q_cache) == phrases


# --- the pipeline ---------------------------------------------------------------
class Recorder:
    """Stands in for a veto: records its arguments, then delegates."""

    def __init__(self, veto):
        self.veto, self.calls = veto, []

    def __call__(self, rgb, masks, valid, phrases, cls=None):
        self.calls.append(dict(masks=masks, valid=valid, phrases=phrases, cls=cls))
        return self.veto(rgb, masks, valid, phrases, cls)


@pytest.fixture(scope="module")
def detectors():
    ocfg, scfg = JO.OwlViTDetConfig.tiny(), JS.SamConfig.tiny_mobile_sam()
    ids, mask = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool)
    op = numpy_params(JO.OwlViTDetectionModule(ocfg), jnp.zeros((1, 64, 64, 3)), ids, mask, seed=7)
    sp = numpy_params(JS.SamModule(scfg), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return ((JO.OwlViTDetector(ocfg, to_jax(op)), JS.SAM(scfg, to_jax(sp))),
            (O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(), op, device="cpu"),
             S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), sp, device="cpu")))


def pipelines(detectors, t5s, yes, use_vqa=True, coco_conf=0.0):
    (jdet, jsam), (tdet, tsam) = detectors
    jveto, tveto = vetoes(t5s, yes)
    kw = dict(coco_threshold=0.8, non_coco_threshold=0.0, max_detections=4, sam_frame_capacity=None)
    return (JP.DetectionPipeline(jdet, jsam, fake_encode, JCD.CocoDetector(jdet, fake_encode, coco_conf, 4),
                                 Recorder(jveto) if use_vqa else None, use_vqa=use_vqa, **kw),
            P.DetectionPipeline(tdet, tsam, fake_encode, CD.CocoDetector(tdet, fake_encode, coco_conf, 4),
                                Recorder(tveto) if use_vqa else None, use_vqa=use_vqa, **kw))


def _frames(n=6, h=H, w=W):
    return np.random.default_rng(7).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_pipeline_phrase_index_and_veto_match_jax(detectors, t5s):
    """The COCO route's remap through argmax(cls == target ids), the
    open-vocabulary retry's class and the per-frame select reach the veto
    as JAX hands them; the vetoed validity equals JAX's. The yes token is
    the port's first answer on the first valid slot, so that some slots
    keep and some drop."""
    target = "chair|toilet"
    rgb = _frames()
    _, probe = pipelines(detectors, t5s, -1)
    tt5, answers = probe.vqa_veto.veto.vqa, []
    generate = tt5.generate
    tt5.generate = lambda *a, **kw: answers.append(generate(*a, **kw)[:, 0]) or answers[-1][:, None]
    try:
        _, before, _ = probe(torch.from_numpy(rgb), target)
    finally:
        tt5.generate = generate
    pre = probe.vqa_veto.calls[0]["valid"].numpy()
    yes = int(answers[0].reshape(pre.shape)[pre][0])
    jpipe, tpipe = pipelines(detectors, t5s, yes)
    jm, jv, (_, _, jcls) = jpipe(jnp.asarray(rgb), target)
    tm, tv, (_, _, tcls) = tpipe(torch.from_numpy(rgb), target)
    (jcall,), (tcall,) = jpipe.vqa_veto.calls, tpipe.vqa_veto.calls
    np.testing.assert_array_equal(tcall["valid"].numpy(), pre)
    np.testing.assert_array_equal(np.asarray(jcall["valid"]), pre)
    assert tcall["phrases"] == jcall["phrases"] == ["chair", "toilet"]
    np.testing.assert_array_equal(np.where(pre, tcall["cls"].numpy(), -1), np.where(pre, np.asarray(jcall["cls"]), -1))
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert float(np.mean(tm.numpy() != np.asarray(jm))) <= 1e-3
    # The case binds: frame 0 took the COCO route (a toilet, phrase 1) and
    # the others the retry; both phrases were asked about; the veto kept
    # some valid slots and dropped others.
    coco_frames = tpipe._coco_path(torch.from_numpy(rgb), target)[3].any(dim=1)
    assert coco_frames.tolist() == [True] + [False] * 5
    assert tcall["cls"][0, 0] == 1 and tcls[0, 0] == 61
    assert set(tcall["cls"].numpy()[pre].tolist()) == {0, 1}
    assert tv.any() and (torch.from_numpy(pre) & ~tv).any()
    assert not before.any()


def test_half_size_frame_is_vetoed_on_its_grid(detectors, t5s, dense):
    """A half-size frame with ``out_hw``: the veto paints contours on the
    frame it was given, so it sees masks on that grid; the masks that come
    back are on the camera grid, gated by the vetoed validity. Without the
    veto the pipeline is unchanged."""
    _, tpipe = pipelines(detectors, t5s, dense[0])
    _, plain = pipelines(detectors, t5s, dense[0], use_vqa=False)
    rgb = torch.from_numpy(_frames(4, H // 2, W // 2))
    masks, valid, _ = tpipe(rgb, "fireplace", (H, W))
    (call,) = tpipe.vqa_veto.calls
    assert call["masks"].shape[-2:] == (H // 2, W // 2) and masks.shape[-2:] == (H, W)
    small, valid_small, _ = tpipe(rgb, "fireplace")
    assert torch.equal(valid, valid_small) and small.shape[-2:] == (H // 2, W // 2)
    plain_masks, plain_valid, _ = plain(rgb, "fireplace", (H, W))
    assert torch.equal(masks, plain_masks & valid[:, :, None, None])
    assert not (valid & ~plain_valid).any(), "the veto only narrows"
    assert plain_valid.any()


def test_use_vqa_needs_a_veto(detectors):
    _, (tdet, tsam) = detectors
    with pytest.raises(ValueError, match="vqa_veto"):
        P.DetectionPipeline(tdet, tsam, fake_encode, use_vqa=True)


def test_matched_name():
    cls = torch.tensor([[56, 61, 3], [61, 0, 56]], dtype=torch.int32)  # chair, toilet, other
    assert P.matched_name(cls, ["chair", "toilet"]).tolist() == [[0, 1, 0], [1, 0, 0]]
    assert P.matched_name(cls, ["fireplace", "toilet"]).tolist() == [[0, 1, 0], [1, 0, 0]]
    assert dataclasses.is_dataclass(P.VQAVeto)
