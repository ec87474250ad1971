"""vlfm_tpu_torch's ViT-det SAM (sam-vit-base's encoder) against vlfm_tpu's,
on the CPU.

JAX's trees for ``SamConfig.tiny()`` and ``full_stack.tiny_sam_config()``
get seeded numpy leaves (``jax.eval_shape`` of the init gives the
structure; flax's own init leaves the relative-position tables and the
position embedding at zero, which would not exercise them);
``SAM.from_jax_params`` loads the same weights into the port; both encode
and segment the same numpy images and boxes, in f32 and under
``cast_for_serving`` (bf16 weights; the ViT-det encoder computes in f32 in
both packages, since its norms keep f32 parameters and every bf16 Dense
promotes). Held:

- the image embeddings and the mask logits to 1e-5 of their largest
  entry, the iou scores to 1e-5, and the masks equal at every pixel whose
  JAX logit is farther than 1e-4 from 0, with ``multimask_output`` off and
  on;
- gated segmentation equal to ungated, bit for bit, on every frame with a
  detection, at every density of detection frames;
- ``_interp_rel_pos`` (``jax.image.resize``'s linear, anti-aliased when it
  shrinks) to 1e-6, shrinking and growing;
- the HF layout: a tiny random ``transformers.SamModel`` built from code,
  through JAX's ``convert_hf_sam``, into both packages;
- the configs field for field, and ``SamConfig()`` building sam-vit-base's
  ViT-det encoder (93.7 M parameters with the decoder).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.models import sam as JS
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu.runner import full_stack as JFS
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.runner import full_stack as FS

EMB_RTOL = 1e-5  # of the embedding's largest entry
IOU_ATOL = 1e-5
LOGIT_MARGIN = 1e-4  # masks agree wherever |JAX logit| exceeds this
INTERP_ATOL = 1e-6

CONFIGS = {"tiny": (JS.SamConfig.tiny, S.SamConfig.tiny),
           "tiny_sam_config": (JFS.tiny_sam_config, FS.tiny_sam_config)}


def _init(jcfg, seed=0):
    """Seeded numpy leaves in the structure of flax's init: kernels
    N(0, 1/fan_in), norm scales 1 +- 0.1, relative-position tables and the
    position embedding N(0, 0.5^2), prompt and token embeddings N(0, 1),
    biases N(0, 0.1^2)."""
    s = jcfg.vision.image_size
    shapes = jax.eval_shape(JS.SamModule(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                            jnp.zeros((1, 1, 4)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, n = path[-1].key, rng.normal(size=x.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "scale":
            n = 1 + 0.1 * n
        elif name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
            n = 0.5 * n
        elif name == "bias":
            n = 0.1 * n
        return jnp.asarray(n.astype(x.dtype))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_encode = jax.jit(lambda module, params, imgs: module.apply({"params": params}, imgs,
                                                            method=JS.SamModule.encode_image),
                  static_argnums=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jmake, tmake = CONFIGS[request.param]
    jcfg, tcfg = jmake(), tmake()
    params = _init(jcfg)
    return JS.SAM(jcfg, params), S.SAM.from_jax_params(tcfg, _np(params), device="cpu")


def _inputs(b=3, nb=2, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b, 64, 64, 3)).astype(np.float32)
    lo = rng.uniform(0.0, 0.5, (b, nb, 2))
    hi = lo + rng.uniform(0.1, 0.5, (b, nb, 2))
    boxes = np.concatenate([lo, np.minimum(hi, 1.0)], -1).astype(np.float32)
    return imgs, boxes


def _selected(logits, iou, multimask):
    """JAX's SAM.segment_boxes selection, on its logits."""
    if multimask:
        best = np.argmax(iou[..., 1:], axis=-1) + 1
        return np.take_along_axis(logits, best[..., None, None, None], axis=2)[:, :, 0]
    return logits[:, :, 0]


def _hold(jsam, jparams, tsam, imgs, boxes, min_far=0.9):
    want_emb = np.asarray(_encode(jsam.module, jparams, jnp.asarray(imgs)), np.float32)
    emb = tsam.encode(torch.from_numpy(imgs))
    assert emb.dtype == torch.float32 and emb.shape == want_emb.shape
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=EMB_RTOL * np.abs(want_emb).max(), rtol=0)
    logits, iou = JS.SAM._segment(jsam.module, jparams, jnp.asarray(imgs), jnp.asarray(boxes))
    logits, iou = np.asarray(logits, np.float32), np.asarray(iou, np.float32)
    with torch.no_grad():
        got_logits, _ = tsam.module.decode_boxes(emb, torch.from_numpy(boxes))
    np.testing.assert_allclose(got_logits.float().numpy(), logits, atol=EMB_RTOL * np.abs(logits).max(), rtol=0)
    for multimask in (False, True):
        masks, got_iou = tsam.segment_boxes(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                            multimask_output=multimask)
        np.testing.assert_allclose(got_iou.float().numpy(), iou, atol=IOU_ATOL, rtol=0)
        want = _selected(logits, iou, multimask)
        far = np.abs(want) > LOGIT_MARGIN
        assert far.mean() >= min_far
        np.testing.assert_array_equal(masks.numpy()[far], want[far] > 0.0)
        jm, _ = jsam.segment_boxes(jnp.asarray(imgs), jnp.asarray(boxes), multimask_output=multimask)
        np.testing.assert_array_equal(masks.numpy()[far], np.asarray(jm)[far])


def test_f32_embeddings_iou_and_masks_match_jax(pair):
    jsam, tsam = pair
    assert isinstance(tsam.module.vision, S.SamVisionEncoder)
    imgs, boxes = _inputs()
    _hold(jsam, jsam.params, tsam, imgs, boxes)


def test_serving_cast_matches_jax(pair):
    jsam, tsam = pair
    jparams = jax_cast_for_serving(jsam.params)
    module = S.SamModule(tsam.cfg)
    module.load_state_dict(tsam.module.state_dict())
    t16 = S.SAM(tsam.cfg, cast_for_serving(module))
    assert t16.module.vision.block0.attn.qkv.weight.dtype == torch.bfloat16
    assert t16.module.vision.block0.ln1.weight.dtype == torch.float32
    imgs, boxes = _inputs(seed=1)
    _hold(JS.SAM(jsam.cfg, jparams), jparams, t16, imgs, boxes)


@pytest.mark.parametrize("density", range(6))
def test_gated_equals_ungated_at_every_density(pair, density):
    """B = 5 frames, ``density`` of them with detections, capacity 2."""
    jsam, tsam = pair
    imgs, boxes = _inputs(b=5, nb=2, seed=2)
    valid = np.zeros((5, 2), bool)
    frames = np.random.default_rng(density).permutation(5)[:density]
    valid[frames, np.arange(density) % 2] = True
    has = torch.from_numpy(valid.any(1))
    for multimask in (False, True):
        ungated, _ = tsam.segment_boxes(torch.from_numpy(imgs), torch.from_numpy(boxes), multimask)
        gated, kept = tsam.segment_boxes_gated(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                               torch.from_numpy(valid), 2, multimask)
        assert torch.equal(gated[has], ungated[has])
        assert torch.equal(kept, torch.from_numpy(valid))
        if density < 5:
            assert not gated[~has].any() or density % 2  # an odd count's last pass takes one empty frame


@pytest.mark.parametrize("rows,size", [(9, 3), (5, 4), (7, 4)])
def test_interp_rel_pos_matches_jax(rows, size):
    """(9, 3): shrink 9 -> 5 rows (anti-aliased); (5, 4): grow to 7; (7, 4):
    the size it has, unchanged."""
    table = np.random.default_rng(rows).standard_normal((rows, 6)).astype(np.float32)
    want = np.asarray(JS._interp_rel_pos(jnp.asarray(table), size))
    got = S._interp_rel_pos(torch.from_numpy(table), size).numpy()
    assert got.shape == want.shape == (2 * size - 1, 6)
    np.testing.assert_allclose(got, want, atol=INTERP_ATOL, rtol=0)


def _tiny_hf_sam():
    from transformers import SamConfig as HFSamConfig
    from transformers import SamMaskDecoderConfig, SamModel, SamPromptEncoderConfig, SamVisionConfig

    vc = SamVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                         image_size=64, patch_size=8, global_attn_indexes=[1], window_size=2, output_channels=16,
                         num_pos_feats=8)
    pc = SamPromptEncoderConfig(hidden_size=16, image_size=64, patch_size=8, mask_input_channels=4)
    mc = SamMaskDecoderConfig(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, mlp_dim=32,
                              iou_head_depth=2, iou_head_hidden_dim=16)
    cfg = HFSamConfig(vision_config=vc.to_dict(), prompt_encoder_config=pc.to_dict(),
                      mask_decoder_config=mc.to_dict())
    torch.manual_seed(0)
    return SamModel(cfg).eval()


def test_hf_layout_through_convert_hf_sam():
    """A tiny random ``transformers.SamModel`` (sam-vit-base's layout and
    scope names) converted by JAX's ``convert_hf_sam`` loads into the port
    strictly, and both packages segment alike. HF's 0.02-scale init leaves
    the mask logits near 0, so the logits carry this case."""
    hf = _tiny_hf_sam()
    jcfg = JFS.tiny_sam_config()
    params = JS.convert_hf_sam(hf.state_dict(), jcfg)
    jsam = JS.SAM(jcfg, params)
    tsam = S.SAM.from_jax_params(FS.tiny_sam_config(), _np(params), device="cpu")
    imgs, boxes = _inputs(b=2, seed=4)
    _hold(jsam, params, tsam, imgs, boxes, min_far=0.0)


def test_configs_match_jax_field_for_field():
    pairs = [(S.SamConfig(), JS.SamConfig()), (S.SamConfig.tiny(), JS.SamConfig.tiny()),
             (FS.tiny_sam_config(), JFS.tiny_sam_config()),
             (S.SamConfig.mobile_sam(), JS.SamConfig.mobile_sam()),
             (S.SamConfig.tiny_mobile_sam(), JS.SamConfig.tiny_mobile_sam())]
    for port, ref in pairs:
        assert dataclasses.asdict(port.vision) == dataclasses.asdict(ref.vision)
        assert dataclasses.asdict(port.decoder) == dataclasses.asdict(ref.decoder)
        assert port.pe_dim == ref.pe_dim
        assert (port.tinyvit is None) == (ref.tinyvit is None)
        if port.tinyvit is not None:
            t, j = dataclasses.asdict(port.tinyvit), dataclasses.asdict(ref.tinyvit)
            tdt, jdt = t.pop("compute_dtype"), j.pop("compute_dtype")
            assert (tdt is None and jdt is None) or str(tdt).split(".")[-1] == np.dtype(jdt).name
            assert t == j


def test_default_config_is_sam_vit_base():
    """``SamConfig()`` is facebook/sam-vit-base: a ViT-det encoder of 12
    blocks at width 768, global attention at blocks 2, 5, 8 and 11."""
    cfg = S.SamConfig()
    assert cfg.tinyvit is None
    module = S.SamModule(cfg, device="meta")
    vision = module.vision
    assert isinstance(vision, S.SamVisionEncoder)
    assert [getattr(vision, f"block{i}").is_global for i in range(12)] == [i in (2, 5, 8, 11) for i in range(12)]
    assert vision.block2.attn.rel_pos_h.shape == (127, 64) and vision.block0.attn.rel_pos_h.shape == (27, 64)
    assert vision.pos_embed.shape == (64, 64, 768)
    n = sum(p.numel() for p in module.parameters())
    assert round(n / 1e6, 1) == 93.7
    jparams = jax.eval_shape(JS.SamModule(JS.SamConfig()).init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 1024, 1024, 3)), jnp.zeros((1, 1, 4)))["params"]
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams)) == n


@pytest.mark.parametrize("capacity", [None, 2])
def test_detection_pipeline_takes_the_vitdet_sam_as_jax(capacity):
    """tests/test_torch_detection_pipeline.py's pipeline with the tiny
    ViT-det SAM in place of MobileSAM, against JAX's with the same SAM:
    boxes to 1e-5, validity and classes exactly, masks to a flip fraction
    of 1e-3; and ``FullStackPerception`` serves it unchanged."""
    from tests.test_torch_detection_pipeline import BOX_ATOL, MASK_FLIPS, _frames, fake_encode
    from vlfm_tpu.models import coco_detector as JCD
    from vlfm_tpu.models import owl_vit as JO
    from vlfm_tpu.parallel import detection_pipeline as JP
    from vlfm_tpu_torch.config import CameraConfig, VLFMConfig
    from vlfm_tpu_torch.models import coco_detector as CD
    from vlfm_tpu_torch.models import owl_vit as O
    from vlfm_tpu_torch.parallel import detection_pipeline as P

    ocfg = JO.OwlViTDetConfig.tiny()
    det_p = jax.jit(JO.OwlViTDetectionModule(ocfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 4), jnp.int32),
        jnp.ones((1, 4), bool))["params"]
    jdet, tdet = JO.OwlViTDetector(ocfg, det_p), O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(),
                                                                                  _np(det_p), device="cpu")
    sam_p = _init(JFS.tiny_sam_config(), seed=1)
    jsam, tsam = JS.SAM(JFS.tiny_sam_config(), sam_p), S.SAM.from_jax_params(FS.tiny_sam_config(), _np(sam_p),
                                                                             device="cpu")
    cfg = VLFMConfig()
    kw = dict(coco_threshold=cfg.coco_threshold, non_coco_threshold=cfg.non_coco_threshold,
              max_detections=cfg.max_detections_per_frame, sam_frame_capacity=capacity)
    jpipe = JP.DetectionPipeline(jdet, jsam, fake_encode,
                                 coco_detector=JCD.CocoDetector(jdet, fake_encode, max_detections=8), **kw)
    tpipe = P.DetectionPipeline(tdet, tsam, fake_encode,
                                coco_detector=CD.CocoDetector(tdet, fake_encode, max_detections=8), **kw)
    rgb = _frames()
    want_masks, want_valid, (want_xyxy, _, want_cls) = jpipe(jnp.asarray(rgb), "toilet")
    masks, valid, (xyxy, _, cls) = tpipe(torch.from_numpy(rgb), "toilet")
    assert valid.any()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    np.testing.assert_allclose(xyxy.numpy(), np.asarray(want_xyxy), atol=BOX_ATOL)
    assert float(np.mean(masks.numpy() != np.asarray(want_masks))) <= MASK_FLIPS
    assert masks[valid].any() and not masks[~valid].any()
    pcfg = VLFMConfig(camera=CameraConfig(height=48, width=64), sam_frame_capacity=capacity)
    perception = FS.FullStackPerception(pcfg, sam=tsam, device="cpu")
    _, pmasks, _ = perception.batch(rgb, "toilet")
    assert pmasks.shape[-2:] == (48, 64) and pmasks.dtype == torch.bool and perception.pipeline.sam is tsam
