"""vlfm_tpu_torch's OWL-ViT detector and COCO route against vlfm_tpu's, on
the CPU.

JAX initialises ``OwlViTDetConfig.tiny()``; ``OwlViTDetector.from_jax_params``
loads the same weights into the port; both detect on the same numpy images
and token ids. f32 boxes and logits are held to 1e-4. bf16 serving
(``cast_for_serving`` on both sides) is held to 0.1 on logits up to ~5 and
1e-2 on boxes in [0, 1]: the two frameworks round their bf16 matmuls and
reductions at other places, and JAX's own bf16 result differs from its f32
one by 0.07 and 3e-3 here.
``top_detections`` must give the same boxes in the same order, ties
included. The port's LayerNorms run their plain version here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import coco_detector as JCD
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu_torch.models import coco_detector as CD
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models.layers import FastLayerNorm
from vlfm_tpu_torch.models.params import state_dict_from_jax_params
from vlfm_tpu_torch.models.precision import cast_for_serving

F32_ATOL = 1e-4
BF16_LOGIT_ATOL = 0.1
BF16_BOX_ATOL = 1e-2


@pytest.fixture(scope="module")
def pair():
    cfg = JO.OwlViTDetConfig.tiny()
    s = cfg.vision.image_size
    params = jax.jit(JO.OwlViTDetectionModule(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, 4), jnp.int32),
        jnp.ones((1, 4), bool))["params"]
    jdet = JO.OwlViTDetector(cfg, params)
    tdet = O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(), jax.tree_util.tree_map(np.asarray, params))
    return jdet, tdet


def fake_encode(names):
    """Token ids (T, 8) seeded by the names, ending in the EOT (max) id."""
    rng = np.random.default_rng(sum(map(ord, "|".join(names))))
    ids = rng.integers(1, 98, (len(names), 8)).astype(np.int32)
    ids[:, -1] = 99
    mask = np.ones_like(ids, bool)
    mask[::2, 6] = False
    return ids, mask


def _images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, 64, 64, 3)).astype(np.float32)


def test_configs_match_jax():
    for port, ref in ((O.OwlViTDetConfig(), JO.OwlViTDetConfig()),
                      (O.OwlViTDetConfig.tiny(), JO.OwlViTDetConfig.tiny())):
        assert dataclasses.asdict(port.vision) == dataclasses.asdict(ref.vision)
        assert dataclasses.asdict(port.text) == dataclasses.asdict(ref.text)
        assert port.projection_dim == ref.projection_dim
        assert port.compute_dtype == torch.float32 and ref.compute_dtype == jnp.float32


def test_f32_boxes_and_logits_match_jax(pair):
    jdet, tdet = pair
    imgs = _images()
    ids, mask = fake_encode(["chair", "bed", "potted plant"])
    want_boxes, want_logits = jdet.detect(jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask))
    boxes, logits = tdet.detect(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(mask))
    assert boxes.shape == (2, 64, 4) and logits.shape == (2, 64, 3)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), atol=F32_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=F32_ATOL)
    np.testing.assert_allclose(O.box_bias(8).numpy(), np.asarray(JO.box_bias(8)), atol=1e-6)


def test_bf16_serving_matches_jax(pair):
    jdet, tdet = pair
    imgs = _images(seed=1)
    ids, mask = fake_encode(["toilet"])
    jcfg = dataclasses.replace(jdet.cfg, compute_dtype=jnp.bfloat16)
    j16 = JO.OwlViTDetector(jcfg, jax_cast_for_serving(jdet.params))
    want_boxes, want_logits = j16.detect(jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask))
    tcfg = dataclasses.replace(tdet.cfg, compute_dtype=torch.bfloat16)
    module = O.OwlViTDetectionModule(tcfg)
    module.load_state_dict(tdet.module.state_dict())
    t16 = O.OwlViTDetector(tcfg, cast_for_serving(module))
    boxes, logits = t16.detect(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(mask))
    assert logits.dtype == torch.bfloat16 and boxes.dtype == torch.float32
    assert want_logits.dtype == jnp.bfloat16 and want_boxes.dtype == jnp.float32
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(want_logits, np.float32), atol=BF16_LOGIT_ATOL)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), atol=BF16_BOX_ATOL)


def test_cast_for_serving_dtypes_match_jax(pair):
    jdet, tdet = pair
    j16 = jax.tree_util.tree_map(np.asarray, jax_cast_for_serving(jdet.params))
    want = {k: v.dtype for k, v in state_dict_from_jax_params(j16).items()}
    module = O.OwlViTDetectionModule(tdet.cfg)
    module.load_state_dict(tdet.module.state_dict())
    got = {k: v.dtype for k, v in cast_for_serving(module).state_dict().items()}
    assert got == want
    assert got["merge_ln.weight"] == got["vision.layer0.ln1.bias"] == torch.float32
    assert got["logit_scale.weight"] == got["text.token_embed.weight"] == torch.bfloat16


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_top_detections_match_jax_including_ties(dtype):
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0.05, 0.95, (3, 12, 4)).astype(np.float32)
    logits = rng.choice(np.array([-2.0, -0.5, 0.0, 0.5, 1.0], np.float32), (3, 12, 4))
    logits[1] = 0.25  # every box and class tied
    jl = jnp.asarray(logits).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tl = torch.from_numpy(logits).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = JO.top_detections(jnp.asarray(boxes), jl, capacity=5, threshold=0.6)
    got = O.top_detections(torch.from_numpy(boxes), tl, capacity=5, threshold=0.6)
    for g, w, name in zip(got, want, ("xyxy", "scores", "cls", "valid")):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32), err_msg=name)
    assert got[2].dtype == torch.int32


def test_coco_detector_matches_jax(pair):
    jdet, tdet = pair
    rgb = np.random.default_rng(4).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    want = JCD.CocoDetector(jdet, fake_encode, conf_threshold=0.45, max_detections=4).predict(jnp.asarray(rgb))
    coco = CD.CocoDetector(tdet, fake_encode, conf_threshold=0.45, max_detections=4)
    got = coco.predict(torch.from_numpy(rgb))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=F32_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=F32_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert coco._queries[0].shape == (80, 8)
    np.testing.assert_allclose(tdet.preprocess(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jdet.preprocess(jnp.asarray(rgb))), atol=1e-6)


def _norm_calls(module, fn):
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1))
             for m in module.modules() if isinstance(m, FastLayerNorm)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


def test_layer_norm_calls_per_detect(pair):
    """K1 launches chip_smoke.py expects of one detect: 27 per vision pass
    (pre_ln, 2 per layer, post_ln, merge_ln) and 25 per text encoding (2 per
    layer, final_ln) at full width."""
    full = O.OwlViTDetConfig()
    assert (1 + 2 * full.vision.layers + 2, 2 * full.text.layers + 1) == (27, 25)
    _, tdet = pair
    ids, mask = fake_encode(["chair"])
    got = _norm_calls(tdet.module, lambda: tdet.detect(torch.from_numpy(_images()), torch.from_numpy(ids),
                                                       torch.from_numpy(mask)))
    assert got == (1 + 2 * 2 + 2) + (2 * 2 + 1)
