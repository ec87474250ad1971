"""vlfm_tpu_torch's MobileSAM against vlfm_tpu's, on the CPU.

JAX initialises ``SamConfig.tiny_mobile_sam()``; ``SAM.from_jax_params``
loads the same weights into the port; both segment the same numpy images
and boxes. f32 mask logits and IoU scores are held to 1e-4 (plus 1e-4
relative). bf16 serving (``cast_for_serving`` on both sides, the JAX side on
its ``encode_fused`` path in interpret mode) is held to 0.05 on the logits:
bf16 rounds at other places in the two encoders, and JAX's own bf16 logits
differ from its f32 ones by 0.03 here. Masks threshold logits at 0, so they
are held to a fraction of flipped pixels, never to bit equality across
implementations. In bf16 a logit's error shrinks with its size: the
random tiny decoder's mask logits are within 0.01 of 0 at 56 % of the
pixels, and the masks must agree on every other pixel (2.1 % of all pixels
flip here, all of them closer to 0). Gated segmentation is held bit for bit to
the port's ungated masks on every frame with a detection.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import sam as JS
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.models.params import state_dict_from_jax_params
from vlfm_tpu_torch.models.precision import cast_for_serving

F32_ATOL = 1e-4
BF16_ATOL = 5e-2
F32_FLIPS = 1e-3  # fraction of mask pixels, f32
BF16_MARGIN = 1e-2  # bf16 masks agree where |JAX logit| exceeds this


@pytest.fixture(scope="module")
def pair():
    cfg = JS.SamConfig.tiny_mobile_sam()
    s = cfg.vision.image_size
    params = jax.jit(JS.SamModule(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, 1, 4)))["params"]
    jsam = JS.SAM(cfg, params)
    tsam = S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), jax.tree_util.tree_map(np.asarray, params))
    return jsam, tsam


def _inputs(b=3, nb=2, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b, 64, 64, 3)).astype(np.float32)
    lo = rng.uniform(0.0, 0.5, (b, nb, 2))
    hi = lo + rng.uniform(0.1, 0.5, (b, nb, 2))
    boxes = np.concatenate([lo, np.minimum(hi, 1.0)], -1).astype(np.float32)
    return imgs, boxes


def _flips(a, b):
    return float(np.mean(np.asarray(a) != np.asarray(b)))


def test_configs_match_jax():
    for port, ref in ((S.SamConfig.mobile_sam(), JS.SamConfig.mobile_sam()),
                      (S.SamConfig.tiny_mobile_sam(), JS.SamConfig.tiny_mobile_sam())):
        assert dataclasses.asdict(port.decoder) == dataclasses.asdict(ref.decoder)
        assert port.pe_dim == ref.pe_dim and port.vision.grid == ref.vision.grid
        assert (port.vision.image_size, port.vision.out_channels) == (
            ref.vision.image_size, ref.vision.out_channels)
        t, j = dataclasses.asdict(port.tinyvit), dataclasses.asdict(ref.tinyvit)
        assert str(t.pop("compute_dtype")).split(".")[-1] == str(j.pop("compute_dtype")).split(".")[-1].split("'")[0]
        assert t == j


def test_f32_logits_iou_and_masks_match_jax(pair):
    jsam, tsam = pair
    imgs, boxes = _inputs()
    # SamModule.__call__ (the flax TinyViT, exact GELU), jitted
    want_logits, want_iou = JS.SAM._segment(jsam.module, jsam.params, jnp.asarray(imgs), jnp.asarray(boxes))
    with torch.no_grad():
        logits, iou = tsam.module(torch.from_numpy(imgs), torch.from_numpy(boxes))
    assert logits.shape == (3, 2, 4, 16, 16) and iou.shape == (3, 2, 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=F32_ATOL, rtol=F32_ATOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=F32_ATOL, rtol=F32_ATOL)
    want_m = np.asarray(want_logits)[:, :, 0] > 0.0  # SAM.segment_boxes: mask token 0
    got_m, got_i = tsam.segment_boxes(torch.from_numpy(imgs), torch.from_numpy(boxes))
    assert got_m.dtype == torch.bool and got_m.shape == (3, 2, 16, 16)
    assert _flips(got_m.numpy(), want_m) <= F32_FLIPS
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_iou), atol=F32_ATOL, rtol=F32_ATOL)


def test_bf16_serving_matches_jax_encode_fused(pair):
    jsam, tsam = pair
    imgs, boxes = _inputs(seed=1)
    jcfg = dataclasses.replace(jsam.cfg, tinyvit=dataclasses.replace(jsam.cfg.tinyvit, compute_dtype=jnp.bfloat16))
    jparams = jax_cast_for_serving(jsam.params)
    want_logits, want_iou = JS.SAM._segment(JS.SamModule(jcfg), jparams, jnp.asarray(imgs), jnp.asarray(boxes),
                                            fused=True)
    tcfg = dataclasses.replace(tsam.cfg, tinyvit=dataclasses.replace(tsam.cfg.tinyvit, compute_dtype=torch.bfloat16))
    module = S.SamModule(tcfg)
    module.load_state_dict(tsam.module.state_dict())
    t16 = S.SAM(tcfg, cast_for_serving(module))
    emb = t16.encode(torch.from_numpy(imgs))
    assert emb.dtype == torch.float32  # the neck's f32 LayerNorm2d scale promotes, as in JAX
    with torch.no_grad():
        logits, iou = t16.module.decode_boxes(emb, torch.from_numpy(boxes))
    want_logits = np.asarray(want_logits, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), want_logits, atol=BF16_ATOL)
    np.testing.assert_allclose(iou.float().numpy(), np.asarray(want_iou, np.float32), atol=BF16_ATOL)
    far = np.abs(want_logits[:, :, 0]) > BF16_MARGIN
    assert far.mean() > 0.3
    assert _flips(logits[:, :, 0].numpy()[far] > 0, want_logits[:, :, 0][far] > 0) == 0.0


@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_gated_equals_ungated_on_detection_frames(pair, capacity):
    """B = 5 with detections on frames 0, 2, 3, 4: at capacity 2 the third
    pass's window is clamped to frames [3, 5) of the order and re-segments
    one frame."""
    jsam, tsam = pair
    imgs, boxes = _inputs(b=5, nb=3, seed=2)
    valid = np.array([[1, 0, 1], [0, 0, 0], [0, 1, 0], [1, 1, 1], [0, 0, 1]], bool)
    ungated, _ = tsam.segment_boxes(torch.from_numpy(imgs), torch.from_numpy(boxes))
    calls = []
    real = tsam.segment_boxes

    def counting(im, bx):
        calls.append(im.shape[0])
        return real(im, bx)

    tsam.segment_boxes = counting
    try:
        gated, kept = tsam.segment_boxes_gated(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                               torch.from_numpy(valid), capacity)
    finally:
        del tsam.segment_boxes
    assert calls == [capacity] * -(-4 // capacity)
    has = valid.any(1)
    assert torch.equal(gated[torch.from_numpy(has)], ungated[torch.from_numpy(has)])
    assert torch.equal(kept, torch.from_numpy(valid))
    if capacity < 5:
        assert not gated[1].any()  # the empty frame sorts last and is never taken
    want, _ = jsam.segment_boxes_gated(jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid), capacity,
                                       fused=False)
    assert _flips(gated.numpy()[has], np.asarray(want)[has]) <= F32_FLIPS


def test_cast_for_serving_dtypes_match_jax(pair):
    jsam, tsam = pair
    j16 = jax.tree_util.tree_map(np.asarray, jax_cast_for_serving(jsam.params))
    want = {k: v.dtype for k, v in state_dict_from_jax_params(j16).items()}
    module = S.SamModule(tsam.cfg)
    module.load_state_dict(tsam.module.state_dict())
    got = {k: v.dtype for k, v in cast_for_serving(module).state_dict().items()}
    assert got == want
    # a norm scope keeps both leaves; neck_ln1 is not one, so only its scale stays f32
    assert got["decoder.layer0.ln1.bias"] == got["vision.neck_ln1.weight"] == torch.float32
    assert got["vision.neck_ln1.bias"] == got["decoder.upscale_conv1.weight"] == torch.bfloat16
    assert got["vision.stage1_block0.attn.norm.weight"] == torch.float32


def test_from_jax_params_layouts_and_strictness(pair):
    jsam, tsam = pair
    sd = tsam.module.state_dict()
    up = np.asarray(jsam.params["decoder"]["upscale_conv1"]["kernel"])  # (2, 2, Cin, Cout)
    np.testing.assert_array_equal(sd["decoder.upscale_conv1.weight"].numpy(), up.transpose(3, 2, 0, 1))
    g = np.asarray(jsam.params["shared_pe"]["gaussian"])
    np.testing.assert_array_equal(sd["shared_pe.gaussian"].numpy(), g)
    params_np = jax.tree_util.tree_map(np.asarray, jsam.params)
    del params_np["no_mask_embed"]
    with pytest.raises(RuntimeError, match="no_mask_embed"):
        S.SAM.from_jax_params(tsam.cfg, params_np)
