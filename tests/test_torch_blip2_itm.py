"""vlfm_tpu_torch BLIP2-ITM against vlfm_tpu's, on the CPU.

JAX initialises the tiny model; ``from_jax_params`` loads the same weights
into the port; both score the same numpy images and token ids. f32 compute
is held to 1e-4; bf16 serving (``cast_for_serving`` on both sides) to 3e-2.
The port's LayerNorms run their plain version here, as the JAX side runs its
CPU path.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.models import qformer as JQ
from vlfm_tpu.models import vit as JV
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu.ops import resize as JR
from vlfm_tpu_torch.models import blip2_itm as B
from vlfm_tpu_torch.models import qformer as Q
from vlfm_tpu_torch.models import vit as V
from vlfm_tpu_torch.models.layers import FastLayerNorm
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.ops import resize as R

F32_ATOL = 1e-4
BF16_ATOL = 3e-2
PROMPTS = ["seems like there is a chair ahead", "a bed", "toilet"]


@pytest.fixture(scope="module")
def pair():
    """(jax wrapper, port wrapper) with the same f32 weights: those of
    ``BLIP2ITM.init_random(tiny, seed=0)``, drawn under jit (the same
    threefry bits, a few seconds sooner)."""
    jcfg = dataclasses.replace(JB.BLIP2ITMConfig.tiny(), compute_dtype=jnp.float32)
    s = jcfg.vit.image_size
    init = jax.jit(JB.BLIP2ITMModule(jcfg).init)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                  jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool))["params"]
    jitm = JB.BLIP2ITM(jcfg, params)
    params_np = jax.tree_util.tree_map(np.asarray, jitm.params)
    tcfg = dataclasses.replace(B.BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    return jitm, B.BLIP2ITM.from_jax_params(tcfg, params_np, device="cpu")


def _inputs(n_img=3):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (n_img, 56, 56, 3)).astype(np.float32)
    ids, mask = WordPieceTokenizer(toy_vocab(), max_len=16).encode_batch(PROMPTS)
    return imgs, ids, mask


def test_configs_match_jax():
    assert dataclasses.asdict(V.ViTConfig()) == dataclasses.asdict(JV.ViTConfig())
    assert dataclasses.asdict(Q.QFormerConfig()) == dataclasses.asdict(JQ.QFormerConfig())
    for t, j in ((B.BLIP2ITMConfig(), JB.BLIP2ITMConfig()),
                 (B.BLIP2ITMConfig.tiny(), JB.BLIP2ITMConfig.tiny())):
        assert t.vit == V.ViTConfig(**dataclasses.asdict(j.vit))
        assert t.qformer == Q.QFormerConfig(**dataclasses.asdict(j.qformer))
        assert t.embed_dim == j.embed_dim
        assert t.compute_dtype == torch.bfloat16 and j.compute_dtype == jnp.bfloat16
    assert V.ViTConfig().num_patches == 256


def test_f32_features_and_cosines_match_jax(pair):
    jitm, titm = pair
    imgs, ids, mask = _inputs()
    image_feats = jax.jit(partial(jitm.module.apply, method=JB.BLIP2ITMModule.image_feats))
    j_img = np.asarray(image_feats({"params": jitm.params}, jnp.asarray(imgs)))
    j_txt = np.asarray(jitm.encode_texts(jnp.asarray(ids), jnp.asarray(mask)))  # text_feats
    with torch.no_grad():
        t_img = titm.module.image_feats(torch.from_numpy(imgs))
        t_txt = titm.module.text_feats(torch.from_numpy(ids), torch.from_numpy(mask))
    assert t_img.shape == (3, 8, 16) and t_txt.shape == (3, 16)
    np.testing.assert_allclose(t_img.numpy(), j_img, atol=F32_ATOL)
    np.testing.assert_allclose(t_txt.numpy(), j_txt, atol=F32_ATOL)

    want = np.einsum("bqe,te->bqt", j_img, j_txt).max(axis=1)  # BLIP2ITMModule.__call__
    got = titm.cosine(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    feats = titm.encode_texts(torch.from_numpy(ids), torch.from_numpy(mask))
    cached = titm.cosine_cached_text(torch.from_numpy(imgs), feats)
    np.testing.assert_allclose(cached.numpy(), want, atol=F32_ATOL)


def test_bf16_serving_cosines_match_jax(pair):
    jitm, titm = pair
    imgs, ids, mask = _inputs()
    jcfg = dataclasses.replace(jitm.cfg, compute_dtype=jnp.bfloat16)
    j16 = JB.BLIP2ITM(jcfg, jax_cast_for_serving(jitm.params))
    want = np.asarray(j16.cosine(jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask)))

    tcfg = dataclasses.replace(titm.cfg, compute_dtype=torch.bfloat16)
    module = B.BLIP2ITMModule(tcfg)
    module.load_state_dict(titm.module.state_dict())
    t16 = B.BLIP2ITM(tcfg, cast_for_serving(module))
    got = t16.cosine(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)


def test_cast_for_serving_keeps_norms_f32_like_jax(pair):
    jitm, titm = pair
    j16 = jax.tree_util.tree_map(np.asarray, jax_cast_for_serving(jitm.params))
    want = {k: v.dtype for k, v in B.state_dict_from_jax_params(j16).items()}
    module = B.BLIP2ITMModule(titm.cfg)
    module.load_state_dict(titm.module.state_dict())
    got = {k: v.dtype for k, v in cast_for_serving(module).state_dict().items()}
    assert got == want
    assert got["vision.block0.ln1.ln.weight"] == torch.float32
    assert got["qformer.layer0.cross_ln.ln.bias"] == torch.float32
    assert got["vision.block0.attn.qkv.weight"] == torch.bfloat16
    assert got["query_tokens"] == torch.bfloat16
    for m in module.modules():
        if isinstance(m, FastLayerNorm):
            assert m.weight.dtype == m.bias.dtype == torch.float32


def test_from_jax_params_layouts_and_strictness(pair):
    jitm, titm = pair
    p = jitm.params
    sd = titm.module.state_dict()
    qkv = np.asarray(p["vision"]["block0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["vision.block0.attn.qkv.weight"].numpy(), qkv.T)
    conv = np.asarray(p["vision"]["patch_embed"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["vision.patch_embed.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    emb = np.asarray(p["text_embeddings"]["word"]["embedding"])
    np.testing.assert_array_equal(sd["text_embeddings.word.weight"].numpy(), emb)
    ln = np.asarray(p["qformer"]["layer1"]["ffn_text_ln"]["ln"]["scale"])
    np.testing.assert_array_equal(sd["qformer.layer1.ffn_text_ln.ln.weight"].numpy(), ln)
    params_np = jax.tree_util.tree_map(np.asarray, p)
    del params_np["vision_proj"]
    with pytest.raises(RuntimeError, match="vision_proj"):
        B.BLIP2ITM.from_jax_params(titm.cfg, params_np, device="cpu")


def _count_norm_calls(module, fn):
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1))
             for m in module.modules() if isinstance(m, FastLayerNorm)]
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


def _expected_norms(cfg):
    q = cfg.qformer
    cross = len(range(0, q.layers, q.cross_attention_freq))
    image = (2 * cfg.vit.depth + 1) + (1 + 2 * q.layers + cross)
    text = 1 + 2 * q.layers
    return image, text


def test_layer_norm_calls_per_entry_point(pair):
    """The counts chip_smoke.py expects of the LayerNorm kernel: 110 per
    image-scoring call and 25 per text encoding at full width."""
    assert _expected_norms(B.BLIP2ITMConfig()) == (110, 25)
    _, titm = pair
    imgs, ids, mask = _inputs()
    feats = titm.encode_texts(torch.from_numpy(ids), torch.from_numpy(mask))
    image, text = _expected_norms(titm.cfg)
    got_image = _count_norm_calls(
        titm.module, lambda: titm.cosine_cached_text(torch.from_numpy(imgs), feats))
    got_text = _count_norm_calls(
        titm.module, lambda: titm.encode_texts(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert (got_image, got_text) == (image, text)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("hw", [(48, 64), (7, 5)])
def test_resize_matches_jax(method, hw):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    got = R.resize_matmul(torch.from_numpy(x), 16, 20, method)
    want = JR.resize_matmul(jnp.asarray(x), 16, 20, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    d = x[..., 0]
    np.testing.assert_allclose(R.resize_bilinear_hw(torch.from_numpy(d), 16, 20).numpy(),
                               np.asarray(JR.resize_bilinear_hw(jnp.asarray(d), 16, 20)), atol=1e-6)


def test_preprocess_matches_jax(pair):
    jitm, titm = pair
    rgb = np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    got = titm.preprocess(torch.from_numpy(rgb))
    want = jitm.preprocess(jnp.asarray(rgb))
    assert got.shape == (2, 56, 56, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
