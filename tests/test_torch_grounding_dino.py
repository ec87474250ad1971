"""vlfm_tpu_torch's GroundingDINO against vlfm_tpu's, on the CPU.

Both take the same numpy parameter tree of ``GroundingDinoJaxConfig.tiny_test()``
(Swin 16 wide, BERT 32 wide, d_model 32, two encoder and two decoder
layers, 10 queries, 16 tokens), drawn from a seed (``jax_params``; flax's
own init of this module takes 34 s eagerly); the port loads it with
``GroundingDinoDetector.from_jax_params``. The JAX pipeline cannot run a batch above 1 with a batch-1
caption, so parity is taken against JAX ``predict`` with the ids and mask
tiled to the image batch (B=2); the port takes the batch-1 caption and
broadcasts it.

Tolerances:
- f32: logits 2e-4 absolute (logits up to ~12; measured 2e-5 to 5e-5 over
  three image seeds) and boxes 1e-5 (measured 6e-7), with the same -inf (padded) logits on both sides;
- bf16 serving (``cast_for_serving`` on both sides): logits 0.1 and boxes
  2e-3 (measured 0.023-0.026 and 1.5e-4-2.5e-4). Both frameworks compute in f32 with the
  bf16-rounded weights (the f32 norm parameters promote every stream), but
  BERT's three bf16 embedding rows are summed in bf16, which XLA and PyTorch
  round at other places (one bf16 ulp of the embedding, 4e-3 here), and
  BERT carries that through. ``jax.nn.softmax`` on bf16 would compute in
  bf16 where ``torch.softmax`` rounds once from f32; no softmax here sees a
  bf16 input, so that costs nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import grounding_dino as JG
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu_torch.models import grounding_dino as G
from vlfm_tpu_torch.models.layers import GroupNorm
from vlfm_tpu_torch.models.params import state_dict_from_jax_params
from vlfm_tpu_torch.models.precision import cast_for_serving

F32_LOGIT_ATOL = 2e-4
F32_BOX_ATOL = 1e-5
BF16_LOGIT_ATOL = 0.1
BF16_BOX_ATOL = 2e-3


def jax_params(cfg, seed=0):
    """A JAX GroundingDINO parameter tree of numpy leaves drawn from a seed:
    the tree's structure from ``jax.eval_shape`` of the module's init (no
    compile), dense and conv kernels N(0, 1/fan_in), norm scales 1 +-0.1,
    biases and bias tables 0.02-scale, embeddings and the level and query
    embeddings as flax initialises them, fusion layer scales 0.1-scale (so
    the fusion is seen)."""
    s = cfg.swin.patch_size * 16
    ids = np.array([[101, 5, 5, 5, 5, 102]])
    m3, pos = JG.text_phrase_masks(ids)
    shapes = jax.eval_shape(JG.GroundingDinoModule(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                            jnp.asarray(ids, jnp.int32), jnp.asarray(m3), jnp.asarray(pos, jnp.int32),
                            jnp.zeros((1, 6), bool))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        n = rng.normal(size=x.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "scale":
            n = 1 + 0.1 * n
        elif name == "embedding":
            n = n / np.sqrt(x.shape[-1])
        elif name in ("vision_param", "text_param"):
            n = 0.1 * n
        elif name not in ("level_embed", "query_position_embeddings"):
            n = 0.02 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    params = jax_params(JG.GroundingDinoJaxConfig.tiny_test())
    jdet = JG.GroundingDinoDetector(JG.GroundingDinoJaxConfig.tiny_test(), jax.tree_util.tree_map(jnp.asarray, params))
    tdet = G.GroundingDinoDetector.from_jax_params(G.GroundingDinoConfig.tiny_test(), params, device="cpu")
    return jdet, tdet


def caption():
    ids, mask, spans = G.build_caption_ids([np.array([5, 6]), np.array([7, 8, 9])], 16)
    return ids, mask


def images(b=2, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 64, 64, 3)).astype(np.float32)


def _assert_detections_close(got, want, logit_atol, box_atol):
    (gl, gb), (wl, wb) = got, want
    wl, wb = np.asarray(wl, np.float32), np.asarray(wb, np.float32)
    gl, gb = gl.float().numpy(), gb.float().numpy()
    assert gl.shape == wl.shape and gb.shape == wb.shape
    finite = np.isfinite(wl)
    np.testing.assert_array_equal(np.isfinite(gl), finite)
    np.testing.assert_array_equal(gl[~finite], wl[~finite])
    np.testing.assert_allclose(gl[finite], wl[finite], atol=logit_atol)
    np.testing.assert_allclose(gb, wb, atol=box_atol)


def test_configs_match_jax():
    for port, ref in ((G.GroundingDinoConfig(), JG.GroundingDinoJaxConfig()),
                      (G.GroundingDinoConfig.tiny_test(), JG.GroundingDinoJaxConfig.tiny_test())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert G.SPECIAL_TOKEN_IDS == JG.SPECIAL_TOKEN_IDS
    assert (G.IMAGENET_MEAN, G.IMAGENET_STD) == (JG.IMAGENET_MEAN, JG.IMAGENET_STD)


@pytest.mark.parametrize("ids", [
    [[101, 5, 6, 1012, 8, 102]],
    [[101, 5, 1012, 6, 7, 1029, 8, 102, 0, 0], [101, 9, 9, 9, 1012, 3, 102, 0, 0, 0]],
    [[5, 6, 7, 8]],  # no special token
    [[101, 102, 101, 102]],
])
def test_text_phrase_masks_match_jax(ids):
    got, want = G.text_phrase_masks(np.array(ids)), JG.text_phrase_masks(np.array(ids))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("toks,max_len", [
    ([np.array([5, 6]), np.array([7])], 16),
    ([np.array([5, 6, 7, 8, 9])], 4),  # cut at max_len
    ([np.array([11]), np.array([12, 13]), np.array([14])], 256),
])
def test_build_caption_ids_matches_jax(toks, max_len):
    got, want = G.build_caption_ids(toks, max_len), JG.build_caption_ids(toks, max_len)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[2] == want[2]


def test_sine_embeddings_match_jax():
    np.testing.assert_allclose(G.sine_position_2d(7, 5, 32, 20.0).numpy(),
                               np.asarray(JG.sine_position_2d(7, 5, 32, 20.0)), atol=1e-6)
    pos = np.random.default_rng(0).uniform(0, 1, (2, 9, 4)).astype(np.float32)
    for exchange in (True, False):
        np.testing.assert_allclose(G.get_sine_pos_embed(torch.from_numpy(pos), 16, exchange).numpy(),
                                   np.asarray(JG.get_sine_pos_embed(jnp.asarray(pos), 16, exchange)), atol=2e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_group_norm_matches_flax(dtype):
    import flax.linen as nn

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 6, 64)) * 3 + 1).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    gn = nn.GroupNorm(num_groups=32)
    params = gn.init(jax.random.PRNGKey(0), jx)["params"]
    params = {"scale": jnp.asarray(rng.normal(size=64), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=64), jnp.bfloat16)}
    want = gn.apply({"params": params}, jx)
    mod = GroupNorm(32, 64, device="cpu")
    mod.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    with torch.no_grad():
        got = mod(tx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bert_matches_jax(pair):
    jdet, tdet = pair
    ids = np.array([[101, 5, 6, 1012, 7, 8, 1012, 102, 0, 0]] * 2)
    ids[1, 2] = 40
    m3, pos = JG.text_phrase_masks(ids)
    want = JG.BertBackbone(jdet.cfg.text).apply({"params": jdet.params["bert"]}, jnp.asarray(ids),
                                                jnp.asarray(m3), jnp.asarray(pos))
    with torch.no_grad():
        got = tdet.module.bert(torch.from_numpy(ids), torch.from_numpy(m3), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_tiny_model_f32_matches_jax(pair):
    jdet, tdet = pair
    ids, mask = caption()
    imgs = images()
    want = jdet.predict(jnp.asarray(imgs), np.tile(ids, (2, 1)), np.tile(mask, (2, 1)))
    got = tdet.predict(torch.from_numpy(imgs), ids, mask)  # the caption at batch 1, broadcast
    _assert_detections_close(got, want, F32_LOGIT_ATOL, F32_BOX_ATOL)
    assert np.isfinite(np.asarray(want[0])).any() and not np.isfinite(np.asarray(want[0])).all()
    tiled = tdet.predict(torch.from_numpy(imgs), np.tile(ids, (2, 1)), np.tile(mask, (2, 1)))
    assert all(torch.equal(a, b) for a, b in zip(tiled, got))


def test_tiny_model_bf16_serving_matches_jax(pair):
    jdet, tdet = pair
    ids, mask = caption()
    imgs = images()
    j16 = JG.GroundingDinoDetector(jdet.cfg, jax_cast_for_serving(jdet.params))
    want = j16.predict(jnp.asarray(imgs), np.tile(ids, (2, 1)), np.tile(mask, (2, 1)))
    module = G.GroundingDinoModule(tdet.cfg, device="cpu")
    module.load_state_dict(tdet.module.state_dict())
    t16 = G.GroundingDinoDetector(tdet.cfg, cast_for_serving(module))
    got = t16.predict(torch.from_numpy(imgs), ids, mask)
    assert got[0].dtype == torch.float32 and want[0].dtype == jnp.float32  # the norms promote to f32
    _assert_detections_close(got, want, BF16_LOGIT_ATOL, BF16_BOX_ATOL)


def test_cast_for_serving_dtypes_match_jax(pair):
    jdet, tdet = pair
    j16 = jax.tree_util.tree_map(np.asarray, jax_cast_for_serving(jdet.params))
    want = {k: v.dtype for k, v in state_dict_from_jax_params(j16).items()}
    module = G.GroundingDinoModule(tdet.cfg, device="cpu")
    module.load_state_dict(tdet.module.state_dict())
    got = {k: v.dtype for k, v in cast_for_serving(module).state_dict().items()}
    assert got == want
    # GroupNorm keeps its scale f32 and, its scope not reading as a norm, has its bias cast.
    assert got["input_proj0_gn.weight"] == torch.float32 and got["input_proj0_gn.bias"] == torch.bfloat16
    assert got["swin.s0_b0.attn.rel_bias_table"] == got["level_embed"] == torch.bfloat16
    assert got["enc0.fusion.vision_param"] == got["query_position_embeddings"] == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_indices_match_lax_top_k_with_ties(dtype):
    rng = np.random.default_rng(2)
    scores = rng.choice(np.array([-np.inf, -1.0, 0.0, 0.5, 2.0], np.float32), (3, 40))
    scores[1] = 0.25  # every score tied
    want = jax.lax.top_k(jnp.asarray(scores).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), 17)[1]
    got = G.top_k_indices(torch.from_numpy(scores).to(dtype), 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_deformable_gather_per_deformable_attention(pair, monkeypatch):
    """K4 runs once per deformable attention: encoder plus decoder layers
    (12 per forward at full width, 4 in the tiny config)."""
    _, tdet = pair
    calls = []
    real = G.deform_gather
    monkeypatch.setattr(G, "deform_gather", lambda *a: calls.append(a[0].shape) or real(*a))
    ids, mask = caption()
    tdet.predict(torch.from_numpy(images(b=3)), ids, mask)
    assert len(calls) == G.deformable_attentions(tdet.cfg) == 4
    assert G.deformable_attentions(G.GroundingDinoConfig()) == 12
