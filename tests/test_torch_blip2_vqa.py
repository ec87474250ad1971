"""vlfm_tpu_torch's BLIP-2 VQA bridge against vlfm_tpu's, on the CPU.

The tiny config's two trees (the visual prefix's, from ``jax.eval_shape``
of its init, and T5's) are seeded numpy, carried into the port with
``from_jax_params``. Held against JAX: the visual prefix (CLIP
normalisation, ViT, Q-Former's query branch, language projection) to 1e-4,
as tests/test_torch_blip2_itm.py holds the ITM image branch in f32;
``preprocess`` (cubic resize) to 1e-6; ``ask`` (prefix + greedy T5) token
for token. With ``compute_dtype`` bf16 and both trees under
``cast_for_serving``: the ViT and Q-Former run bf16, the projection takes
their f32 output, and the prefix is f32 in both packages, and they agree to 2 % of the prefix's
largest magnitude (bf16 products round in other orders on the two sides).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_full_stack import numpy_params
from tests.test_torch_t5_vqa import t5_params
from vlfm_tpu.models import blip2_vqa as JBV
from vlfm_tpu.models import t5_vqa as JT
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu_torch.models import blip2_vqa as BV
from vlfm_tpu_torch.models import qformer as Q
from vlfm_tpu_torch.models import t5_vqa as T
from vlfm_tpu_torch.models import vit as V
from vlfm_tpu_torch.models.precision import cast_for_serving

PREFIX_ATOL = 1e-4
RESIZE_ATOL = 1e-6
BF16_SHARE = 0.02  # of the largest |prefix| value


def prefix_params(cfg=JBV.BLIP2VQAConfig.tiny(), seed=0):
    s = cfg.vit.image_size
    return numpy_params(JBV.BLIP2VisualPrefixModule(cfg), jnp.zeros((1, s, s, 3)), seed=seed)


def bridges(jcfg=JBV.BLIP2VQAConfig.tiny(), tcfg=BV.BLIP2VQAConfig.tiny(), seed=0):
    """(JAX BLIP2VQA, port BLIP2VQA) with the same seeded weights."""
    pp, tp = prefix_params(jcfg, seed), t5_params(seed=seed)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jb = JBV.BLIP2VQA(jcfg, to_jax(pp), JT.T5VQA(jcfg.t5, to_jax(tp)))
    return jb, BV.BLIP2VQA.from_jax_params(tcfg, pp, tp, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return bridges()


def test_configs_match_jax():
    for t, j in ((BV.BLIP2VQAConfig.tiny(), JBV.BLIP2VQAConfig.tiny()),
                 (BV.BLIP2VQAConfig.production(), JBV.BLIP2VQAConfig.production())):
        assert t.vit == V.ViTConfig(**dataclasses.asdict(j.vit))
        assert t.qformer == Q.QFormerConfig(**dataclasses.asdict(j.qformer))
        assert t.t5 == T.T5Config(**dataclasses.asdict(j.t5))
    assert BV.BLIP2VQAConfig.production().compute_dtype == torch.bfloat16
    assert BV.BLIP2VQAConfig.tiny().compute_dtype == torch.float32 and JBV.BLIP2VQAConfig.tiny().compute_dtype == jnp.float32


def test_query_branch_only():
    """The bridge's Q-Former has no text branch, as the JAX tree has none:
    every parameter loads and none is left over."""
    names = [n for n, _ in BV.BLIP2VisualPrefixModule(BV.BLIP2VQAConfig.tiny(), device="meta").named_parameters()]
    assert not any("ffn_text" in n for n in names) and any("ffn_query" in n for n in names)
    assert {"query_tokens", "language_projection.weight"} <= set(names)


def test_prefix_and_preprocess_match_jax(pair):
    jb, tb = pair
    rng = np.random.default_rng(0)
    img01 = rng.random((3, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jb.image_prefix(jnp.asarray(img01)))
    got = tb.image_prefix(torch.from_numpy(img01))
    assert got.shape == want.shape == (3, 8, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PREFIX_ATOL, rtol=0)
    rgb = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(tb.preprocess(torch.from_numpy(rgb)).numpy(), np.asarray(jb.preprocess(jnp.asarray(rgb))),
                               atol=RESIZE_ATOL, rtol=0)


def test_ask_matches_jax(pair):
    jb, tb = pair
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (4, 48, 64, 3), dtype=np.uint8)
    ids = rng.integers(2, 99, (4, 8)).astype(np.int32)
    mask = np.ones((4, 8), bool)
    mask[:, 6:] = False
    want = np.asarray(jb.ask(jnp.asarray(rgb), jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=4))
    got = tb.ask(torch.from_numpy(rgb), torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_served_prefix_is_f32_and_matches_jax():
    jcfg = dataclasses.replace(JBV.BLIP2VQAConfig.tiny(), compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(BV.BLIP2VQAConfig.tiny(), compute_dtype=torch.bfloat16)
    jp = jax_cast_for_serving(jax.tree_util.tree_map(jnp.asarray, prefix_params(jcfg, seed=2)))
    assert jp["language_projection"]["kernel"].dtype == jnp.bfloat16
    tb = BV.BLIP2VQA.from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), t5_params(), device="cpu")
    cast_for_serving(tb.module)
    img01 = np.random.default_rng(3).random((2, 56, 56, 3)).astype(np.float32)
    run = jax.jit(partial(JBV.BLIP2VisualPrefixModule(jcfg).apply))
    want = np.asarray(run({"params": jp}, jnp.asarray(img01)))
    got = tb.image_prefix(torch.from_numpy(img01))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_SHARE * np.abs(want).max(), rtol=0)
