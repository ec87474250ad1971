"""vlfm_tpu_torch's flan-T5 against vlfm_tpu's, on the CPU.

The tiny T5 gets seeded numpy weights in JAX's tree (``jax.eval_shape`` of
the init), carried into the port with ``from_jax_params``; the relative
bias tables are drawn at N(0, 1), as the init draws them. Held against JAX:
the bucket table exactly (eager and under ``jit``, both directions, up to
300 tokens); the encoder's output and the decoder's logits to 1e-5 with and
without a visual prefix and with padded masks (f32); greedy tokens exactly;
and, with both trees under ``cast_for_serving``, the served dtypes (bf16
weights, f32 norm scales, an f32 stream and f32 logits) and the logits to
1e-4.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_full_stack import numpy_params
from vlfm_tpu.models import t5_vqa as JT
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu_torch.models import t5_vqa as T
from vlfm_tpu_torch.models.precision import cast_for_serving

F32_ATOL = 1e-5
SERVED_ATOL = 1e-4


def t5_params(cfg=JT.T5Config.tiny(), seed=0):
    """A seeded numpy tree for JAX's ``T5Module``, bias tables N(0, 1)."""
    ids, mask = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool)
    p = numpy_params(JT.T5Module(cfg), ids, mask, jnp.zeros((1, 2), jnp.int32), seed=seed)
    for stack in ("enc0", "dec0"):
        p[stack]["self_attn"]["rel_bias"] = p[stack]["self_attn"]["rel_bias"] * 50.0
    return p


@pytest.fixture(scope="module")
def pair():
    p = t5_params()
    return JT.T5VQA(JT.T5Config.tiny(), jax.tree_util.tree_map(jnp.asarray, p)), \
        T.T5VQA.from_jax_params(T.T5Config.tiny(), p, device="cpu")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 99, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), bool)
    mask[1, 5:] = False  # padded
    mask[2, 3:] = False
    prefix = rng.normal(size=(3, 4, 32)).astype(np.float32)
    dec = np.concatenate([np.zeros((3, 1), np.int32), rng.integers(2, 99, (3, 3)).astype(np.int32)], axis=1)
    return ids, mask, prefix, dec


@partial(jax.jit, static_argnums=0)
def _jax_apply(module, params, ids, mask, prefix, dec):
    enc, m = module.apply({"params": params}, ids, mask, prefix, method=JT.T5Module.encode)
    return enc, m, module.apply({"params": params}, dec, enc, m, method=JT.T5Module.decode_logits)


def _jax_forward(jt, ids, mask, prefix, dec, params=None):
    """JAX's encoder output, its mask and the decoder's logits, under jit
    (flax's eager apply dispatches op by op)."""
    return _jax_apply(jt.module, jt.params if params is None else params, jnp.asarray(ids), jnp.asarray(mask),
                      None if prefix is None else jnp.asarray(prefix), jnp.asarray(dec))


def test_configs_match_jax():
    for t, j in ((T.T5Config(), JT.T5Config()), (T.T5Config.tiny(), JT.T5Config.tiny()),
                 (T.T5Config.flan_xl(), JT.T5Config.flan_xl())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_bucket_table_matches_jax_exactly(bidirectional):
    n = 300
    rel = jnp.arange(n)[None, :] - jnp.arange(n)[:, None]
    fn = lambda r: JT.relative_position_bucket(r, bidirectional, 32, 128)  # noqa: E731
    got = T.bucket_table(n, n, bidirectional, 32, 128, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(fn(rel)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(fn)(rel)))
    # a decoder step's query rows against every key (lq < lk)
    np.testing.assert_array_equal(T.bucket_table(5, 40, bidirectional, 32, 128, torch.device("cpu")).numpy(),
                                  np.asarray(fn(jnp.arange(40)[None, :] - jnp.arange(5)[:, None])))
    assert got.min() >= 0 and got.max() < 32


@pytest.mark.parametrize("with_prefix", [False, True], ids=["text", "prefix"])
def test_encoder_and_logits_match_jax(pair, with_prefix):
    jt, tt = pair
    ids, mask, prefix, dec = _inputs()
    jenc, jm, jlogits = _jax_forward(jt, ids, mask, prefix if with_prefix else None, dec)
    with torch.no_grad():
        tenc, tm = tt.module.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                                    torch.from_numpy(prefix) if with_prefix else None)
        tlogits = tt.module.decode_logits(torch.from_numpy(dec).long(), tenc, tm)
    assert tenc.shape == ((3, 11, 32) if with_prefix else (3, 7, 32))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("with_prefix", [False, True], ids=["text", "prefix"])
def test_greedy_tokens_match_jax(pair, with_prefix):
    jt, tt = pair
    ids, mask, prefix, _ = _inputs(1)
    want = np.asarray(jt.generate(jnp.asarray(ids), jnp.asarray(mask), 5,
                                  jnp.asarray(prefix) if with_prefix else None))
    got = tt.generate(torch.from_numpy(ids), torch.from_numpy(mask), 5,
                      torch.from_numpy(prefix) if with_prefix else None)
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 0].tolist())) > 1, "the lanes' answers should differ for the test to bind"


def test_answer_starts_with_yes():
    gen = torch.tensor([[7, 2, 1], [3, 2, 1]])
    assert T.T5VQA.answer_starts_with_yes(gen, yes_token_id=7).tolist() == [True, False]


def test_served_dtypes_and_logits_match_jax():
    """Under ``cast_for_serving`` JAX keeps the RMSNorm scales f32, so the
    bf16 embeddings are lifted to f32 by the first norm and every matmul
    after it is f32 with bf16 weights; the port does the same."""
    p = t5_params(seed=1)
    jp = jax_cast_for_serving(jax.tree_util.tree_map(jnp.asarray, p))
    assert jp["enc_final"]["scale"].dtype == jnp.float32 and jp["enc0"]["ln_self"]["scale"].dtype == jnp.float32
    assert jp["enc0"]["ffn"]["wi_0"]["kernel"].dtype == jnp.bfloat16
    jt = JT.T5VQA(JT.T5Config.tiny(), jp)
    tt = T.T5VQA.from_jax_params(T.T5Config.tiny(), jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    cast_for_serving(tt.module)
    assert tt.module.enc_final.weight.dtype == torch.float32 and tt.module.enc0.ln_self.weight.dtype == torch.float32
    assert tt.module.enc0.ffn.wi_0.weight.dtype == torch.bfloat16 and tt.module.embed.weight.dtype == torch.bfloat16
    ids, mask, prefix, dec = _inputs(2)
    jenc, _, jlogits = _jax_forward(jt, ids, mask, prefix, dec)
    with torch.no_grad():
        tenc, tm = tt.module.encode(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(prefix))
        tlogits = tt.module.decode_logits(torch.from_numpy(dec).long(), tenc, tm)
        tenc_text, _ = tt.module.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    assert jenc.dtype == jnp.float32 and jlogits.dtype == jnp.float32
    assert tenc.dtype == tenc_text.dtype == tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=SERVED_ATOL, rtol=0)
