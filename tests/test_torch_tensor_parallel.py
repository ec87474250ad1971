"""vlfm_tpu_torch's tensor parallelism over a model axis above 1, on the CPU.

``SplitDense`` against ``Dense`` at model axes 2 and 4. Tiny BLIP2-ITM on
``make_mesh(devices=["cpu"] * 4, model_parallel=2)``: every split kernel's
shards equal JAX's ``shard_params_tp`` shards on ``make_mesh(4,
model_parallel=2)`` (conftest's host devices) leaf for leaf, and the tp x
dp tier of ``__graft_entry__.py`` (a linspace image batch split over the
data rows, scored with the split parameters) holds the port's split result
to JAX's jit on its TP-placed parameters and to the port's unsplit model.
JAX splits every leaf with two or more axes whose last axis divides; the
port splits the ``Dense`` kernels alone (``JAX_ONLY`` names the other five
leaves, which it keeps whole). Tiny OWL-ViT split the same way equals the
unsplit detector; a tensor tree at a model axis above 1 raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.parallel import mesh as JM
from vlfm_tpu_torch.models import blip2_itm as B
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models.layers import Dense
from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu_torch.parallel import mesh as M
from vlfm_tpu_torch.parallel.engine import PerceptionEngine

F32_ATOL = 1e-4  # the port against JAX in f32 compute (tests/test_torch_blip2_itm.py)
SPLIT_ATOL = 1e-6  # split against unsplit, the port on both sides, f32
CPU = torch.device("cpu")
MESH = M.make_mesh(devices=[CPU] * 4, model_parallel=2)
N_SPLIT = 30  # tiny ITM's Dense kernels: ViT 2 x 4, Q-Former 2 x 8 + 4 (cross), the two projections
# The leaves JAX's shard_params_tp splits and the port keeps whole: JAX name -> the port's.
JAX_ONLY = {
    "query_tokens": "query_tokens",
    "text_embeddings/position": "text_embeddings.position",
    "text_embeddings/word/embedding": "text_embeddings.word.weight",
    "vision/patch_embed/kernel": "vision.patch_embed.weight",
    "vision/position_embedding": "vision.position_embedding",
}


def _dense(k_in, k_out, bias, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    d = Dense(k_in, k_out, bias=bias)
    with torch.no_grad():
        d.weight.copy_(torch.randn(k_out, k_in, generator=gen))
        if bias:
            d.bias.copy_(torch.randn(k_out, generator=gen))
    return d.to(dtype).requires_grad_(False)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("w_dtype,x_dtype,bias", [
    (torch.float32, torch.float32, True),
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, True),  # promotion: an f32 activation against bf16 weights computes in f32
])
def test_split_dense_equals_dense(k, w_dtype, x_dtype, bias):
    whole = _dense(24, 16, bias, w_dtype, seed=k)
    devices = [CPU] * k
    split = M.SplitDense(whole, devices)
    assert not hasattr(split, "weight") and len(split.weights) == k
    assert all(w.shape == (16 // k, 24) and w.dtype == w_dtype for w in split.weights)
    assert (split.biases is None) == (not bias)
    x = torch.randn(3, 5, 24, generator=torch.Generator().manual_seed(1)).to(x_dtype)
    got, want = split(x), whole(x)
    assert got.dtype == want.dtype == torch.promote_types(x_dtype, w_dtype) and got.shape == (3, 5, 16)
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=SPLIT_ATOL, rtol=0)
    else:  # one bf16 rounding of the same f32 sum
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=2**-8)


@pytest.mark.parametrize("k,out", [(2, 5), (4, 6)])
def test_split_dense_keeps_an_output_that_does_not_divide_whole(k, out):
    net = torch.nn.Sequential(_dense(8, out, True, torch.float32, 0), torch.nn.Linear(out, 4))
    row = M.shard_params_tp(net, M.make_mesh(devices=[CPU] * 2 * k, model_parallel=k))[0]
    assert type(row[0]) is Dense and type(row[1]) is torch.nn.Linear
    with pytest.raises(ValueError, match="do not split"):
        M.SplitDense(net[0], [CPU] * k)


def test_shard_params_tp_refuses_a_tensor_tree_above_one():
    with pytest.raises(TypeError, match="takes an nn.Module"):
        M.shard_params_tp({"w": torch.ones(3, 2)}, MESH)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny BLIP2-ITM parameters (those of ``BLIP2ITM.init_random(
    tiny, seed=0)``, drawn under jit) and the port's model loaded from
    them, both computing in f32."""
    jcfg = dataclasses.replace(JB.BLIP2ITMConfig.tiny(), compute_dtype=jnp.float32)
    s = jcfg.vit.image_size
    params = jax.jit(JB.BLIP2ITMModule(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                                                  jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool))["params"]
    tcfg = dataclasses.replace(B.BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    titm = B.BLIP2ITM.from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, titm


def _flat(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_dense_shards_equal_jax_shard_params_tp(tiny):
    _, params, _, titm = tiny
    jmesh = JM.make_mesh(4, model_parallel=2)
    jleaves = _flat(JM.shard_params_tp(params, jmesh))
    jax_split = {n for n, a in jleaves.items() if a.ndim >= 2 and a.shape[-1] % 2 == 0}
    rows = M.shard_params_tp(titm.module, MESH)
    whole = titm.module.state_dict()
    for r, row in enumerate(rows):
        assert not any(type(m) is Dense for m in row.modules())  # every tiny Dense divides by 2
        splits = {n: m for n, m in row.named_modules() if isinstance(m, M.SplitDense)}
        port_split = {n.replace(".", "/") + "/kernel" for n in splits}
        assert len(port_split) == N_SPLIT and port_split <= jax_split
        assert jax_split - port_split == set(JAX_ONLY)
        own = row.state_dict()
        for jname, tname in JAX_ONLY.items():
            assert torch.equal(own[tname], whole[tname]), tname
        for name, m in splits.items():
            kernel = {s.device: s for s in jleaves[name.replace(".", "/") + "/kernel"].addressable_shards}
            bias = {s.device: s for s in jleaves[name.replace(".", "/") + "/bias"].addressable_shards}
            for c in range(2):
                shard = kernel[jmesh.devices[r, c]]
                assert m.weights[c].device == MESH.devices[r][c]
                np.testing.assert_array_equal(m.weights[c].numpy().T, np.asarray(shard.data))
                # JAX replicates a bias; the port holds its column's slice of it.
                np.testing.assert_array_equal(m.biases[c].numpy(),
                                              np.asarray(bias[jmesh.devices[r, c]].data)[shard.index[-1]])


def _tier_inputs(jcfg, batch=4):
    s = jcfg.vit.image_size
    imgs = np.broadcast_to(np.linspace(0.0, 1.0, batch, dtype=np.float32)[:, None, None, None],
                           (batch, s, s, 3)).copy()
    return imgs, np.zeros((2, 8), np.int32), np.ones((2, 8), bool)


def test_tp_dp_tier_matches_jax_and_the_unsplit_port(tiny):
    jcfg, params, tcfg, titm = tiny
    imgs, ids, am = _tier_inputs(jcfg)
    jmesh = JM.make_mesh(4, model_parallel=2)
    module = JB.BLIP2ITMModule(jcfg)
    score = jax.jit(lambda p, im, i, a: module.apply({"params": p}, im, i, a))
    want_jax = np.asarray(score(JM.shard_params_tp(params, jmesh),
                                jax.device_put(imgs, JM.episode_sharding(jmesh)),
                                jax.device_put(ids, JM.replicated(jmesh)), jax.device_put(am, JM.replicated(jmesh))))
    rows = M.shard_params_tp(titm.module, MESH)
    blocks = M.shard_episode_batch(torch.from_numpy(imgs), MESH)
    got = torch.cat([B.BLIP2ITM(tcfg, row).cosine(blk, torch.from_numpy(ids).to(d), torch.from_numpy(am).to(d))
                     for row, blk, d in zip(rows, blocks, MESH.data_devices())])
    want = titm.cosine(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(am))
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=F32_ATOL)
    torch.testing.assert_close(got, want, atol=SPLIT_ATOL, rtol=0)


def test_engine_scores_a_split_itm(tiny):
    """``PerceptionEngine`` over ``BLIP2ITM(cfg, split_module)`` scores with
    its unchanged API, one engine per data row on the row's block."""
    _, _, tcfg, titm = tiny
    rgb = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 40, 48, 3), np.uint8))
    tok = WordPieceTokenizer(toy_vocab(), max_len=16)
    prompt = "a target_object|seems like there is a target_object ahead"
    want = PerceptionEngine(titm, tok, prompt).score(rgb, "chair")
    rows = M.shard_params_tp(titm.module, MESH)
    engines = [PerceptionEngine(B.BLIP2ITM(tcfg, row), tok, prompt) for row in rows]
    assert all(e.itm.device == d for e, d in zip(engines, MESH.data_devices()))
    got = torch.cat([e.score(blk, "chair") for e, blk in zip(engines, M.shard_episode_batch(rgb, MESH))])
    assert got.shape == (4, 2)
    torch.testing.assert_close(got, want, atol=SPLIT_ATOL, rtol=0)


def test_tiny_owl_vit_split_equals_unsplit():
    det = O.OwlViTDetector.init_random(O.OwlViTDetConfig.tiny(), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, 98, (3, 8)).astype(np.int32))
    ids[:, -1] = 99  # the EOT (max) id
    mask = torch.ones_like(ids, dtype=torch.bool)
    with torch.no_grad():
        want_boxes, want_logits = det.detect(imgs, ids, mask)
        rows = M.shard_params_tp(det.module, MESH)
        n_split = [sum(isinstance(m, M.SplitDense) for m in row.modules()) for row in rows]
        outs = [O.OwlViTDetector(det.cfg, row).detect(blk, ids, mask)
                for row, blk in zip(rows, M.shard_episode_batch(imgs, MESH))]
    # Every Dense but the two (dim, 1) logit heads: 2 x 2 encoders x 6, the box head's 3,
    # text_projection and class_dense.
    assert n_split == [29, 29]
    assert all(type(getattr(row, n)) is Dense for row in rows for n in ("logit_shift", "logit_scale"))
    torch.testing.assert_close(torch.cat([b for b, _ in outs]), want_boxes, atol=SPLIT_ATOL, rtol=0)
    torch.testing.assert_close(torch.cat([lg for _, lg in outs]), want_logits, atol=SPLIT_ATOL, rtol=0)
