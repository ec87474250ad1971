"""vlfm_tpu_torch's TinyViT (MobileSAM's encoder) against vlfm_tpu's, on
the CPU.

JAX initialises ``TinyViTConfig.tiny()``; ``state_dict_from_jax_params``
loads the same weights into the port. Against the flax ``TinyViT`` (exact
GELU, f32) the port is held to 1e-4; against ``encode_fused`` (the JAX
serving path, Pallas in interpret mode, ``gelu_poly``) to 3e-3, the
tolerance of ``tests/test_tinyvit_fast.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import tinyvit as JT
from vlfm_tpu.models.tinyvit_fast import encode_fused
from vlfm_tpu_torch.models import tinyvit as T
from vlfm_tpu_torch.models.params import state_dict_from_jax_params

F32_ATOL = 1e-4
FUSED_ATOL = 3e-3


@pytest.fixture(scope="module")
def pair():
    cfg = JT.TinyViTConfig.tiny()
    x = np.random.default_rng(0).uniform(-1, 1, (2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    params = jax.jit(JT.TinyViT(cfg).init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    port = T.TinyViT(T.TinyViTConfig.tiny())
    port.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, params, port.eval(), x


def test_configs_match_jax():
    for port, ref in ((T.TinyViTConfig(), JT.TinyViTConfig()),
                      (T.TinyViTConfig.tiny(), JT.TinyViTConfig.tiny())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert T.chain_launches(T.TinyViTConfig()) == 3


def test_tiny_matches_flax_and_encode_fused(pair):
    cfg, params, port, x = pair
    want = np.asarray(JT.TinyViT(cfg).apply({"params": params}, jnp.asarray(x)))
    fused = np.asarray(encode_fused(params, jnp.asarray(x), cfg, interpret=True))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, cfg.img_size // 16, cfg.img_size // 16, cfg.out_channels)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_ATOL)
    np.testing.assert_allclose(got, fused, atol=FUSED_ATOL, rtol=FUSED_ATOL)


def test_stride1_chains_go_through_mbconv_chain(pair, monkeypatch):
    """The stage-0 MBConvs and the merge into the last stage call
    ``ops.conv_fused.mbconv_chain`` (K2 on CUDA tensors); the stride-2
    merges do not."""
    _, _, port, x = pair
    calls = []
    real = T.mbconv_chain

    def counting(x, *w, **kw):
        calls.append((tuple(x.shape), w[0].shape[1], w[4].shape[1], kw.get("residual", False)))
        return real(x, *w, **kw)

    monkeypatch.setattr(T, "mbconv_chain", counting)
    with torch.no_grad():
        port(torch.from_numpy(x))
    assert len(calls) == T.chain_launches(port.cfg) == 2
    assert calls == [((2, 16, 16, 8), 32, 8, True), ((2, 4, 4, 16), 20, 20, False)]


def test_from_jax_params_layouts(pair):
    _, params, port, _ = pair
    sd = port.state_dict()
    dw = np.asarray(params["stage0_block0"]["conv2"]["conv"]["kernel"])  # (3, 3, 1, Ch)
    np.testing.assert_array_equal(sd["stage0_block0.conv2.conv.weight"].numpy(), dw.transpose(3, 2, 0, 1))
    assert sd["stage0_block0.conv2.conv.weight"].shape == (32, 1, 3, 3)
    qkv = np.asarray(params["stage1_block0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["stage1_block0.attn.qkv.weight"].numpy(), qkv.T)
    ln = np.asarray(params["neck_ln1"]["scale"])
    np.testing.assert_array_equal(sd["neck_ln1.weight"].numpy(), ln)
