"""vlfm_tpu_torch's Swin backbone against vlfm_tpu's, on the CPU.

JAX initialises ``SwinConfig.tiny_test()`` (window 4, two stages); the port
loads the same tree through ``params.state_dict_from_jax_params``. Both run
f32 on the same numpy images: a square 64x64 input (no padding) and a
non-square 72x56 one, whose 18x14 and 9x7 stage maps are padded to the
window and whose shifted blocks take the cyclic-shift masks. Every stage's
features are held to 1e-4 absolute (LayerNormed features of order 1; the
two frameworks' f32 GEMMs and softmaxes sum in other orders). The host
helpers (position index, shift mask) are held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import swin as JS
from vlfm_tpu_torch.models import swin as S
from vlfm_tpu_torch.models.params import state_dict_from_jax_params

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cfg = JS.SwinConfig.tiny_test()
    params = jax.jit(JS.SwinBackbone(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    module = S.SwinBackbone(S.SwinConfig.tiny_test(), device="cpu")
    module.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return cfg, params, module.eval()


def test_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(S.SwinConfig()) == dataclasses.asdict(JS.SwinConfig())
    assert dataclasses.asdict(S.SwinConfig.tiny_test()) == dataclasses.asdict(JS.SwinConfig.tiny_test())


@pytest.mark.parametrize("w,shift", [(4, 2), (7, 3)])
def test_host_helpers_match_jax(w, shift):
    np.testing.assert_array_equal(S.relative_position_index(w), JS.relative_position_index(w))
    np.testing.assert_array_equal(S.shift_mask(4 * w, 2 * w, w, shift), JS._shift_mask(4 * w, 2 * w, w, shift))


@pytest.mark.parametrize("h,w", [(64, 64), (72, 56)])
def test_backbone_matches_jax(pair, h, w):
    cfg, params, module = pair
    imgs = np.random.default_rng(h + w).normal(size=(2, h, w, 3)).astype(np.float32)
    want = JS.SwinBackbone(cfg).apply({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        got = module(torch.from_numpy(imgs))
    assert len(got) == len(want) == 2
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL)


def test_window_partition_round_trip():
    x = torch.arange(2 * 8 * 12 * 3, dtype=torch.float32).reshape(2, 8, 12, 3)
    wins = S.window_partition(x, 4)
    assert wins.shape == (2 * 2 * 3, 16, 3)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(JS._window_partition(jnp.asarray(x.numpy()), 4)))
    assert torch.equal(S.window_reverse(wins, 4, 8, 12), x)
