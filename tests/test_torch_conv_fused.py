"""vlfm_tpu_torch's MBConv chain (K2's plain version) and TinyViT's conv
stages against vlfm_tpu's, on the CPU.

The same seeded numpy inputs and weights go to both sides. Against the
Pallas kernel (interpret mode) and the space-to-depth rewrites, the
tolerance is ``tests/test_conv_fused.py``'s (atol 2e-3, rtol 1e-3), which
covers their ``gelu_poly`` (|err| <= 1.3e-4) against the port's exact erf
GELU. Against the flax modules, which use exact GELU too, f32 is held to
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import tinyvit as JT
from vlfm_tpu.ops import conv_fused as JC
from vlfm_tpu_torch.models import tinyvit as T
from vlfm_tpu_torch.models.params import state_dict_from_jax_params
from vlfm_tpu_torch.ops.conv_fused import chain_plan, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.utils.profiling import counters, reset_counters

PALLAS_ATOL, PALLAS_RTOL = 2e-3, 1e-3
FLAX_ATOL = 1e-5


def _chain_np(seed, shape, ch, cout):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    f = np.float32
    return (
        rng.standard_normal(shape).astype(f),
        (0.3 * rng.standard_normal((cin, ch))).astype(f), (0.3 * rng.standard_normal(ch)).astype(f),
        (0.3 * rng.standard_normal((3, 3, ch))).astype(f), (0.3 * rng.standard_normal(ch)).astype(f),
        (0.3 * rng.standard_normal((ch, cout))).astype(f), (0.3 * rng.standard_normal(cout)).astype(f),
    )


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape,ch,cout,residual,row_tile", [
    ((2, 7, 9, 8), 16, 8, True, 4),     # MBConv form; 4 does not divide 7
    ((1, 5, 11, 8), 16, 16, False, 4),  # stride-1 PatchMerging form, Cin != Cout
    ((2, 6, 16, 8), 16, 8, True, 4),    # the Pallas test's tiling
])
def test_chain_ref_matches_pallas_kernel(shape, ch, cout, residual, row_tile):
    x, *w = _chain_np(0, shape, ch, cout)
    want = JC.mbconv_chain(jnp.asarray(x), *map(jnp.asarray, w), residual=residual,
                           final_gelu=residual, row_tile=row_tile, interpret=True)
    got = mbconv_chain_ref(*_torch([x, *w]), residual=residual, final_gelu=residual)
    assert got.shape == (*shape[:3], cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PALLAS_ATOL, rtol=PALLAS_RTOL)
    # On a CPU tensor the wrapper is the plain version, and counts no launch.
    reset_counters()
    np.testing.assert_array_equal(
        mbconv_chain(*_torch([x, *w]), residual=residual, final_gelu=residual).numpy(), got.numpy())
    assert counters().get("K2.launches", 0) == 0


def test_chain_ref_rounds_like_the_kernel_in_bf16():
    """bf16 inputs: h and d are rounded to bf16 after their GELU, the output
    once. Held against the Pallas kernel in bf16 to 2 bf16 ulps of scale."""
    x, *w = _chain_np(1, (1, 8, 8, 16), 32, 16)
    bf = jnp.bfloat16
    jw = [jnp.asarray(a).astype(bf) if a.ndim > 1 else jnp.asarray(a) for a in w]
    want = JC.mbconv_chain(jnp.asarray(x).astype(bf), *jw, residual=True, final_gelu=True,
                           row_tile=4, interpret=True)
    tw = [t.bfloat16() if t.ndim > 1 else t for t in _torch(w)]
    got = mbconv_chain_ref(torch.from_numpy(x).bfloat16(), *tw, residual=True, final_gelu=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * 2**-8 * np.abs(want).max())


def _flax_tree_to_port(module, params):
    module.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return module


@pytest.mark.parametrize("hw", [(7, 9), (8, 8)])
def test_mbconv_matches_flax(hw):
    x = np.random.default_rng(2).standard_normal((2, *hw, 8)).astype(np.float32)
    jm = JT.MBConv(8, 4.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = _flax_tree_to_port(T.MBConv(8, 4.0), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLAX_ATOL, rtol=FLAX_ATOL)


@pytest.mark.parametrize("stride,hw", [(1, (5, 11)), (2, (8, 12)), (2, (7, 9))])
def test_patch_merging_matches_flax(stride, hw):
    x = np.random.default_rng(3).standard_normal((2, *hw, 8)).astype(np.float32)
    jm = JT.PatchMerging(12, stride)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = _flax_tree_to_port(T.PatchMerging(8, 12, stride), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLAX_ATOL, rtol=FLAX_ATOL)


def test_stride2_merge_matches_merge_chain_s2():
    x, *w = _chain_np(4, (2, 8, 12, 8), 12, 12)
    want = JC.merge_chain_s2(jnp.asarray(x), *map(jnp.asarray, w))
    port = T.PatchMerging(8, 12, 2)
    sd = {"conv1.conv.weight": w[0].T[:, :, None, None], "conv1.conv.bias": w[1],
          "conv2.conv.weight": w[2].transpose(2, 0, 1)[:, None], "conv2.conv.bias": w[3],
          "conv3.conv.weight": w[4].T[:, :, None, None], "conv3.conv.bias": w[5]}
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 4, 6, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


@pytest.mark.parametrize("hw", [(16, 16), (32, 16)])
def test_patch_embed_matches_flax_and_s2d(hw):
    """The port's patch embed: gelu(strided conv) -> strided conv."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    w1 = (0.3 * rng.standard_normal((3, 3, 3, 4))).astype(np.float32)
    b1 = (0.3 * rng.standard_normal(4)).astype(np.float32)
    w2 = (0.3 * rng.standard_normal((3, 3, 4, 8))).astype(np.float32)
    b2 = (0.3 * rng.standard_normal(8)).astype(np.float32)
    pe1, pe2 = T.ConvBN(3, 4, 3, stride=2), T.ConvBN(4, 8, 3, stride=2)
    for m, w, b in ((pe1, w1, b1), (pe2, w2, b2)):
        m.load_state_dict(state_dict_from_jax_params({"conv": {"kernel": w, "bias": b}}))
    with torch.no_grad():
        got = pe2(torch.nn.functional.gelu(pe1(torch.from_numpy(x)))).numpy()
    flax1, flax2 = JT.ConvBN(4, 3, stride=2), JT.ConvBN(8, 3, stride=2)
    mid = flax1.apply({"params": {"conv": {"kernel": w1, "bias": b1}}}, jnp.asarray(x))
    want_flax = flax2.apply({"params": {"conv": {"kernel": w2, "bias": b2}}},
                            jax.nn.gelu(mid, approximate=False))
    want_s2d = JC.patch_embed_s2d(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    assert got.shape == (2, hw[0] // 4, hw[1] // 4, 8)
    np.testing.assert_allclose(got, np.asarray(want_flax), atol=FLAX_ATOL, rtol=FLAX_ATOL)
    np.testing.assert_allclose(got, np.asarray(want_s2d), atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


def _chain_tensors(shape, ch, cout, dtype):
    cin = shape[-1]
    w = (torch.zeros(cin, ch, dtype=dtype), torch.zeros(ch), torch.zeros(3, 3, ch, dtype=dtype),
         torch.zeros(ch), torch.zeros(ch, cout, dtype=dtype))
    return torch.zeros(shape, dtype=dtype), w, torch.empty(*shape[:3], cout, dtype=dtype)


@pytest.mark.parametrize("shape,ch,cout,dtype,body,grid,smem", [
    # stage 0: 16 x 16 tiles (324 halo pixels for 256 outputs), 185 KB, one block an SM
    ((8, 256, 256, 64), 256, 64, torch.bfloat16, "tensor-core 16x16", (16, 16, 8), 185344),
    ((2, 256, 256, 64), 256, 64, torch.bfloat16, "tensor-core 16x16", (16, 16, 2), 185344),
    # the merge: Cout 320 takes 4 x 16 tiles
    ((2, 64, 64, 160), 320, 320, torch.bfloat16, "tensor-core 4x16", (4, 16, 2), 203264),
    ((1, 37, 45, 64), 256, 64, torch.bfloat16, "tensor-core 16x16", (3, 3, 1), 185344),
    ((1, 13, 21, 32), 64, 32, torch.bfloat16, "tensor-core 16x16", (2, 1, 1), 146432),
    # f32, narrow or ragged channels, Ch not a multiple of 64, Cout over 320: CUDA cores
    ((2, 7, 9, 8), 16, 8, torch.bfloat16, "simt", (2, 1, 2), 4 * (100 * 8 + 100 * 32 + 64 * (32 + 8))),
    ((1, 64, 64, 160), 320, 320, torch.float32, "simt", (8, 8, 1), 4 * (100 * 160 + 100 * 32 + 64 * (32 + 320))),
    ((1, 8, 8, 64), 96, 64, torch.bfloat16, "simt", (1, 1, 1), 4 * (100 * 64 + 100 * 32 + 64 * (32 + 64))),
    ((1, 8, 8, 64), 64, 352, torch.bfloat16, "simt", (1, 1, 1), 4 * (100 * 64 + 100 * 32 + 64 * (32 + 352))),
])
def test_chain_plan_picks_body_grid_and_shared_memory(shape, ch, cout, dtype, body, grid, smem):
    x, w, out = _chain_tensors(shape, ch, cout, dtype)
    plan = chain_plan(x, *w, out)
    assert (plan.body, plan.grid, plan.smem_bytes) == (body, grid, smem)


def test_chain_plan_unaligned_pointer_takes_simt_and_oversize_raises():
    x, w, out = _chain_tensors((1, 16, 16, 64), 128, 64, torch.bfloat16)
    assert chain_plan(x, *w, out).body == "tensor-core 16x16"
    shifted = torch.zeros(x.numel() + 4, dtype=x.dtype)[4:].view(x.shape)  # 8 bytes past a boundary
    assert chain_plan(shifted, *w, out).body == "simt"
    with pytest.raises(ValueError, match="shared memory"):
        x, w, out = _chain_tensors((1, 8, 8, 600), 64, 64, torch.float32)
        chain_plan(x, *w, out)

