"""vlfm_tpu_torch on the card: each CUDA kernel against its plain version.

Every test needs an NVIDIA GPU and ``nvcc``, and skips without them: a CUDA
kernel has no CPU mode. This file imports no jax, so it also runs where jax
is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from vlfm_tpu_torch.models.sam import SAM, SamConfig
from vlfm_tpu_torch.ops.conv_fused import chain_tolerance, kernel_route, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.ops.norms import bf16_tolerance, layer_norm, layer_norm_ref
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ln_inputs(rows, d, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(rows * 7 + d)
    x = (torch.randn(rows, d, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    bias = 0.1 * torch.randn(d, generator=gen, device=dev)
    return x, scale, bias


@pytest.mark.parametrize("rows,d,dtype,eps", [
    (8224, 1408, torch.bfloat16, 1e-6),   # ViT-g at B=32
    (1024, 768, torch.bfloat16, 1e-12),   # Q-Former queries at B=32
    (32, 768, torch.bfloat16, 1e-12),     # Q-Former text branch
    (7, 96, torch.float32, 1e-6),
    (1, 33, torch.float32, 1e-6),         # ragged D: scalar path
    (5, 2048, torch.float32, 1e-6),       # the widest D the kernel takes
])
def test_layer_norm_kernel_matches_plain(dev, rows, d, dtype, eps):
    x, scale, bias = _ln_inputs(rows, d, dtype, dev)
    before = layer_norm.launches
    got = layer_norm(x, scale, bias, eps)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = layer_norm_ref(x, scale, bias, eps)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        assert bool(((got.float() - want.float()).abs() <= bf16_tolerance(want)).all())


def test_layer_norm_kernel_takes_leading_shapes_and_offsets(dev):
    x, scale, bias = _ln_inputs(2 * 3 * 5, 64, torch.float32, dev)
    x3 = x.reshape(2, 15, 64)
    torch.testing.assert_close(layer_norm(x3, scale, bias), layer_norm_ref(x3, scale, bias),
                               atol=2e-5, rtol=0)
    # A row view that starts 8 bytes into its storage takes the scalar path.
    off = x.reshape(-1)[2:2 + 64 * 4].reshape(4, 64)
    torch.testing.assert_close(layer_norm(off, scale, bias), layer_norm_ref(off, scale, bias),
                               atol=2e-5, rtol=0)


def test_layer_norm_wrapper_raises_instead_of_falling_back(dev):
    x, scale, bias = _ln_inputs(8, 64, torch.bfloat16, dev)
    before = layer_norm.launches
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(x.t(), scale[:8], bias[:8])
    with pytest.raises(TypeError, match="float32"):
        layer_norm(x, scale.bfloat16(), bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layer_norm(x.half(), scale, bias)
    with pytest.raises(ValueError, match="D <= 2048"):
        big = torch.zeros(2, 4096, device=dev)
        layer_norm(big, torch.ones(4096, device=dev), torch.zeros(4096, device=dev))
    with pytest.raises(ValueError, match="is on cpu"):
        layer_norm(x, scale.cpu(), bias)
    assert layer_norm.launches == before


def test_tiny_blip2_card_matches_cpu_and_counts_launches(dev):
    cfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    cpu = BLIP2ITM.init_random(cfg, seed=0, device="cpu")
    gpu = BLIP2ITM(cfg, copy.deepcopy(cpu.module).to(dev))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (3, 56, 56, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(4, 56, (2, 16)).astype(np.int64))
    mask = torch.ones(2, 16, dtype=torch.bool)
    feats = gpu.encode_texts(ids.to(dev), mask.to(dev))
    before = layer_norm.launches
    got = gpu.cosine_cached_text(imgs.to(dev), feats)
    torch.cuda.synchronize()
    # ViT 2 x 2 + post_ln, Q-Former embed_ln + 2 x 2 + 1 cross_ln.
    assert layer_norm.launches - before == 5 + 6
    want = cpu.cosine(imgs, ids, mask)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_value_map_update_card_matches_cpu(dev):
    spec = GridSpec2D(size=512, pixels_per_meter=20, pad=160)
    rng = np.random.default_rng(1)
    depth = np.clip(np.repeat(rng.uniform(0.3, 1.0, (1, 64)), 48, 0), 0, 1).astype(np.float32)
    states = {d: VM.create(spec, 2, device=d) for d in ("cpu", dev)}
    for d, state in states.items():
        for k, yaw in enumerate((0.0, 0.9, -2.0)):
            tf = xyz_yaw_to_tf_matrix(torch.tensor([0.3 * k, -0.2, 0.88], device=d),
                                      torch.tensor(yaw, device=d))
            VM.update(state, spec, torch.tensor([0.2 + 0.3 * k, 0.5], device=d),
                      torch.from_numpy(depth).to(d), tf, 0.5, 5.0, float(np.deg2rad(79)),
                      use_max_confidence=False)
    diff = (states[dev].values.cpu() - states["cpu"].values).abs().amax(-1)
    diff = torch.maximum(diff, (states[dev].conf.cpu() - states["cpu"].conf).abs())
    # Cone-edge cells on an atan2/cos ulp tie may flip between devices.
    assert int((diff > 1e-5).sum()) <= 1e-3 * 3 * 256 * 256


def chain_inputs(shape, ch, cout, dtype, dev, seed=0):
    """x and lecun-scaled chain weights in the JAX layouts, biases f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cin = shape[-1]

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x = rnd(*shape).to(dtype)
    w = (rnd(cin, ch, scale=cin**-0.5).to(dtype), 0.1 * rnd(ch), rnd(3, 3, ch, scale=1 / 3).to(dtype),
         0.1 * rnd(ch), rnd(ch, cout, scale=ch**-0.5).to(dtype), 0.1 * rnd(cout))
    return x, w


@pytest.mark.parametrize("shape,ch,cout,residual,dtype,route", [
    ((2, 256, 256, 64), 256, 64, True, torch.bfloat16, "tensor-core"),   # stage-0 MBConv
    ((2, 64, 64, 160), 320, 320, False, torch.bfloat16, "tensor-core"),  # merge into stage 3
    ((1, 13, 21, 32), 64, 32, True, torch.bfloat16, "tensor-core"),      # ragged H and W
    ((2, 7, 9, 8), 16, 8, True, torch.bfloat16, "simt"),                 # narrow channels
    ((2, 7, 9, 8), 16, 8, True, torch.float32, "simt"),
    ((1, 5, 11, 8), 16, 16, False, torch.float32, "simt"),
    ((1, 64, 64, 160), 320, 320, False, torch.float32, "simt"),
])
def test_mbconv_chain_kernel_matches_plain(dev, shape, ch, cout, residual, dtype, route):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, w = chain_inputs(shape, ch, cout, dtype, dev)
    before = mbconv_chain.launches
    got = mbconv_chain(x, *w, residual=residual, final_gelu=residual)
    torch.cuda.synchronize()
    assert mbconv_chain.launches == before + 1
    assert kernel_route(x, w[0], w[4], got) == route
    want = mbconv_chain_ref(x, *w, residual=residual, final_gelu=residual)
    assert got.dtype == dtype and got.shape == want.shape == (*shape[:3], cout)
    err = (got.float() - want.float()).abs()
    ratio = float((err / chain_tolerance(want)).max())
    assert ratio <= 1.0, f"max err {float(err.max()):.3e}, {ratio:.2f} of the tolerance"


def test_mbconv_chain_wrapper_raises_instead_of_falling_back(dev):
    x, w = chain_inputs((1, 8, 8, 16), 32, 16, torch.bfloat16, dev)
    before = mbconv_chain.launches
    with pytest.raises(ValueError, match="contiguous"):
        mbconv_chain(x.transpose(1, 2), *w)
    with pytest.raises(TypeError, match="float32 b1"):
        mbconv_chain(x, w[0], w[1].bfloat16(), *w[2:])
    with pytest.raises(TypeError, match="bfloat16 w3"):
        mbconv_chain(x, *w[:4], w[4].float(), w[5])
    with pytest.raises(ValueError, match="Cout == Cin"):
        x2, w2 = chain_inputs((1, 8, 8, 16), 32, 8, torch.bfloat16, dev)
        mbconv_chain(x2, *w2, residual=True)
    with pytest.raises(ValueError, match="is on cpu"):
        mbconv_chain(x, w[0].cpu(), *w[1:])
    assert mbconv_chain.launches == before


def test_tiny_sam_card_matches_cpu_and_counts_launches(dev):
    """f32 tiny MobileSAM on the card, with K2 (its CUDA-core body at these
    narrow widths), against the same weights on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device="cpu")
    gpu = SAM(cpu.cfg, copy.deepcopy(cpu.module).to(dev))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7], [0.3, 0.2, 0.9, 0.9]]] * 3)
    before = mbconv_chain.launches
    with torch.no_grad():
        got, got_iou = gpu.module(imgs.to(dev), boxes.to(dev))
    torch.cuda.synchronize()
    assert mbconv_chain.launches - before == 2  # stage-0 MBConv + the stride-1 merge
    with torch.no_grad():
        want, want_iou = cpu.module(imgs, boxes)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_iou.cpu(), want_iou, atol=1e-4, rtol=1e-4)
