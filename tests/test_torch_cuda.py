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
