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

from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from vlfm_tpu_torch.models import grounding_dino as GD
from vlfm_tpu_torch.models.layers import Dense, FusedQKVAttention, merge_heads
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.models.sam import SAM, SamConfig
from vlfm_tpu_torch.ops import attention as A
from vlfm_tpu_torch.ops import deform_gather as DG
from vlfm_tpu_torch.ops import threefry as T
from vlfm_tpu_torch.ops.conv_fused import chain_plan, chain_tolerance, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.ops.norms import add_layer_norm, bf16_tolerance, layer_norm, layer_norm_ref
from vlfm_tpu_torch.parallel import mesh as MESH
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as ENV
from vlfm_tpu_torch.runner import packing as PK
from vlfm_tpu_torch.runner import sim_farm as SF
from vlfm_tpu_torch.runner.episode_driver import step_inputs
from vlfm_tpu_torch.runner.full_stack import FullStackPerception
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix
from vlfm_tpu_torch.utils.profiling import counters, reset_counters

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def counted(name):
    """The counter ``name`` since the last ``reset_counters()``."""
    return counters().get(name, 0)


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
    reset_counters()
    got = layer_norm(x, scale, bias, eps)
    torch.cuda.synchronize()
    assert counted("K1.launches") == 1
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
    reset_counters()
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
    assert counted("K1.launches") == 0


@pytest.mark.parametrize("rows,d,h_rows,dtype,eps,keep_sum", [
    (2056, 1408, 2056, torch.bfloat16, 1e-6, True),    # ViT-g at B=8, a block's add
    (2056, 1408, 257, torch.bfloat16, 1e-6, True),     # ViT-g's position table over 8 images
    (257, 1408, 257, torch.bfloat16, 1e-6, False),     # ViT-g at B=1, post_ln
    (256, 768, 256, torch.bfloat16, 1e-12, False),     # Q-Former at B=8, post-norm
    (577, 768, 577, torch.bfloat16, 1e-5, True),       # OWL-ViT vision at B=1
    (80 * 16, 512, 16, torch.bfloat16, 1e-5, True),    # OWL-ViT text: the position table over 80 prompts
    (7, 96, 7, torch.float32, 1e-6, True),
    (3, 33, 3, torch.float32, 1e-6, False),            # ragged D: scalar path
    (5, 2048, 5, torch.float32, 1e-6, True),           # the widest D the kernel takes
])
def test_add_layer_norm_kernel_matches_plain(dev, rows, d, h_rows, dtype, eps, keep_sum):
    x, scale, bias = _ln_inputs(rows, d, dtype, dev)
    h = _ln_inputs(h_rows, d, dtype, dev)[0] * 3 + 1
    reset_counters()
    x = x.reshape(-1, h_rows, d)  # h: one table for every group of h_rows rows
    got = add_layer_norm(x, h, scale, bias, eps, keep_sum=keep_sum)
    torch.cuda.synchronize()
    assert (counted("K1.launches"), counted("K1.fused_launches")) == (1, 1)
    s, y = got if keep_sum else (None, got)
    s_want = x + h
    y_want = layer_norm_ref(s_want, scale, bias, eps)
    assert y.dtype == dtype and y.shape == x.shape
    if keep_sum:
        assert torch.equal(s, s_want)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_want, atol=2e-5, rtol=0)
    else:
        assert bool(((y.float() - y_want.float()).abs() <= bf16_tolerance(y_want)).all())
    # The fused launch is the add, then the plain entry, bit for bit.
    assert torch.equal(y, layer_norm(s_want, scale, bias, eps))


def test_add_layer_norm_wrapper_raises_instead_of_falling_back(dev):
    x, scale, bias = _ln_inputs(8, 64, torch.bfloat16, dev)
    reset_counters()
    with pytest.raises(ValueError, match="contiguous"):
        add_layer_norm(x.t().contiguous().t(), x, scale, bias, keep_sum=True)
    with pytest.raises(ValueError, match="contiguous h"):
        add_layer_norm(x, x.t().contiguous().t(), scale, bias, keep_sum=True)
    with pytest.raises(TypeError, match="float32"):
        add_layer_norm(x, x, scale.bfloat16(), bias, keep_sum=False)
    with pytest.raises(TypeError, match="one dtype"):
        add_layer_norm(x, x.float(), scale, bias, keep_sum=False)
    with pytest.raises(ValueError, match="D <= 2048"):
        big = torch.zeros(2, 4096, device=dev)
        add_layer_norm(big, big, torch.ones(4096, device=dev), torch.zeros(4096, device=dev), keep_sum=True)
    with pytest.raises(ValueError, match="trailing dimensions"):  # broadcasts, but not as a table of rows
        add_layer_norm(x.reshape(2, 4, 64), x[:2].reshape(2, 1, 64), scale, bias, keep_sum=True)
    with pytest.raises(ValueError, match="h is on cpu"):
        add_layer_norm(x, x.cpu(), scale, bias, keep_sum=True)
    assert (counted("K1.launches"), counted("K1.fused_launches")) == (0, 0)


def test_tiny_blip2_card_matches_cpu_and_counts_launches(dev):
    cfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    cpu = BLIP2ITM.init_random(cfg, seed=0, device="cpu")
    gpu = BLIP2ITM(cfg, copy.deepcopy(cpu.module).to(dev))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (3, 56, 56, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(4, 56, (2, 16)).astype(np.int64))
    mask = torch.ones(2, 16, dtype=torch.bool)
    feats = gpu.encode_texts(ids.to(dev), mask.to(dev))
    reset_counters()
    got = gpu.cosine_cached_text(imgs.to(dev), feats)
    torch.cuda.synchronize()
    # ViT 2 x 2 + post_ln, Q-Former embed_ln + 2 x 2 + 1 cross_ln.
    assert counted("K1.launches") == 5 + 6
    assert counted("K3.launches") == 2  # one K3 launch per ViT block
    want = cpu.cosine(imgs, ids, mask)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("x_on_card", [True, False])
def test_split_dense_on_the_card_matches_dense(dev, x_on_card):
    """ViT-g's qkv at B=2 split over [cuda:0] * 2: each block computed on
    the card, gathered on x's device, within one bf16 rounding of the
    whole product (cuBLAS may tile an (M, K, N/2) GEMM otherwise)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    whole = Dense(1408, 4224, device=dev).requires_grad_(False)
    whole.weight.copy_(torch.randn(4224, 1408, generator=gen, device=dev) * 1408**-0.5)
    whole.bias.copy_(torch.randn(4224, generator=gen, device=dev))
    whole = whole.to(torch.bfloat16)
    split = MESH.SplitDense(whole, [dev, dev])
    assert all(w.device == dev for w in split.weights)
    x = torch.randn(2, 257, 1408, generator=gen, device=dev).to(torch.bfloat16)
    x = x if x_on_card else x.cpu()
    got = split(x)
    assert got.device == x.device and got.dtype == torch.bfloat16
    want = whole(x.to(dev)).to(x.device)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2**-7)


def test_tiny_itm_split_over_a_model_axis_on_the_card_matches_unsplit(dev):
    cfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    gpu = BLIP2ITM(cfg, BLIP2ITM.init_random(cfg, seed=0, device="cpu").module.to(dev))
    mesh = MESH.make_mesh(devices=[dev] * 4, model_parallel=2)
    rows = MESH.shard_params_tp(gpu.module, mesh)
    assert all(sum(isinstance(m, MESH.SplitDense) for m in row.modules()) == 30 for row in rows)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (4, 56, 56, 3)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(4, 56, (2, 16)).astype(np.int64)).to(dev)
    mask = torch.ones(2, 16, dtype=torch.bool, device=dev)
    reset_counters()
    got = torch.cat([BLIP2ITM(cfg, row).cosine(blk, ids, mask)
                     for row, blk in zip(rows, MESH.shard_episode_batch(imgs, mesh))])
    torch.cuda.synchronize()
    # Per row: the image call's 11 K1 launches and the text call's 5; K3 once per ViT block.
    assert counted("K1.launches") == 2 * (11 + 5)
    assert counted("K3.launches") == 2 * 2
    torch.testing.assert_close(got, gpu.cosine(imgs, ids, mask), atol=1e-5, rtol=0)


def test_value_map_update_card_matches_cpu(dev):
    spec = GridSpec2D(size=512, pixels_per_meter=20, pad=160)
    rng = np.random.default_rng(1)
    depth = np.clip(np.repeat(rng.uniform(0.3, 1.0, (1, 64)), 48, 0), 0, 1).astype(np.float32)
    states = {d: VM.create(spec, 2, device=d) for d in ("cpu", dev)}
    for d, state in states.items():
        for k, yaw in enumerate((0.0, 0.9, -2.0)):
            tf = xyz_yaw_to_tf_matrix(torch.tensor([0.3 * k, -0.2, 0.88], device=d),
                                      torch.tensor(yaw, device=d))[None]
            VM.update(state, spec, torch.tensor([[0.2 + 0.3 * k, 0.5]], device=d),
                      torch.from_numpy(depth).to(d)[None], tf, 0.5, 5.0, float(np.deg2rad(79)),
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


def _check_chain(x, w, residual, body):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counters()
    got = mbconv_chain(x, *w, residual=residual, final_gelu=residual)
    torch.cuda.synchronize()
    assert counted("K2.launches") == 1
    assert chain_plan(x, w[0], w[1], w[2], w[3], w[4], got).body == body
    want = mbconv_chain_ref(x, *w, residual=residual, final_gelu=residual)
    assert got.dtype == x.dtype and got.shape == want.shape == (*x.shape[:3], w[4].shape[1])
    err = (got.float() - want.float()).abs()
    ratio = float((err / chain_tolerance(want)).max())
    assert ratio <= 1.0, f"max err {float(err.max()):.3e}, {ratio:.2f} of the tolerance"


@pytest.mark.parametrize("shape,ch,cout,residual,dtype,route", [
    ((2, 256, 256, 64), 256, 64, True, torch.bfloat16, "tensor-core 16x16"),  # stage-0 MBConv
    ((2, 64, 64, 160), 320, 320, False, torch.bfloat16, "tensor-core 4x16"),  # merge into stage 3
    ((1, 13, 21, 32), 64, 32, True, torch.bfloat16, "tensor-core 16x16"),     # ragged H and W
    ((2, 7, 9, 8), 16, 8, True, torch.bfloat16, "simt"),                      # narrow channels
    ((2, 7, 9, 8), 16, 8, True, torch.float32, "simt"),
    ((1, 5, 11, 8), 16, 16, False, torch.float32, "simt"),
    ((1, 64, 64, 160), 320, 320, False, torch.float32, "simt"),
])
def test_mbconv_chain_kernel_matches_plain(dev, shape, ch, cout, residual, dtype, route):
    x, w = chain_inputs(shape, ch, cout, dtype, dev)
    _check_chain(x, w, residual, route)


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("shape,ch,cout,residual,body", [
    ((256, 256, 64), 256, 64, True, "tensor-core 16x16"),   # stage 0
    ((64, 64, 160), 320, 320, False, "tensor-core 4x16"),   # the merge
    ((37, 45, 64), 256, 64, True, "tensor-core 16x16"),     # H and W not multiples of 16
    ((21, 19, 160), 320, 320, False, "tensor-core 4x16"),   # H not a multiple of 4, W not of 16
    ((9, 11, 32), 64, 96, False, "tensor-core 4x16"),       # a narrower wide Cout, one chunk
    ((17, 5, 16), 128, 48, False, "tensor-core 16x16"),     # Cout 48, narrower than a tile
])
def test_mbconv_chain_tensor_core_bodies_at_their_edges(dev, b, shape, ch, cout, residual, body):
    x, w = chain_inputs((b, *shape), ch, cout, torch.bfloat16, dev, seed=b)
    _check_chain(x, w, residual, body)


@pytest.mark.parametrize("which", ["x", "w1", "w3"])
def test_mbconv_chain_unaligned_pointer_takes_simt(dev, which):
    """A tensor that does not start on a 16-byte boundary cannot be copied
    by cp.async: the call takes the CUDA-core body."""
    x, w = chain_inputs((2, 20, 24, 64), 256, 64, torch.bfloat16, dev)
    w = list(w)

    def shifted(t):  # the same values, 8 bytes into a fresh buffer
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
        out = buf[4:].view(t.shape)
        out.copy_(t)
        return out

    if which == "x":
        x = shifted(x)
    else:
        i = {"w1": 0, "w3": 4}[which]
        w[i] = shifted(w[i])
    _check_chain(x, tuple(w), True, "simt")


def test_mbconv_chain_wrapper_raises_instead_of_falling_back(dev):
    x, w = chain_inputs((1, 8, 8, 16), 32, 16, torch.bfloat16, dev)
    reset_counters()
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
    assert counted("K2.launches") == 0


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
    reset_counters()
    with torch.no_grad():
        got, got_iou = gpu.module(imgs.to(dev), boxes.to(dev))
    torch.cuda.synchronize()
    assert counted("K2.launches") == 2  # stage-0 MBConv + the stride-1 merge
    with torch.no_grad():
        want, want_iou = cpu.module(imgs, boxes)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_iou.cpu(), want_iou, atol=1e-4, rtol=1e-4)


ATTN_VARIANTS = [
    dict(clamp=None, normalize="probs"),
    dict(clamp=None, normalize="output"),
    dict(clamp=80.0, normalize="output", round_logits=True),
    dict(clamp=60.0, normalize="output"),
    dict(clamp=60.0, normalize="output", round_logits=True),
]


def _attn_inputs(shape, dtype, dev, layout="", seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, l, d = shape
    if layout == "qkv":
        return A.qkv_views(torch.randn(b, l, 3 * h * d, generator=gen, device=dev).to(dtype), h)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device=dev).to(dtype) for _ in range(3))
    if layout == "kt":
        k = k.transpose(-1, -2).contiguous().transpose(-1, -2)
    return q, k, v


@pytest.mark.parametrize("variant", range(len(ATTN_VARIANTS)))
@pytest.mark.parametrize("shape,dtype,layout", [
    ((32, 16, 257, 88), torch.bfloat16, "qkv"),  # ViT-g at B=32, as the ViT passes it
    ((2, 16, 257, 88), torch.bfloat16, ""),
    ((2, 16, 257, 88), torch.bfloat16, "kt"),     # K stored transposed
    ((2, 4, 1024, 64), torch.bfloat16, ""),
    ((1, 2, 70, 128), torch.bfloat16, ""),        # the widest head, short query axis
    ((1, 1, 9, 128), torch.float32, ""),
    ((2, 2, 64, 32), torch.float32, ""),
    ((1, 16, 257, 88), torch.float32, "kt"),
    ((2, 4, 130, 16), torch.float32, "qkv"),
    ((1, 3, 5, 8), torch.bfloat16, ""),           # fewer queries and keys than a tile
    ((1, 2, 3000, 32), torch.bfloat16, ""),       # shared memory does not grow with L
])
def test_attention_kernel_matches_plain(dev, shape, dtype, layout, variant):
    q, k, v = _attn_inputs(shape, dtype, dev, layout)
    _check_attention(q, k, v, ATTN_VARIANTS[variant])


def _check_attention(q, k, v, kw, body=None):
    """One launch, against the plain version under its tolerance; with
    ``body``, the plan's description of the kernel body too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counters()
    got = A.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert counted("K3.launches") == 1
    if body is not None:
        assert A.attention_plan(q, k, v, got).describe() == body
    want = A.attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    ratio = float((err / A.attention_tolerance(want, kw.get("round_logits", False))).max())
    assert ratio <= 1.0, f"max err {float(err.max()):.3e}, {ratio:.2f} of the tolerance"


@pytest.mark.parametrize("variant", range(len(ATTN_VARIANTS)))
@pytest.mark.parametrize("length", [1, 15, 16, 17, 257, 300, 1024])
@pytest.mark.parametrize("d", [16, 32, 64, 88, 96, 128])
def test_attention_bf16_bodies_at_their_edges(dev, variant, length, d):
    """Lengths around the 16-row query tiles, the whole-head body's 272
    keys and the streaming body's 64-key chunks; every head width."""
    q, k, v = _attn_inputs((1, 2, length, d), torch.bfloat16, dev, seed=length * 131 + d)
    _check_attention(q, k, v, ATTN_VARIANTS[variant], "whole-head" if length <= A.WHOLE_HEAD_KEYS else "streaming")


def _unaligned(shape, dev, seed):
    """q, k, v whose rows start 2 bytes past a 16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, l, d = shape
    return tuple(torch.randn(b, h, l, d + 1, generator=gen, device=dev).bfloat16()[..., 1:] for _ in range(3))


@pytest.mark.parametrize("variant", range(len(ATTN_VARIANTS)))
@pytest.mark.parametrize("shape,layout,body", [
    ((12, 16, 257, 88), "qkv", "whole-head"),                                 # the spin's 12 views
    ((2, 4, 130, 16), "qkv", "whole-head"),
    ((2, 16, 256, 88), "kt", "whole-head, K^T tile"),                         # K^T copied by cp.async
    ((2, 16, 257, 88), "kt", "whole-head, K^T tile, element loads of k"),     # odd L: K^T element by element
    ((1, 2, 1024, 64), "kt", "streaming, K^T tile"),
    ((1, 3, 300, 40), "kt", "streaming, K^T tile, element loads of k"),
    ((2, 3, 100, 24), "unaligned", "whole-head, element loads of q/k/v"),
    ((1, 2, 300, 40), "unaligned", "streaming, element loads of q/k/v"),
])
def test_attention_layouts_take_their_bodies(dev, variant, shape, layout, body):
    if layout == "unaligned":
        q, k, v = _unaligned(shape, dev, seed=variant)
    else:
        q, k, v = _attn_inputs(shape, torch.bfloat16, dev, layout, seed=variant)
    _check_attention(q, k, v, ATTN_VARIANTS[variant], body)


def test_attention_padded_keys_do_not_leak(dev):
    ones = torch.ones((1, 1, 257, 88), device=dev)
    for kw in ATTN_VARIANTS[:2]:
        torch.testing.assert_close(A.attention(ones, ones, ones, **kw), ones, atol=2e-5, rtol=0)


def test_fused_qkv_attention_on_the_card_matches_cpu_and_merges_by_view(dev):
    torch.manual_seed(0)
    cpu = FusedQKVAttention(96, 4, device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    x = torch.randn(2, 33, 96)
    reset_counters()
    got = gpu(x.to(dev))
    assert counted("K3.launches") == 1
    torch.testing.assert_close(got.cpu(), cpu(x), atol=1e-5, rtol=0)
    q, k, v = A.qkv_views(gpu.qkv(x.to(dev)), 4)
    out = A.attention(q, k, v)
    assert out.transpose(1, 2).is_contiguous()  # (B, L, H, D) memory
    assert merge_heads(out).data_ptr() == out.data_ptr()  # merging the heads copies nothing


def test_attention_on_the_card_never_takes_the_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(A, "attention_ref", refuse)
    q, k, v = _attn_inputs((1, 2, 40, 24), torch.bfloat16, dev)
    A.attention(q, k, v)
    torch.cuda.synchronize()


def test_attention_wrapper_raises_instead_of_falling_back(dev):
    q, k, v = _attn_inputs((1, 2, 40, 24), torch.bfloat16, dev)
    reset_counters()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k is"):
        A.attention(q, k.float(), v)
    with pytest.raises(ValueError, match="is on cpu"):
        A.attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="D <= 128"):
        big = torch.zeros(1, 1, 4, 160, device=dev)
        A.attention(big, big, big)
    with pytest.raises(ValueError, match="do not match"):
        A.attention(q, k[:, :1], v)
    with pytest.raises(ValueError, match="normalize"):
        A.attention(q, k, v, normalize="rows")
    assert counted("K3.launches") == 0


def test_obstacle_map_card_matches_cpu(dev):
    """Six spin frames into a small map on both devices: the grids agree but
    for cone-edge cells on an atan2/cos ulp tie, and so do the frontiers."""
    cfg = TCONFIG.VLFMConfig(map_size=256, map_pad=64, camera=TCONFIG.CameraConfig(width=160, height=120))
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    env = ENV.FakeObjectNavEnv(ENV.two_room_plan(seed=0), ENV.EnvConfig(width=160, height=120))
    views = [env.reset()] + [env.step(ENV.TURN_LEFT) for _ in range(5)]
    states = {}
    for d in ("cpu", dev):
        state = OM.create(spec, cfg.max_frontiers, device=d)
        for steps, o in enumerate(views):
            tf = xyz_yaw_to_tf_matrix(
                torch.tensor([*o["robot_xy"], cfg.camera.camera_height], dtype=torch.float32, device=d),
                torch.tensor(o["heading"], dtype=torch.float32, device=d))[None]
            depth = torch.from_numpy(o["depth"].astype(np.float32)).to(d)[None]
            state = ITM.update_obstacles(state, spec, cfg, depth, tf, steps)
        states[d] = state
    got, want = states[dev], states["cpu"]
    for name in ("obstacles", "navigable", "explored"):
        assert int((getattr(got, name).cpu() != getattr(want, name)).sum()) <= 1e-3 * 6 * 224 * 224, name
    assert torch.equal(got.frontiers_valid.cpu(), want.frontiers_valid)
    torch.testing.assert_close(got.frontiers_xy.cpu(), want.frontiers_xy, atol=0.1, rtol=0)


def _offset_view(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its buffer."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _deform_inputs(b, q, nh, dh, shapes, npts, vdtype, wdtype, dev, spread=1.5, far=0.0, seed=0,
                   value_offset=0, grids_offset=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    value = _offset_view(torch.randn(b, s, nh * dh, generator=gen, device=dev).to(vdtype), value_offset)
    grids = (torch.rand(b, q, nh, len(shapes), npts, 2, generator=gen, device=dev) * 2 - 1) * spread
    if far:
        pick = torch.rand(grids.shape, generator=gen, device=dev) < far
        sign = torch.where(torch.rand(grids.shape, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        grids = torch.where(pick, sign * 1e6, grids)
    logits = torch.randn(b, q, nh, len(shapes) * npts, generator=gen, device=dev)
    weights = torch.softmax(logits, -1).reshape(b, q, nh, len(shapes), npts).to(wdtype)
    return value, _offset_view(grids.contiguous(), grids_offset), weights


FOUR_LEVELS = ((40, 40), (20, 20), (10, 10), (5, 5))


@pytest.mark.parametrize("b,q,nh,dh,shapes,npts,vdtype,wdtype,far,value_offset,grids_offset", [
    (2, 1200, 8, 32, FOUR_LEVELS, 4, torch.float32, torch.float32, 0.0, 0, 0),  # encoder-like: 16 samples
    (2, 900, 8, 32, FOUR_LEVELS, 4, torch.bfloat16, torch.float32, 0.05, 0, 0),
    (1, 70, 2, 16, ((7, 9), (4, 5), (2, 3)), 3, torch.float32, torch.float32, 0.2, 0, 0),  # the CPU tests' ragged shape
    (1, 33, 3, 40, ((6, 11),), 2, torch.bfloat16, torch.bfloat16, 0.0, 0, 0),  # 5 vectors over a group of 8
    (1, 5, 1, 128, ((3, 4), (2, 2)), 20, torch.float32, torch.bfloat16, 0.1, 0, 0),  # widest head, 40 samples
    (2, 301, 3, 33, FOUR_LEVELS, 4, torch.float32, torch.float32, 0.05, 0, 0),  # odd dh: 2 elements a lane
    (1, 77, 2, 33, ((9, 7), (3, 3)), 20, torch.bfloat16, torch.float32, 0.05, 0, 0),  # odd dh, 40 samples
    (2, 1201, 8, 32, FOUR_LEVELS, 4, torch.float32, torch.float32, 0.05, 0, 0),  # bulk copies, a ragged last tile
    (2, 1201, 8, 32, FOUR_LEVELS, 4, torch.float32, torch.float32, 0.05, 1, 0),  # value 4 bytes off 16
    (2, 1201, 8, 32, FOUR_LEVELS, 4, torch.float32, torch.float32, 0.05, 2, 1),  # value 8 bytes off, grids 4 bytes off
    (2, 1201, 8, 32, FOUR_LEVELS, 4, torch.bfloat16, torch.bfloat16, 0.05, 2, 0),  # bf16 value 4 bytes off 16
])
def test_deform_gather_kernel_matches_plain(dev, b, q, nh, dh, shapes, npts, vdtype, wdtype, far, value_offset,
                                            grids_offset):
    torch.backends.cuda.matmul.allow_tf32 = False
    value, grids, weights = _deform_inputs(b, q, nh, dh, shapes, npts, vdtype, wdtype, dev, far=far,
                                           value_offset=value_offset, grids_offset=grids_offset)
    assert value.is_contiguous() and value.data_ptr() % 16 == (value_offset * value.element_size()) % 16
    reset_counters()
    got = DG.deform_gather(value, shapes, grids, weights)
    torch.cuda.synchronize()
    assert counted("K4.launches") == 1
    want = DG.deform_gather_ref(value, shapes, grids, weights)
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, q, nh, dh)
    err = float((got - want).abs().max())
    assert err <= DG.deform_gather_tolerance(value, weights), err
    again = DG.deform_gather(value, shapes, grids, weights)
    assert torch.equal(again, got)  # one lane group per output, a fixed order: bit-reproducible


def test_deform_gather_kernel_refuses_a_plan_it_does_not_share(dev):
    """The C side checks the plan's legality and its shared-memory figure."""
    from vlfm_tpu_torch.kernels.build import load_library

    shapes = FOUR_LEVELS
    b, q, nh, dh, npts = 1, 40, 8, 32, 4
    value, grids, weights = _deform_inputs(b, q, nh, dh, shapes, npts, torch.float32, torch.float32, dev)
    out = torch.empty(b, q, nh, dh, device=dev)
    plan = DG.deform_plan(b, q, nh, dh, len(shapes), npts, torch.float32, torch.float32, 16)
    levels = (DG.ctypes.c_int * 8)(*(n for hw in shapes for n in hw))

    def call(**change):
        args = dict(vec=plan.vec, lanes=plan.lanes, chunks=plan.chunks, warps=plan.warps, nlp=16,
                    bulk=int(plan.bulk), grid=plan.grid, smem=plan.smem_bytes) | change
        return load_library().vlfm_deform_gather(
            value.data_ptr(), grids.data_ptr(), weights.data_ptr(), out.data_ptr(), levels, 4, b, value.shape[1],
            q, nh, dh, npts, 0, 0, *args.values(), torch.cuda.current_stream(dev).cuda_stream)

    assert call() == 0
    torch.cuda.synchronize()
    for change in (dict(smem=plan.smem_bytes + 16), dict(lanes=plan.lanes * 2), dict(vec=8), dict(nlp=0),
                   dict(bulk=0), dict(chunks=2)):
        assert call(**change) != 0, change


def test_deform_gather_on_the_card_never_takes_the_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(DG, "deform_gather_ref", refuse)
    shapes = ((4, 4),)
    value, grids, weights = _deform_inputs(1, 3, 2, 8, shapes, 2, torch.float32, torch.float32, dev)
    DG.deform_gather(value, shapes, grids, weights)
    torch.cuda.synchronize()


def test_deform_gather_wrapper_raises_instead_of_falling_back(dev):
    shapes = ((4, 4), (2, 2))
    value, grids, weights = _deform_inputs(1, 6, 2, 8, shapes, 2, torch.float32, torch.float32, dev)
    reset_counters()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        DG.deform_gather(value.half(), shapes, grids, weights)
    with pytest.raises(TypeError, match="float32 grids"):
        DG.deform_gather(value, shapes, grids.bfloat16(), weights)
    with pytest.raises(ValueError, match="is on cpu"):
        DG.deform_gather(value, shapes, grids.cpu(), weights)
    with pytest.raises(ValueError, match="contiguous"):
        DG.deform_gather(torch.cat([value, value], -1)[..., :value.shape[-1]], shapes, grids, weights)
    with pytest.raises(ValueError, match="does not hold"):
        DG.deform_gather(value, ((4, 4), (2, 3)), grids, weights)
    with pytest.raises(ValueError, match="levels"):
        DG.deform_gather(value, shapes[:1], grids, weights)
    with pytest.raises(ValueError, match="do not match"):
        DG.deform_gather(value, shapes, grids, weights[:, :3])
    assert counted("K4.launches") == 0


def test_tiny_grounding_dino_card_matches_cpu_and_counts_launches(dev):
    """f32 tiny GroundingDINO on the card (K4 for its four deformable
    attentions) against the same weights on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = GD.GroundingDinoDetector.init_random(GD.GroundingDinoConfig.tiny_test(), seed=0, device="cpu")
    gpu = GD.GroundingDinoDetector(cpu.cfg, copy.deepcopy(cpu.module).to(dev))
    imgs = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(np.float32))
    ids, mask, _ = GD.build_caption_ids([np.array([5, 6]), np.array([7])], 16)
    reset_counters()
    got_logits, got_boxes = gpu.predict(imgs.to(dev), ids, mask)
    torch.cuda.synchronize()
    assert counted("K4.launches") == GD.deformable_attentions(cpu.cfg) == 4
    want_logits, want_boxes = cpu.predict(imgs, ids, mask)
    finite = torch.isfinite(want_logits)
    assert torch.equal(torch.isfinite(got_logits.cpu()), finite)
    torch.testing.assert_close(got_logits.cpu()[finite], want_logits[finite], atol=1e-3, rtol=0)
    torch.testing.assert_close(got_boxes.cpu(), want_boxes, atol=1e-4, rtol=0)


def test_pointnav_act_card_matches_cpu(dev):
    """Full-width PointNav (224x224 depth, B = 2) on the card against the
    same weights on the CPU, with TF32 left on by the caller for cuBLAS and
    cuDNN and cuDNN's benchmark on: ``act`` turns TF32 off for its
    convolutions, linear layers and LSTM, and gives every flag back."""
    cpu = PN.PointNavPolicy.init_random(0, device="cpu")
    gpu = PN.PointNavPolicy(copy.deepcopy(cpu.module).to(dev))
    rng = np.random.default_rng(0)
    depth = torch.from_numpy(rng.uniform(0, 1, (2, 224, 224)).astype(np.float32))
    goal = torch.from_numpy(np.array([[2.0, 0.3], [4.5, -2.0]], np.float32))
    states = {d: PN.initial_state(2, device=d) for d in ("cpu", dev)}
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark)
    matmul.allow_tf32 = cudnn.allow_tf32 = cudnn.benchmark = True
    try:
        for _ in range(3):
            _, states["cpu"] = cpu.act(depth, goal, states["cpu"])
            _, states[dev] = gpu.act(depth.to(dev), goal.to(dev), states[dev])
            assert (matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark) == (True, True, True)
            for name in ("h", "c"):
                torch.testing.assert_close(getattr(states[dev], name).cpu(), getattr(states["cpu"], name),
                                           atol=1e-4, rtol=0)
            torch.testing.assert_close(gpu.logits(states[dev]).cpu(), cpu.logits(states["cpu"]), atol=1e-4, rtol=0)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = before


def test_policy_step_card_matches_cpu(dev):
    """Two two-room episodes (B = 2) through 14 policy steps with PointNav
    and oracle detections, on the card and on the CPU from the same frames:
    the same modes every step, PointNav within 1e-4, and at the end the
    grids within the cone-edge allowance and the same frontiers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TCONFIG.VLFMConfig(map_size=256, map_pad=64, camera=TCONFIG.CameraConfig(width=160, height=120))
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    cpu = PN.PointNavPolicy.init_random(0, device="cpu")
    policies = {"cpu": cpu, dev: PN.PointNavPolicy(copy.deepcopy(cpu.module).to(dev))}
    envs = [ENV.FakeObjectNavEnv(ENV.two_room_plan(s), ENV.EnvConfig(width=160, height=120)) for s in (0, 1)]
    frames = [[e.reset() for e in envs]]
    for a in [ENV.TURN_LEFT] * 12 + [ENV.MOVE_FORWARD]:
        frames.append([e.step(a) for e in envs])
    states = {d: ITM.create_state(spec, cfg, batch=2, device=d) for d in policies}
    for k, obs in enumerate(frames):
        infos = {}
        for d, pn in policies.items():
            keys = T.fold_in(T.PRNGKey(torch.arange(2, device=d)), k)
            _, infos[d], states[d] = ITM.step(states[d], *step_inputs(obs, cfg, d), keys, pointnav=pn, spec=spec,
                                              cfg=cfg)
        assert torch.equal(infos[dev].mode.cpu(), infos["cpu"].mode)
        for name in ("h", "c"):
            torch.testing.assert_close(getattr(states[dev].pointnav, name).cpu(),
                                       getattr(states["cpu"].pointnav, name), atol=1e-4, rtol=0)
    got, want = states[dev].obstacle, states["cpu"].obstacle
    for name in ("obstacles", "navigable", "explored"):
        assert int((getattr(got, name).cpu() != getattr(want, name)).sum()) <= 1e-3 * 2 * 14 * 224 * 224, name
    assert torch.equal(got.frontiers_valid.cpu(), want.frontiers_valid)
    torch.testing.assert_close(got.frontiers_xy.cpu(), want.frontiers_xy, atol=0.1, rtol=0)


@pytest.mark.parametrize("compressed", [False, True], ids=["f32", "u16-half"])
def test_packed_fused_step_card_matches_cpu(dev, compressed):
    """The full stack's packed fused step (tiny f32 BLIP2-ITM, OWL-ViT and
    MobileSAM, 48x64 frames, 2 lanes) on the card, fed from pinned memory,
    against the same weights on the CPU: two dispatches, the second
    restarting lane 1; actions and detections equal, goals within 1e-5 m.
    With f32 full-size records, and with the JAX bench's transport (u16
    half-size depth, half-size RGB): dequantised, upsampled and its masks
    brought to the camera grid on each device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = 48, 64
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=h, width=w), max_frontiers=16,
                             max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                             max_detections_per_frame=4)
    spec = GridSpec2D(512, 20, 160)
    itm_cpu = BLIP2ITM.init_random(dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32), seed=0,
                                   device="cpu")
    cpu = FullStackPerception(cfg, itm=itm_cpu, device="cpu")
    det, sam = cpu.pipeline.detector, cpu.pipeline.sam
    gpu = FullStackPerception(
        cfg, itm=BLIP2ITM(itm_cpu.cfg, copy.deepcopy(itm_cpu.module).to(dev)),
        detector=type(det)(det.cfg, copy.deepcopy(det.module).to(dev)),
        sam=SAM(sam.cfg, copy.deepcopy(sam.module).to(dev)), device=dev)
    rh, rw = (h // 2, w // 2) if compressed else (h, w)
    layout = PK.build_layout([("depth", "uint16" if compressed else "float32", (2, rh, rw)),
                              ("rgb", "uint8", (2, rh, rw, 3)),
                              ("heading", "float32", (2,)), ("xy", "float32", (2, 2)), ("seeds", "int32", (2,)),
                              ("steps", "int32", (2,)), ("reset", "uint8", (2,))])
    steps = {d: p.make_fused_step("greedy", spec, cfg, "toilet", layout=layout) for d, p in (("cpu", cpu), (dev, gpu))}
    states = {d: ITM.create_state(spec, cfg, batch=2, device=d) for d in steps}
    envs = [ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=s), ENV.EnvConfig(width=w, height=h)) for s in (0, 1, 2)]
    buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
    views = PK.pack_views(buf.numpy(), layout)
    dispatches = [([envs[0].reset(), envs[1].reset()], (0, 1), (0, 0), (0, 0))]
    dispatches.append(([envs[0].step(ENV.TURN_LEFT), envs[2].reset()], (0, 2), (1, 0), (0, 1)))
    for obs, seeds, steps_, reset in dispatches:
        for j, o in enumerate(obs):
            if compressed:
                views["depth"][j] = np.clip(SF._avg2x2_f32(o["depth"]), 0, 1) * 65535.0 + 0.5
                views["rgb"][j] = SF._avg2x2_u8(o["rgb"])
            else:
                views["depth"][j], views["rgb"][j] = o["depth"], o["rgb"]
            views["heading"][j], views["xy"][j] = o["heading"], o["robot_xy"]
        views["seeds"][:], views["steps"][:], views["reset"][:] = seeds, steps_, reset
        outs = {}
        for d, step in steps.items():
            out, states[d] = step(states[d], None, buf)
            outs[d] = out.cpu()
        assert torch.equal(outs[dev][:, :2], outs["cpu"][:, :2])
        torch.testing.assert_close(outs[dev][:, 2:], outs["cpu"][:, 2:], atol=1e-5, rtol=0)
    assert states[dev].steps.tolist() == [2, 1]


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_t5_bucket_table_on_the_card_equals_the_cpu(dev, bidirectional):
    """The bucket table is an integer cut of a float log: it is built on the
    host and copied, so the card's equals the CPU's at every shape, and the
    card's own log gives the same table too."""
    from vlfm_tpu_torch.models.t5_vqa import bucket_table, relative_position_bucket

    for lq, lk in ((5, 5), (40, 40), (300, 300), (5, 300)):
        want = bucket_table(lq, lk, bidirectional, 32, 128, torch.device("cpu"))
        assert torch.equal(bucket_table(lq, lk, bidirectional, 32, 128, dev).cpu(), want)
        rel = torch.arange(lk, device=dev)[None, :] - torch.arange(lq, device=dev)[:, None]
        assert torch.equal(relative_position_bucket(rel, bidirectional, 32, 128).cpu().long(), want)


@pytest.mark.parametrize("two_domains", [False, True], ids=["nyu", "nk"])
def test_tiny_zoedepth_card_matches_cpu(dev, two_domains):
    from vlfm_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig

    cfg = ZoeDepthConfig.tiny_test()
    if two_domains:
        cfg = dataclasses.replace(cfg, bin_configurations=ZoeDepthConfig.nk().bin_configurations)
    cpu = ZoeDepth.init_random(cfg, seed=0, device="cpu")
    gpu = ZoeDepth(cfg, copy.deepcopy(cpu.module).to(dev))
    px = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32))
    torch.testing.assert_close(gpu.predict(px.to(dev)).cpu(), cpu.predict(px), atol=1e-4, rtol=0)
    rgb = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8))
    torch.testing.assert_close(gpu.infer_depth(rgb.to(dev), 0.5, 5.0).cpu(), cpu.infer_depth(rgb, 0.5, 5.0),
                               atol=1e-4, rtol=0)


def test_vqa_fused_step_card_matches_cpu(dev):
    """The full stack with the VQA veto (tiny f32 BLIP2-ITM, OWL-ViT,
    MobileSAM and BLIP2VQA; the veto gated at 2 slots) on the card against
    the CPU: two packed dispatches on 2 lanes, actions and detections
    equal, goals within 1e-5 m."""
    from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VQAConfig
    from vlfm_tpu_torch.models.t5_vqa import T5VQA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = 48, 64
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=h, width=w), max_frontiers=16,
                             max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                             max_detections_per_frame=4, use_vqa=True, vqa_slot_capacity=2)
    spec = GridSpec2D(512, 20, 160)
    itm_cpu = BLIP2ITM.init_random(dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32), seed=0,
                                   device="cpu")
    vqa_cpu = BLIP2VQA.init_random(BLIP2VQAConfig.tiny(), seed=0, device="cpu")
    cpu = FullStackPerception(cfg, itm=itm_cpu, blip2_vqa=vqa_cpu, device="cpu")
    det, sam = cpu.pipeline.detector, cpu.pipeline.sam
    gpu = FullStackPerception(
        cfg, itm=BLIP2ITM(itm_cpu.cfg, copy.deepcopy(itm_cpu.module).to(dev)),
        detector=type(det)(det.cfg, copy.deepcopy(det.module).to(dev)),
        sam=SAM(sam.cfg, copy.deepcopy(sam.module).to(dev)),
        blip2_vqa=BLIP2VQA(vqa_cpu.cfg, copy.deepcopy(vqa_cpu.module).to(dev),
                           T5VQA(vqa_cpu.cfg.t5, copy.deepcopy(vqa_cpu.t5.module).to(dev))), device=dev)
    layout = PK.build_layout([("depth", "float32", (2, h, w)), ("rgb", "uint8", (2, h, w, 3)),
                              ("heading", "float32", (2,)), ("xy", "float32", (2, 2)), ("seeds", "int32", (2,)),
                              ("steps", "int32", (2,)), ("reset", "uint8", (2,))])
    steps = {d: p.make_fused_step("greedy", spec, cfg, "toilet", layout=layout) for d, p in (("cpu", cpu), (dev, gpu))}
    states = {d: ITM.create_state(spec, cfg, batch=2, device=d) for d in steps}
    envs = [ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=s), ENV.EnvConfig(width=w, height=h)) for s in (0, 1, 2)]
    buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
    views = PK.pack_views(buf.numpy(), layout)
    dispatches = [([envs[0].reset(), envs[1].reset()], (0, 1), (0, 0), (0, 0))]
    dispatches.append(([envs[0].step(ENV.TURN_LEFT), envs[2].reset()], (0, 2), (1, 0), (0, 1)))
    for obs, seeds, steps_, reset in dispatches:
        for j, o in enumerate(obs):
            views["depth"][j], views["rgb"][j] = o["depth"], o["rgb"]
            views["heading"][j], views["xy"][j] = o["heading"], o["robot_xy"]
        views["seeds"][:], views["steps"][:], views["reset"][:] = seeds, steps_, reset
        outs = {}
        for d, step in steps.items():
            out, states[d] = step(states[d], None, buf)
            outs[d] = out.cpu()
        assert torch.equal(outs[dev][:, :2], outs["cpu"][:, :2])
        torch.testing.assert_close(outs[dev][:, 2:], outs["cpu"][:, 2:], atol=1e-5, rtol=0)
    assert torch.equal(states[dev].objmap.cursor.cpu(), states["cpu"].objmap.cursor)


def test_bc_loss_backward_card_matches_cpu(dev):
    """One behaviour-cloning batch (B=2, T=6, 48x64 depth) through
    ``bc_loss_fn`` and its backward on the card, against the CPU from the
    same weights, under ``exact_f32`` as training runs it: the loss to
    1e-5 relative, each gradient to 1e-4 relative plus 1e-5 of its
    tensor's largest entry."""
    from vlfm_tpu_torch.models.precision import exact_f32
    from vlfm_tpu_torch.runner import imitation as IM

    data = IM.collect_pointnav_rollouts(2, seed=3, env_cfg=ENV.EnvConfig(width=64, height=48, max_steps=30),
                                        depth_shape=(48, 64), max_steps=6, device="cpu")
    cpu = PN.PointNavPolicy.init_random(0, depth_shape=(48, 64), device="cpu")
    gpu = PN.PointNavPolicy(copy.deepcopy(cpu.module).to(dev))
    out = []
    for policy, d in ((cpu, torch.device("cpu")), (gpu, dev)):
        batch = [torch.from_numpy(data[k]).to(d) for k in ("depth", "goal", "action", "valid")]
        with exact_f32(d):
            loss, acc = IM.bc_loss_fn(policy, *batch)
            loss.backward()
        out.append((float(loss.detach()), float(acc), {n: p.grad.cpu() for n, p in policy.module.named_parameters()}))
    (lc, ac, gc), (lg, ag, gg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc) and ag == ac
    for name, want in gc.items():
        scale = float(want.abs().max())
        torch.testing.assert_close(gg[name], want, rtol=1e-4, atol=1e-5 * scale, msg=name)


def _open_space_robot():
    """A FakeRobot with a constant 3 m depth (tests/test_torch_reality.py's)."""
    from vlfm_tpu_torch.reality.robots import FakeRobot

    class OpenSpaceRobot(FakeRobot):
        def get_camera_data(self, camera_ids):
            out = super().get_camera_data(camera_ids)
            for cid, cam in out.items():
                if "depth" in cid:
                    cam.image = np.full_like(cam.image, 3000)
            return out

    return OpenSpaceRobot()


def _reality_hooks():
    """Seeded cosines, a centred detection on two frames after the arm's
    start and a constant inferred depth (tests/test_torch_reality.py's)."""
    from vlfm_tpu_torch.policy.reality import NUM_INIT_YAWS

    rng, calls = np.random.default_rng(0), {"n": 0}

    def detect(rgb):
        calls["n"] += 1
        h, w = rgb.shape[:2]
        masks, valid = np.zeros((8, h, w), bool), np.zeros(8, bool)
        if calls["n"] in (NUM_INIT_YAWS + 1, NUM_INIT_YAWS + 2):
            masks[0, h // 3: 2 * h // 3, w // 3: 2 * w // 3], valid[0] = True, True
        return masks, valid

    return dict(score_fn=lambda rgb: rng.uniform(0, 1, 1).astype(np.float32), detect_fn=detect,
                infer_depth_fn=lambda rgb, mn, mx: np.full(rgb.shape[:2], 0.4, np.float32))


@pytest.mark.parametrize("controller", ["greedy", "neural"])
def test_reality_step_card_matches_cpu(dev, controller):
    """The robot path at the CPU tests' size (a 256 px map, Spot's
    cameras), NUM_INIT_YAWS + 12 steps on the card and on the CPU from the
    same observations and hook outputs: arm_yaw and stop exactly, angular,
    linear, rho and theta within 1e-4 (PointNav's tolerance card against
    CPU), the grids within the cone-edge allowance, the same frontiers,
    the object map's slots."""
    from vlfm_tpu_torch.policy import reality as R
    from vlfm_tpu_torch.reality.envs import ObjectNavEnv, RealityEnvConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TCONFIG.VLFMConfig(max_frontiers=16, max_frontier_cells=256, object_map_slots=8,
                             object_map_points_per_slot=128)
    spec = GridSpec2D(256, 20, 160)
    cpu_pn = PN.PointNavPolicy.init_random(0, discrete=False, device="cpu") if controller == "neural" else "greedy"
    gpu_pn = PN.PointNavPolicy(copy.deepcopy(cpu_pn.module).to(dev)) if controller == "neural" else "greedy"
    policies = {"cpu": R.RealityITMPolicyV2(spec, cfg, pointnav=cpu_pn, device="cpu", **_reality_hooks()),
                dev: R.RealityITMPolicyV2(spec, cfg, pointnav=gpu_pn, device=dev, **_reality_hooks())}
    env = ObjectNavEnv(_open_space_robot(), RealityEnvConfig(all_cams_until_step=10))
    obs = env.reset("toilet")
    for _ in range(R.NUM_INIT_YAWS + 12):
        want, got = policies["cpu"].get_action(obs), policies[dev].get_action(obs)
        assert got["arm_yaw"] == want["arm_yaw"] and got["stop"] == want["stop"]
        np.testing.assert_allclose([got["angular"], got["linear"], *got["rho_theta"]],
                                   [want["angular"], want["linear"], *want["rho_theta"]], atol=1e-4, rtol=0)
        obs = env.step(want)
    got, want = policies[dev].state, policies["cpu"].state
    cells = 1e-3 * (R.NUM_INIT_YAWS + 12) * 6 * 288 * 288
    for name in ("obstacles", "navigable", "explored"):
        assert int((getattr(got.obstacle, name).cpu() != getattr(want.obstacle, name)).sum()) <= cells, name
    assert torch.equal(got.obstacle.frontiers_valid.cpu(), want.obstacle.frontiers_valid)
    torch.testing.assert_close(got.obstacle.frontiers_xy.cpu(), want.obstacle.frontiers_xy, atol=0.1, rtol=0)
    for name in ("slot_used", "cursor", "has_last_target"):
        assert torch.equal(getattr(got.objmap, name).cpu(), getattr(want.objmap, name)), name
    assert bool(want.objmap.slot_used.any())


def test_checkpoint_round_trips_a_cuda_state(dev, tmp_path):
    """A robot state on the card saved and restored: bit for bit, each
    tensor on the device and with the dtype of ``like``."""
    from vlfm_tpu_torch.policy import reality as R
    from vlfm_tpu_torch.runner.checkpoint import map_tensors, restore_pytree, save_pytree

    cfg = TCONFIG.VLFMConfig(max_frontiers=16, object_map_slots=8, object_map_points_per_slot=128)
    spec = GridSpec2D(256, 20, 160)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fill(t):
        if t.dtype == torch.bool:
            return torch.rand(t.shape, generator=gen, device=dev) < 0.5
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen, device=dev)
        return torch.randint(0, 1 << 30, t.shape, generator=gen, device=dev).to(t.dtype)

    state = map_tensors(fill, R.create_state(spec, cfg, device=dev))
    path = save_pytree(str(tmp_path / "robot.pt"), {"state": state, "rng": T.PRNGKey(7, device=dev)})
    got = restore_pytree(path, {"state": R.create_state(spec, cfg, device=dev), "rng": T.PRNGKey(0, device=dev)})
    flat_got, flat_want = [], []
    map_tensors(flat_got.append, got["state"])
    map_tensors(flat_want.append, state)
    assert all(g.is_cuda and g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(flat_got, flat_want))
    assert torch.equal(got["rng"], T.PRNGKey(7, device=dev))
    on_cpu = restore_pytree(path, {"state": R.create_state(spec, cfg, device="cpu"), "rng": T.PRNGKey(0, device="cpu")})
    assert torch.equal(on_cpu["state"].value.values, state.value.values.cpu())


@pytest.mark.parametrize("name", ["gumbel", "normal", "uniform"])
def test_threefry_draws_on_the_card_equal_the_cpus_bits(dev, name):
    """The restated XLA log / erf_inv are IEEE operations one by one, so
    the card draws the CPU's bits (and so jax's)."""
    for seed in (0, 7, 2**31 - 1):
        for shape in ((8, 4), (1000,), (3, 5, 7)):
            fn = (lambda k, s: T.uniform(k, s, -2.5, 3.7)) if name == "uniform" else getattr(T, name)
            got = fn(T.PRNGKey(seed, device=dev), shape).cpu()
            want = fn(T.PRNGKey(seed, device="cpu"), shape)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (seed, shape)


@pytest.mark.parametrize("multimask", [False, True])
def test_tiny_vitdet_sam_card_matches_cpu(dev, multimask):
    cpu = SAM.init_random(SamConfig.tiny(), seed=0, device="cpu")
    gpu = SAM(cpu.cfg, copy.deepcopy(cpu.module).to(dev))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32))
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7]], [[0.3, 0.2, 0.9, 0.9]], [[0.0, 0.0, 1.0, 1.0]]])
    emb_c, emb_g = cpu.encode(imgs), gpu.encode(imgs.to(dev)).cpu()
    assert float((emb_g - emb_c).abs().max()) <= 1e-4 * float(emb_c.abs().max())
    with torch.no_grad():
        lc, ic = cpu.module.decode_boxes(emb_c, boxes)
    mc, _ = cpu.segment_boxes(imgs, boxes, multimask)
    mg, ig = gpu.segment_boxes(imgs.to(dev), boxes.to(dev), multimask)
    assert float((ig.cpu() - ic).abs().max()) <= 1e-4
    best = torch.argmax(ic[..., 1:], -1) + 1 if multimask else torch.zeros_like(ic[..., 0], dtype=torch.long)
    sel = torch.take_along_dim(lc, best[..., None, None, None], dim=2)[:, :, 0]
    far = sel.abs() > 1e-3 * float(lc.abs().max())
    assert torch.equal(mg.cpu()[far], mc[far])


@pytest.mark.parametrize("use_vqa", [False, True], ids=["dispatch", "with-veto"])
def test_every_sync_of_a_dispatch_lies_in_a_wait_span(dev, use_vqa):
    """A tiny packed fused dispatch on the card (2 lanes, SAM gated at one
    frame a pass; with the veto, tiny BLIP2VQA gated at 2 slots) under
    ``set_sync_debug_mode("warn")`` with the program's tracing on: every
    synchronising call inside ``vlfm.dispatch`` falls inside a
    ``vlfm.wait.*`` span, and there is one per wait span."""
    import time
    import traceback
    import warnings

    from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VQAConfig
    from vlfm_tpu_torch.utils import profiling as P

    h, w = 48, 64
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=h, width=w), max_frontiers=16,
                             max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                             max_detections_per_frame=4, sam_frame_capacity=1, use_vqa=use_vqa, vqa_slot_capacity=2)
    spec = GridSpec2D(512, 20, 160)
    layout = PK.build_layout([("depth", "float32", (2, h, w)), ("rgb", "uint8", (2, h, w, 3)),
                              ("heading", "float32", (2,)), ("xy", "float32", (2, 2)), ("seeds", "int32", (2,)),
                              ("steps", "int32", (2,)), ("reset", "uint8", (2,))])
    vqa = BLIP2VQA.init_random(BLIP2VQAConfig.tiny(), seed=0, device=dev) if use_vqa else None
    stack = FullStackPerception(cfg, blip2_vqa=vqa, device=dev)
    step = stack.make_fused_step("greedy", spec, cfg, "toilet", layout=layout)
    state = ITM.create_state(spec, cfg, batch=2, device=dev)
    env = ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=0), ENV.EnvConfig(width=w, height=h))
    buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
    views = PK.pack_views(buf.numpy(), layout)
    obs = env.reset()
    for j in range(2):
        views["depth"][j], views["rgb"][j] = obs["depth"], obs["rgb"]
        views["heading"][j], views["xy"][j] = obs["heading"], obs["robot_xy"]
    views["seeds"][:], views["steps"][:], views["reset"][:] = (0, 1), (0, 0), (0, 0)
    out, state = step(state, None, buf)  # first use: kernels loaded, texts encoded
    out.cpu()
    syncs = []

    def show(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            site = [f"{f.filename.rpartition('/')[2]}:{f.lineno}" for f in traceback.extract_stack()
                    if "vlfm_tpu_torch" in f.filename][-2:]
            syncs.append((time.time_ns(), " < ".join(site)))

    P.reset_spans()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with P.tracing():
                for k in range(2):
                    views["steps"][:] = k + 1
                    out, state = step(state, None, buf)
                    out.cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    recs = P.spans()
    roots = [r for r in recs if r.name == "vlfm.dispatch"]
    assert len(roots) == 2

    def within(t, spans):
        return any(s.start_ns <= t <= s.end_ns for s in spans)

    waits = [r for r in recs if r.name.startswith("vlfm.wait.") and within(r.start_ns, roots)]
    inside = [(t, site) for t, site in syncs if within(t, roots)]
    assert inside, "no sync inside the dispatch"
    assert [site for t, site in inside if not within(t, waits)] == []
    assert len(inside) == len(waits)
    # the flood and the labelling converge on the card (csrc/sweeps.cu): no wait of theirs
    assert {r.name for r in waits} >= {"vlfm.wait.sam_gate"}
    assert not {r.name for r in waits} & {"vlfm.wait.flood", "vlfm.wait.label"}
    if use_vqa:
        assert "vlfm.veto" in {r.name for r in recs}


# --- the sweep kernels (csrc/sweeps.cu) and the graphed policy step -------------

def _lane_sweeps(step, cur, cap):
    """Sweeps one lane runs from ``cur`` under ``step``: one more than the
    sweeps that changed it, at most ``cap``."""
    n = 0
    while n < cap:
        nxt = step(cur)
        n += 1
        if torch.equal(nxt, cur):
            break
        cur = nxt
    return n


def _flood_lanes(lanes, size, rng):
    """(lanes, size, size) bool masks and seeds: a serpentine corridor
    longer than the cap (lane 0), rooms of scattered walls of different
    sizes, each seeded inside (they converge at different sweeps), and a
    seed outside its mask (the last lane: nothing to flood)."""
    mask = np.zeros((lanes, size, size), bool)
    seed = np.zeros_like(mask)
    mask[0, 2:-2:4, 2:-2] = True
    for k, r in enumerate(range(2, size - 6, 4)):
        mask[0, r:r + 5, (size - 4) if k % 2 == 0 else 2] = True
    seed[0, 2, 2] = True
    for lane in range(1, lanes):
        n = int(rng.integers(20, 180))
        r, c = rng.integers(0, size - n, 2)
        mask[lane, r:r + n, c:c + n] = rng.random((n, n)) < 0.8
        seed[lane, r + n // 2, c + n // 2] = True
    if lanes > 1:
        seed[-1] &= ~mask[-1]
    return torch.from_numpy(mask), torch.from_numpy(seed)


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("words", [False, True], ids=["bool", "words"])
def test_flood_kernel_equals_the_plain_loop_bit_for_bit(dev, lanes, words):
    """At the obstacle map's 1344 x 1344 (a multiple of 32, so the flood
    rolls round the grid's edges): the kernel's flood equals the plain
    loop's, run on the bool masks or (``words``) as the bit-packed loop on
    their words; the device's ``map.sweeps`` is the most sweeps any lane ran
    (one more than its sweeps that changed it, at most max_iters rounded up
    to a check), never above the plain loop's count; one launch, counted on
    the device, and no host read."""
    from vlfm_tpu_torch.ops import bitpack as BP
    from vlfm_tpu_torch.ops import flood as FL

    mask, seed = _flood_lanes(lanes, 1344, np.random.default_rng(lanes))
    max_iters, check = 200, 16
    cap = FL.sweep_cap(max_iters, check)
    mp, sp = BP.pack_cols(mask), BP.pack_cols(seed)
    reset_counters()
    if words:
        want = BP.unpack_cols(BP.flood_packed(mp, sp, max_iters, check), 1344)
    else:
        want = FL.flood_from_seed(mask, seed, max_iters, check)
    plain_sweeps = counted("map.sweeps")
    m_d, s_d = mask.to(dev), seed.to(dev)
    FL.flood_from_seed(m_d, s_d, max_iters, check)  # first launch: the library and the counters made
    torch.cuda.synchronize()
    reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = FL.flood_from_seed(m_d, s_d, max_iters, check)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.cpu(), want)
    ran = [_lane_sweeps(lambda c, m=mp[i]: BP.dilate8_packed(c) & m, sp[i] & mp[i], cap) for i in range(lanes)]
    assert ran[0] == cap  # the corridor is longer than the cap
    if lanes > 1:
        assert ran[-1] == 1 and len(set(ran)) > 2
    assert counted("flood.launches") == 1
    assert counted("map.sweeps") == max(ran) <= plain_sweeps


def test_flood_kernel_on_unaligned_widths_keeps_the_grids_edges(dev):
    """A width that is not a multiple of 32 floods as the unpacked loop
    does: nothing rolls round the edges."""
    from vlfm_tpu_torch.ops import flood as FL

    rng = np.random.default_rng(3)
    for shape in ((3, 100, 77), (2, 5, 33), (1, 64, 31)):
        mask = torch.from_numpy(rng.random(shape) < 0.7)
        seed = torch.zeros_like(mask)
        seed[:, 0, 0] = seed[:, -1, -1] = True
        want = FL.flood_from_seed(mask, seed, max_iters=64)
        assert torch.equal(FL.flood_from_seed(mask.to(dev), seed.to(dev), max_iters=64).cpu(), want), shape


def test_labelling_kernel_equals_the_plain_loop_bit_for_bit(dev):
    """At the coarse frontier grid (8, 336, 336) and max_iters 48: lanes of
    percolating clusters stop at the cap, small blobs converge early, an
    empty lane after one sweep; labels bit for bit, the device's sweeps the
    lanes' most."""
    from vlfm_tpu_torch.ops import flood as FL

    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random((8, 336, 336)) < 0.6)
    mask[1:4] = torch.from_numpy(rng.random((3, 336, 336)) < 0.2)
    mask[7] = False
    reset_counters()
    want = FL.label_components(mask, 48)
    plain_sweeps = counted("map.sweeps")
    m_d = mask.to(dev)
    FL.label_components(m_d, 48)
    torch.cuda.synchronize()
    reset_counters()
    got = FL.label_components(m_d, 48)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    big = torch.iinfo(torch.int32).max

    def sweep(lab, m):
        return torch.where(m, torch.minimum(lab, FL._min_label_step(lab[None])[0]), big)

    idx = torch.arange(336 * 336, dtype=torch.int32).reshape(336, 336)
    ran = [_lane_sweeps(lambda c, m=mask[i]: sweep(c, m), torch.where(mask[i], idx, big), 48) for i in range(8)]
    assert ran[0] == 48 and ran[7] == 1 and min(ran[1:4]) < 48
    assert counted("label.launches") == 1
    assert counted("map.sweeps") == max(ran) == 48 <= plain_sweeps


def test_sweep_kernels_refuse_a_plan_they_do_not_share(dev):
    from vlfm_tpu_torch.ops import flood as FL

    m = torch.zeros((1, 64, 64), dtype=torch.bool, device=dev)
    out = torch.empty_like(m)
    lib, raw_stream = FL._library()
    counts = FL._counts(dev, "flood.launches")
    rows_per, smem = FL.sweep_plan(64, 8, 3)
    args = (m.data_ptr(), m.data_ptr(), out.data_ptr(), 1, 1, 64, 64, 16)
    assert lib.vlfm_flood(*args, rows_per, smem + 4, *counts, raw_stream(0)) != 0
    assert lib.vlfm_flood(*args, rows_per + 1, smem, *counts, raw_stream(0)) != 0
    assert lib.vlfm_flood(*args, rows_per, smem, *counts, raw_stream(0)) == 0
    with pytest.raises(TypeError):
        FL.label_components(m.to(torch.uint8), 8)
    with pytest.raises(ValueError):
        FL.flood_from_seed(m, m.cpu())


def _tiny_policy(dev, lanes=2):
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=48, width=64), max_frontiers=16,
                             max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                             max_detections_per_frame=4)
    spec = GridSpec2D(512, 20, 160)
    envs = [ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=s), ENV.EnvConfig(width=64, height=48))
            for s in range(lanes)]
    return cfg, spec, envs


def _policy_step(cfg, spec):
    from vlfm_tpu_torch.runner.full_stack import write_into

    def run(state, inputs):
        reset, obs, cos, masks, valid, keys = inputs[0], ITM.Observation(*inputs[1:5]), *inputs[5:]
        new = ITM.reset_lanes(state, reset)
        action, info, new = ITM.step(new, obs, cos, masks, valid, keys, pointnav="greedy", spec=spec, cfg=cfg)
        write_into(state, new)
        return action, info
    return run


def _policy_inputs(envs, cfg, dev, k, reset):
    from vlfm_tpu_torch.runner.episode_driver import observation, step_keys

    obs = [e.reset() if k == 0 or reset else e.step(ENV.TURN_LEFT) for e in envs]
    b = len(envs)
    depth = torch.from_numpy(np.stack([o["depth"] for o in obs])).to(dev)
    xy = torch.from_numpy(np.stack([o["robot_xy"] for o in obs]).astype(np.float32)).to(dev)
    heading = torch.tensor([o["heading"] for o in obs], dtype=torch.float32, device=dev)
    o = observation(depth, xy, heading, cfg)
    keys = step_keys(torch.arange(b, device=dev), torch.full((b,), k, device=dev))
    masks = torch.zeros((b, cfg.max_detections_per_frame, 48, 64), dtype=torch.bool, device=dev)
    masks[:, 0, 20:30, 30:40] = True
    valid = torch.zeros((b, cfg.max_detections_per_frame), dtype=torch.bool, device=dev)
    valid[:, 0] = k % 3 == 2
    cos = torch.full((b, cfg.value_channels), 0.1 + 0.01 * k, device=dev)
    return (torch.tensor([reset] * b, device=dev), *o, cos, masks, valid, keys)


def test_step_graphs_capture_per_state_and_never_replay_a_dead_one(dev):
    """The first call is eager, the next on the same state captures, then
    replays: each result equals the eager step on a twin state, bit for bit.
    A new state captures anew; the first state's capture still replays; once
    it died it is dropped and never replayed. A replay makes no host sync."""
    import gc

    from vlfm_tpu_torch.runner.full_stack import StepGraphs

    cfg, spec, envs = _tiny_policy(dev)
    run = _policy_step(cfg, spec)
    graphs = StepGraphs(run)
    state, twin = (ITM.create_state(spec, cfg, batch=2, device=dev) for _ in range(2))

    def both(state, twin, k, reset=False):
        inputs = _policy_inputs(envs, cfg, dev, k, reset)
        got = graphs(state, inputs)
        want = run(twin, inputs)
        assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        flat = lambda s: [t for f in s for t in (f if isinstance(f, tuple) else (f,))]  # noqa: E731
        assert all(torch.equal(a, b) for a, b in zip(flat(state), flat(twin)))

    reset_counters()
    for k in range(4):
        both(state, twin, k, reset=k == 2)
    assert (counted("step.eager"), counted("step.graph_captures"), counted("step.graph_replays")) == (1, 1, 2)
    # the kernels count on the device: each of the 4 calls ran them once (a capture by its replay), as did the twin
    assert counted("flood.launches") == counted("label.launches") == 8
    inputs = _policy_inputs(envs, cfg, dev, 4, False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphs(state, inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    run(twin, inputs)
    other, other_twin = (ITM.create_state(spec, cfg, batch=2, device=dev) for _ in range(2))
    both(other, other_twin, 5, reset=True)
    assert counted("step.graph_captures") == 2 and len(graphs.graphs) == 2
    both(state, twin, 6)
    assert counted("step.graph_replays") == 4
    del state
    gc.collect()
    fresh, fresh_twin = (ITM.create_state(spec, cfg, batch=2, device=dev) for _ in range(2))
    both(fresh, fresh_twin, 7, reset=True)
    assert counted("step.graph_captures") == 3 and counted("step.graph_replays") == 4
    assert len(graphs.graphs) == 2 and all(g.alive() for g in graphs.graphs)


def _bench_stack(dev, lanes):
    """The benchmark's HM3D configuration at full width (random weights from
    seed 7), its replay pool and a dispatch layout of ``lanes``."""
    import json
    from pathlib import Path

    from benchmark import stack, traffic
    from benchmark.drivers.dispatch import _layout

    root = Path(__file__).resolve().parent.parent
    config = json.loads((root / "benchmark/configs/vlfm-hm3d.json").read_text())
    mix = json.loads((root / f"benchmark/workloads/replay-b{lanes}.json").read_text())
    cfg, spec = stack.vlfm_config(config, "program")
    models = {role: stack.build_model(s, role, 7, "program", dev) for role, s in config["models"].items()}
    perception = FullStackPerception(cfg, itm=models["itm"], detector=models["detector"], sam=models["sam"],
                                     det_threshold=cfg.non_coco_threshold, device=dev)
    layout = _layout(PK, lanes, cfg.camera.height, cfg.camera.width)
    return cfg, spec, models["pointnav"], perception, layout, mix, traffic.replay_pool(mix, 7), traffic


@pytest.mark.parametrize("lanes", [1, 8])
def test_graphed_dispatch_equals_the_eager_step_at_the_cells_shapes(dev, lanes):
    """24 decisions of the benchmark's replay pool with its staggered lane
    resets: the packed fused dispatch (eager, then a capture, then 22
    replays) against perception and ``itm.step`` called eagerly on a twin
    state: the same outputs and every state leaf bit for bit at every
    decision, and a peak of allocated memory within 1 %."""
    from vlfm_tpu_torch.runner.episode_driver import observation, pack_outputs, step_keys
    from vlfm_tpu_torch.runner.full_stack import on_dispatch_stream

    cfg, spec, pointnav, perception, layout, mix, pool, traffic = _bench_stack(dev, lanes)
    h, w = cfg.camera.height, cfg.camera.width
    buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
    views = PK.pack_views(buf.numpy(), layout)
    flat = lambda s: [t for f in s for t in (f if isinstance(f, tuple) else (f,))]  # noqa: E731

    def decisions(one):
        sched = traffic.LaneSchedule(lanes, len(pool), mix["steps"], mix["stagger"])
        state = ITM.create_state(spec, cfg, batch=lanes, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(24):
            for lane, (e, f, r) in enumerate(sched.current()):
                ep = pool[e]
                views["depth"][lane], views["rgb"][lane] = ep["depth"][f], ep["rgb"][f]
                views["heading"][lane], views["xy"][lane] = ep["heading"][f], ep["xy"][f]
                views["seeds"][lane], views["steps"][lane], views["reset"][lane] = ep["seed"], f, r
            out, state = one(state)
            yield out.cpu(), [t.cpu() for t in flat(state)]
            sched.advance()
        yield torch.cuda.max_memory_allocated()

    def eager(state):
        f = PK.unpack_device(layout, buf.to(dev))
        cos, masks, valid = perception._perceive(f["rgb"], "toilet", (h, w))
        state = ITM.reset_lanes(state, f["reset"].to(torch.bool))
        action, info, state = ITM.step(state, observation(f["depth"], f["xy"], f["heading"], cfg),
                                       cos[:, : cfg.value_channels], masks, valid, step_keys(f["seeds"], f["steps"]),
                                       pointnav=pointnav, spec=spec, cfg=cfg)
        return pack_outputs(action, info), state

    def eager_on_the_dispatch_stream(state):  # one stream, so one cuBLAS workspace, as the dispatch has
        with on_dispatch_stream(dev):
            return eager(state)

    step = perception.make_fused_step(pointnav, spec, cfg, "toilet", layout=layout)
    want = list(decisions(eager_on_the_dispatch_stream))
    reset_counters()
    got = list(decisions(lambda s: step(s, None, buf)))
    for k, ((out_g, state_g), (out_e, state_e)) in enumerate(zip(got[:-1], want[:-1])):
        assert torch.equal(out_g, out_e), k
        assert all(torch.equal(a, b) for a, b in zip(state_g, state_e)), k
    assert (counted("step.eager"), counted("step.graph_captures"), counted("step.graph_replays")) == (1, 1, 22)
    assert counted("flood.launches") == counted("label.launches") == 24
    assert abs(got[-1] - want[-1]) <= 0.01 * want[-1], (got[-1], want[-1])
