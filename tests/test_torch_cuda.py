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
from vlfm_tpu_torch.models.layers import FusedQKVAttention, merge_heads
from vlfm_tpu_torch.models.sam import SAM, SamConfig
from vlfm_tpu_torch.ops import attention as A
from vlfm_tpu_torch.ops import deform_gather as DG
from vlfm_tpu_torch.ops.conv_fused import chain_plan, chain_tolerance, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.ops.norms import bf16_tolerance, layer_norm, layer_norm_ref
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as ENV
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
    before, attn_before = layer_norm.launches, A.attention.launches
    got = gpu.cosine_cached_text(imgs.to(dev), feats)
    torch.cuda.synchronize()
    # ViT 2 x 2 + post_ln, Q-Former embed_ln + 2 x 2 + 1 cross_ln.
    assert layer_norm.launches - before == 5 + 6
    assert A.attention.launches - attn_before == 2  # one K3 launch per ViT block
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


def _check_chain(x, w, residual, body):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = mbconv_chain.launches
    got = mbconv_chain(x, *w, residual=residual, final_gelu=residual)
    torch.cuda.synchronize()
    assert mbconv_chain.launches == before + 1
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
    before = A.attention.launches
    got = A.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert A.attention.launches == before + 1
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
    before = A.attention.launches
    got = gpu(x.to(dev))
    assert A.attention.launches == before + 1
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
    before = A.attention.launches
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
    assert A.attention.launches == before


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
                torch.tensor(o["heading"], dtype=torch.float32, device=d))
            depth = torch.from_numpy(o["depth"].astype(np.float32)).to(d)
            state = ITM.update_obstacles(state, spec, cfg, depth, tf, steps)
        states[d] = state
    got, want = states[dev], states["cpu"]
    for name in ("obstacles", "navigable", "explored"):
        assert int((getattr(got, name).cpu() != getattr(want, name)).sum()) <= 1e-3 * 6 * 224 * 224, name
    assert torch.equal(got.frontiers_valid.cpu(), want.frontiers_valid)
    torch.testing.assert_close(got.frontiers_xy.cpu(), want.frontiers_xy, atol=0.1, rtol=0)


def _deform_inputs(b, q, nh, dh, shapes, npts, vdtype, wdtype, dev, spread=1.5, far=0.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, nh * dh, generator=gen, device=dev).to(vdtype)
    grids = (torch.rand(b, q, nh, len(shapes), npts, 2, generator=gen, device=dev) * 2 - 1) * spread
    if far:
        pick = torch.rand(grids.shape, generator=gen, device=dev) < far
        sign = torch.where(torch.rand(grids.shape, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        grids = torch.where(pick, sign * 1e6, grids)
    logits = torch.randn(b, q, nh, len(shapes) * npts, generator=gen, device=dev)
    weights = torch.softmax(logits, -1).reshape(b, q, nh, len(shapes), npts).to(wdtype)
    return value, grids, weights


@pytest.mark.parametrize("b,q,nh,dh,shapes,npts,vdtype,wdtype,far", [
    (2, 1200, 8, 32, ((40, 40), (20, 20), (10, 10), (5, 5)), 4, torch.float32, torch.float32, 0.0),  # encoder-like
    (2, 900, 8, 32, ((40, 40), (20, 20), (10, 10), (5, 5)), 4, torch.bfloat16, torch.float32, 0.05),
    (1, 70, 2, 16, ((7, 9), (4, 5), (2, 3)), 3, torch.float32, torch.float32, 0.2),  # the CPU tests' ragged shape
    (1, 33, 3, 40, ((6, 11),), 2, torch.bfloat16, torch.bfloat16, 0.0),            # dh over one warp
    (1, 5, 1, 128, ((3, 4), (2, 2)), 20, torch.float32, torch.bfloat16, 0.1),       # widest head, 40 samples
])
def test_deform_gather_kernel_matches_plain(dev, b, q, nh, dh, shapes, npts, vdtype, wdtype, far):
    torch.backends.cuda.matmul.allow_tf32 = False
    value, grids, weights = _deform_inputs(b, q, nh, dh, shapes, npts, vdtype, wdtype, dev, far=far)
    before = DG.deform_gather.launches
    got = DG.deform_gather(value, shapes, grids, weights)
    torch.cuda.synchronize()
    assert DG.deform_gather.launches == before + 1
    want = DG.deform_gather_ref(value, shapes, grids, weights)
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, q, nh, dh)
    err = float((got - want).abs().max())
    assert err <= DG.deform_gather_tolerance(value, weights), err
    again = DG.deform_gather(value, shapes, grids, weights)
    assert torch.equal(again, got)  # one warp per output, a fixed order: bit-reproducible


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
    before = DG.deform_gather.launches
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
    assert DG.deform_gather.launches == before


def test_tiny_grounding_dino_card_matches_cpu_and_counts_launches(dev):
    """f32 tiny GroundingDINO on the card (K4 for its four deformable
    attentions) against the same weights on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = GD.GroundingDinoDetector.init_random(GD.GroundingDinoConfig.tiny_test(), seed=0, device="cpu")
    gpu = GD.GroundingDinoDetector(cpu.cfg, copy.deepcopy(cpu.module).to(dev))
    imgs = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(np.float32))
    ids, mask, _ = GD.build_caption_ids([np.array([5, 6]), np.array([7])], 16)
    before = DG.deform_gather.launches
    got_logits, got_boxes = gpu.predict(imgs.to(dev), ids, mask)
    torch.cuda.synchronize()
    assert DG.deform_gather.launches - before == GD.deformable_attentions(cpu.cfg) == 4
    want_logits, want_boxes = cpu.predict(imgs, ids, mask)
    finite = torch.isfinite(want_logits)
    assert torch.equal(torch.isfinite(got_logits.cpu()), finite)
    torch.testing.assert_close(got_logits.cpu()[finite], want_logits[finite], atol=1e-3, rtol=0)
    torch.testing.assert_close(got_boxes.cpu(), want_boxes, atol=1e-4, rtol=0)
