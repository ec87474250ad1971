"""Fused stride-1 MBConv chain: the CUDA kernel and its plain version.

Counterpart of ``vlfm_tpu/ops/conv_fused.py`` (the Pallas TPU kernel
``_chain_kernel`` and its ``mbconv_chain`` wrapper):

    gelu(x . W1 + b1) -> depthwise 3x3 stride 1 SAME (+b2) -> gelu
      -> . W3 + b3 [+ x] [-> gelu]

on NHWC tensors, with the hidden tensors kept on chip. The kernel itself is
``vlfm_tpu_torch/csrc/mbconv_chain.cu``, built by ``kernels/build.py`` at its
first launch. Layouts are the JAX package's: w1 (Cin, Ch), w2 (3, 3, Ch), w3
(Ch, Cout); x, w1, w2 and w3 share the activation dtype and the biases are
f32.

Two TPU workarounds of the JAX module are not carried over: ``gelu_poly``
(every GELU here is the exact erf form) and the space-to-depth rewrites of
the stride-2 stages, which are plain strided ``F.conv2d`` calls in
``models/tinyvit.py``.

``mbconv_chain`` routes by the device of its input: a CPU tensor goes to
``mbconv_chain_ref``; a CUDA tensor goes to the kernel, or the call raises.
There is no fallback from the kernel to the plain version. ``chain_plan``
chooses the kernel's body (and with it the output tile), grid and shared
memory from the shapes, dtype and pointers alone; the kernel refuses a plan whose shared-memory
figure differs from its own.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's geometry (vlfm_tpu_torch/csrc/mbconv_chain.cu).
_BODY_CODES = {"simt": 0, "tensor-core 16x16": 1, "tensor-core 4x16": 2}
_TILE_W = 16  # output columns of a tensor-core tile
_CHUNK = 64  # hidden channels per pass of the tensor-core body
_SIMT_CHUNK, _SIMT_TILE = 32, 8
_MAX_SMEM = 232448  # a block's shared-memory limit on an H100


def mbconv_chain_ref(
    x: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    *,
    residual: bool = False,
    final_gelu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch chain with the Pallas kernel's roundings: each 1x1
    product and the depthwise conv sum in f32; h and d are rounded to x's
    dtype after their GELU, the output once at the end."""
    dt = x.dtype
    f32 = torch.float32
    h = F.gelu(torch.matmul(x.to(f32), w1.to(f32)) + b1.to(f32)).to(dt)
    ch = h.shape[-1]
    d = F.conv2d(
        h.to(f32).permute(0, 3, 1, 2), w2.to(f32).permute(2, 0, 1).unsqueeze(1), b2.to(f32),
        padding=1, groups=ch,
    )
    d = F.gelu(d.permute(0, 2, 3, 1)).to(dt)
    out = torch.matmul(d.to(f32), w3.to(f32)) + b3.to(f32)
    if residual:
        out = out + x.to(f32)
    if final_gelu:
        out = F.gelu(out)
    return out.to(dt)


def chain_tolerance(want: torch.Tensor) -> torch.Tensor:
    """What the kernel's output may differ from ``mbconv_chain_ref``'s by,
    per element.

    f32: 1e-5 relative, at least 1e-5 absolute. The two sum Cin and Ch
    products in other orders; nothing is rounded in between.

    bf16: 2 bf16 ulps of the plain value (8 significand bits), at least
    4e-3. The tensor cores and cuBLAS sum the 1x1 products in other orders,
    so an f32 sum that lies within an f32 ulp of a bf16 rounding boundary
    rounds h (or d) the other way in one of the two (4e-4 to 2e-3 of the
    outputs differ at all on the card). A flipped d moves an output by
    |w3| times a bf16 ulp of d, ~7e-4 at TinyViT's widths with lecun-scaled
    weights, and the output's own rounding adds an ulp: 2 ulps covers a
    value of order 1, and the floor covers ~5 flips in a sum that cancels
    to near 0 (measured worst on an H100: 1.95e-3 there).
    """
    mag = want.abs().to(torch.float32)
    if want.dtype == torch.float32:
        return 1e-5 * mag.clamp_min(1.0)
    e = torch.floor(torch.log2(mag.clamp_min(2.0**-126)))
    return torch.exp2(e - 6).clamp_min(4e-3)


def _check_cuda_args(x, w1, b1, w2, b2, w3, b3, residual: bool) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"mbconv_chain kernel takes float32 or bfloat16 input, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"mbconv_chain takes NHWC input, got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w1.ndim != 2 or w1.shape[0] != cin:
        raise ValueError(f"w1 must be (Cin={cin}, Ch), got {tuple(w1.shape)}")
    ch = w1.shape[1]
    if w3.ndim != 2 or w3.shape[0] != ch:
        raise ValueError(f"w3 must be (Ch={ch}, Cout), got {tuple(w3.shape)}")
    cout = w3.shape[1]
    shapes = {"w2": (w2, (3, 3, ch)), "b1": (b1, (ch,)), "b2": (b2, (ch,)), "b3": (b3, (cout,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if residual and cout != cin:
        raise ValueError(f"residual needs Cout == Cin, got {cout} and {cin}")
    named = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"mbconv_chain kernel needs a contiguous {name}")
        want = torch.float32 if name.startswith("b") else x.dtype
        if t.dtype != want:
            raise TypeError(f"mbconv_chain kernel needs {want} {name}, got {t.dtype}")


def _args(x, w1, b1, w2, b2, w3, b3, out):
    return [t.data_ptr() for t in (x, w1, b1, w2, b2, w3, b3, out)]


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How the kernel runs one call: its body ("tensor-core 16x16" or
    "tensor-core 4x16", after a block's output tile of rows x columns, or
    "simt" on 8 x 8 tiles), the grid (column tiles, row tiles, batch) and
    the dynamic shared memory of a block."""

    body: str
    grid: tuple[int, int, int]
    smem_bytes: int


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _tc_smem(rows: int, cin: int, cout: int) -> int:
    """The tensor-core body's shared memory (csrc/mbconv_chain.cu:TcSmem):
    the x halo tile, two h tiles, two slots each of the W1 slice, the W3
    slice, w2, b1 and b2. Every bf16 row is padded by 8 elements."""
    mh = -(-((rows + 2) * (_TILE_W + 2)) // 16) * 16  # halo pixels, padded to 16 rows
    ldc = _CHUNK + 8
    regions = (2 * mh * (cin + 8), 2 * 2 * mh * ldc, 2 * 2 * cin * ldc, 2 * 2 * _CHUNK * (cout + 8),
               2 * 2 * 9 * _CHUNK, 4 * 2 * _CHUNK, 4 * 2 * _CHUNK)
    off = 0
    for n in regions:
        off = _align128(off + n)
    return off


def chain_plan(x, w1, b1, w2, b2, w3, out) -> ChainPlan:
    """The kernel's launch plan for these tensors (on any device), from their
    shapes, dtype and pointers alone. bf16 with Cin a multiple of 16, Ch of
    64 and 16-byte aligned pointers takes the tensor cores: 16 x 16 output
    tiles for Cout up to 64 (a multiple of 16), 4 x 16 tiles for a wider
    Cout up to 320 (a multiple of 32). Everything else takes the CUDA-core
    body on 8 x 8 tiles."""
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w3.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w1, b1, w2, b2, w3, out))
    if x.dtype == torch.bfloat16 and aligned and cin % 16 == 0 and ch % _CHUNK == 0:
        rows = 16 if cout % 16 == 0 and cout <= 64 else 4 if cout % 32 == 0 and cout <= 320 else 0
        if rows and _tc_smem(rows, cin, cout) <= _MAX_SMEM:
            return ChainPlan(f"tensor-core {rows}x{_TILE_W}", (-(-w // _TILE_W), -(-h // rows), b),
                             _tc_smem(rows, cin, cout))
    halo = (_SIMT_TILE + 2) ** 2
    smem = 4 * (halo * cin + halo * _SIMT_CHUNK + _SIMT_TILE**2 * (_SIMT_CHUNK + cout))
    if smem > _MAX_SMEM:
        raise ValueError(f"mbconv_chain kernel: Cin={cin}, Cout={cout} need {smem} bytes of shared memory")
    return ChainPlan("simt", (-(-w // _SIMT_TILE), -(-h // _SIMT_TILE), b), smem)


def mbconv_chain(
    x: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    *,
    residual: bool = False,
    final_gelu: bool = False,
) -> torch.Tensor:
    """x (B, H, W, Cin) -> (B, H, W, Cout), fused.

    CPU tensors take ``mbconv_chain_ref``. CUDA tensors launch the kernel on
    the current stream; ``mbconv_chain.launches`` counts those launches.
    """
    if x.device.type == "cpu":
        return mbconv_chain_ref(x, w1, b1, w2, b2, w3, b3, residual=residual, final_gelu=final_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_chain runs on CPU or CUDA tensors, got {x.device}")
    from vlfm_tpu_torch.kernels.build import load_library

    lib = load_library()
    _check_cuda_args(x, w1, b1, w2, b2, w3, b3, residual)
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w3.shape[1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = chain_plan(x, w1, b1, w2, b2, w3, out)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.vlfm_mbconv_chain(
        *_args(x, w1, b1, w2, b2, w3, b3, out), b, h, w, cin, ch, cout,
        int(residual), int(final_gelu), _DTYPE_CODES[x.dtype], _BODY_CODES[plan.body], plan.smem_bytes,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"mbconv_chain kernel launch failed: cudaError {err}")
    mbconv_chain.launches += 1
    return out


mbconv_chain.launches = 0

