"""Fused attention softmax(QK^T / sqrt(D)) V: the CUDA kernel (K3) and its
plain version.

Counterpart of ``vlfm_tpu/ops/attention.py``. The kernel,
``vlfm_tpu_torch/csrc/attention.cu``, replaces all seven Pallas TPU kernels
that compute this function, each as an instance of one template:

- ``flash_attention_grouped`` (vlfm_tpu/ops/attention.py:55) and
  ``flash_attention`` (:162): row max subtracted, probabilities normalised
  before PV (``clamp=None, normalize="probs"``);
- ``flash_attention_grouped_v2`` (:106): row max subtracted, the (L, D)
  output divided by the row sum (``clamp=None, normalize="output"``);
- the diagnostic kernels ``attn_kt`` and ``attn_phased``
  (scripts/diag_attn3.py:83,134), ``grouped`` (scripts/diag_attn_core.py:59)
  and ``pure_kernel`` (scripts/diag_attn_pure.py:45): clamped logits
  (``clamp=60``), output normalisation, logits rounded to the input dtype
  (``round_logits``, the bf16 scratch of ``attn_phased`` and ``pexp16``),
  K passed transposed (any strides go to the kernel as they are);
- ``vlfm_tpu/models/layers.py:attention_bf16_softmax``, which is plain XLA
  in the JAX package, is the ``clamp=80, normalize="output",
  round_logits=True`` instance.

``pl.reciprocal(approx=True)`` has no counterpart: the kernel takes the
correctly rounded reciprocal of the row sum, and the plain version divides.

``attention`` routes by the device of its input: CPU tensors take
``attention_ref``; CUDA tensors launch the kernel, or the call raises. There
is no fallback from the kernel to the plain version. The kernel reads q, k
and v through their strides, so the ViT's fused qkv projection reaches it
as views (``qkv_views``), and it writes its output in (B, L, H, D) memory
order, so that merging the heads afterwards is a view too.

``attention_plan`` chooses the kernel's body, grid and shared memory from
the shapes, dtypes, strides and pointers alone: bf16 with at most
``WHOLE_HEAD_KEYS`` keys takes the whole-head body (one block per head,
K and V loaded once), longer key axes the streaming body, f32 the CUDA-core
body. The kernel refuses a plan whose shared-memory figure differs from its
own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from vlfm_tpu_torch.utils.profiling import count, span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
NORMALIZE = ("probs", "output")


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    clamp: Optional[float] = None,
    normalize: str = "probs",
    round_logits: bool = False,
) -> torch.Tensor:
    """Plain PyTorch attention over (B, H, L, D), every variant of K3.

    Logits are the f32 product of the inputs times 1/sqrt(D)
    (``round_logits`` rounds them to the input dtype). ``clamp=None``
    subtracts the row max before the exp; ``clamp=c`` takes
    exp(clip(x, -c, c)). ``normalize="probs"`` divides p by its row sum and
    casts it to the input dtype before PV; ``"output"`` casts the
    unnormalised p, takes PV in f32 and divides that by the row sum. The
    result has the input dtype.
    """
    if normalize not in NORMALIZE:
        raise ValueError(f"normalize must be one of {NORMALIZE}, got {normalize!r}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    x = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if round_logits:
        x = x.to(q.dtype).float()
    if clamp is None:
        p = torch.exp(x - x.amax(-1, keepdim=True))
    else:
        p = torch.exp(x.clamp(-clamp, clamp))
    s = p.sum(-1, keepdim=True)
    if normalize == "probs":
        o = torch.matmul((p / s).to(v.dtype).float(), v.float())
    else:
        o = torch.matmul(p.to(v.dtype).float(), v.float()) / s
    return o.to(q.dtype)


def attention_tolerance(want: torch.Tensor, round_logits: bool = False) -> torch.Tensor:
    """What the kernel's output may differ from ``attention_ref``'s by, per
    element. The kernel sums the products in another order than cuBLAS, and
    takes the hardware's exp and a reciprocal where the plain version takes
    ``torch.exp`` and a divide: a few f32 ulps. f32: 2e-5
    (tests/test_attention.py's bound). bf16: two bf16 ulps of the plain
    value (8 significand bits), at least 4e-3, as a probability can round to
    the neighbouring bf16 value. With ``round_logits``, 2e-2
    (tests/test_attention.py's bound for that path): a logit on a bf16
    rounding boundary rounds either way, a step of up to 2^-6 at |x| < 4,
    which moves the output by that times its key's weight times |v|."""
    if want.dtype == torch.float32:
        return torch.full_like(want, 2e-5)
    if round_logits:
        return torch.full_like(want, 2e-2, dtype=torch.float32)
    e = torch.floor(torch.log2(want.abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 6).clamp_min(4e-3)


def qkv_views(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v as strided (B, H, L, D) views of a fused (B, L, 3·H·D)
    projection, read as (B, L, 3, H, D). No copy."""
    b, l, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    t = qkv.view(b, l, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


# The kernel's launch geometry (vlfm_tpu_torch/csrc/attention.cu).
WHOLE_HEAD_KEYS = 272  # the longest key axis the whole-head body holds
_WARPS = 4  # warps of a block, one 16-row query tile each at a time
_WHOLE_TILES_PER_BLOCK = 17  # query tiles of a whole-head block: L = 257 is one block a head
_CHUNK_KEYS = 64  # keys of a streaming stage
_STAGES = 3  # streaming ring depth
_PAD = 8  # elements added to each shared tile row
_F32_CHUNK = 64
_BODY_CODES = {"f32": 0, "whole-head": 1, "streaming": 2}
# Flag bits: q, k, v copied 16 bytes at a time; o stored in pairs; K's tile
# is [D][keys] (K stored with unit stride on L).
_VEC_Q, _VEC_K, _VEC_V, _PAIR_O, _K_T = 1, 2, 4, 8, 16


def _aligned(t: torch.Tensor) -> bool:
    """Whether the kernel may copy ``t`` 16 bytes at a time: unit stride
    on D, and every row's 16-byte groups starting on a 16-byte boundary."""
    n = 16 // t.element_size()
    st = t.stride()
    return st[3] == 1 and t.shape[3] % n == 0 and all(s % n == 0 for s in st[:3]) and t.data_ptr() % 16 == 0


def _aligned_keys(k: torch.Tensor) -> bool:
    """Whether a K stored with unit stride on L may be copied eight keys at a
    time: every D row's key groups start on a 16-byte boundary."""
    st = k.stride()
    return all(s % 8 == 0 for s in (st[0], st[1], st[3])) and k.data_ptr() % 16 == 0


def _pairs(o: torch.Tensor) -> bool:
    """Whether the kernel may store ``o`` two bf16 values (4 bytes) at a time."""
    st = o.stride()
    return st[3] == 1 and o.shape[3] % 2 == 0 and all(s % 2 == 0 for s in st[:3]) and o.data_ptr() % 4 == 0


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How the kernel runs one call: its body ("whole-head", "streaming" or
    "f32"), whether K's shared tile is [D][keys] (K stored transposed),
    which tensors take element-by-element loads instead of 16-byte copies,
    the query tiles of 16 rows per block, the grid (blocks per head,
    batch x heads), the dynamic shared memory per block, and the flag bits
    the kernel reads."""

    body: str
    k_transposed: bool
    scalar_loads: tuple[str, ...]
    tiles_per_block: int
    grid: tuple[int, int]
    smem_bytes: int
    flags: int

    def describe(self) -> str:
        parts = [self.body]
        if self.k_transposed:
            parts.append("K^T tile")
        if self.scalar_loads:
            parts.append("element loads of " + "/".join(self.scalar_loads))
        return ", ".join(parts)


def attention_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> AttentionPlan:
    """The kernel's launch plan for these (B, H, L, D) tensors, from their
    shapes, dtypes, strides and pointers alone; the tensors may lie on any
    device. The shared-memory figures are the kernel's ``smem_bytes``."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    dpad = -(-d // (32 if bf16 else 16)) * (32 if bf16 else 16)  # bf16: an even number of k16 steps
    ldt = dpad + _PAD
    kt = bf16 and k.stride(3) != 1 and k.stride(2) == 1
    vec = {"q": _aligned(q), "k": _aligned_keys(k) if kt else _aligned(k), "v": _aligned(v)}
    flags = int(vec["q"]) * _VEC_Q | int(vec["k"]) * _VEC_K | int(vec["v"]) * _VEC_V
    flags |= (_PAIR_O if bf16 and _pairs(out) else 0) | (_K_T if kt else 0)
    qtiles = -(-lq // 16)
    if not bf16:
        body, tiles = "f32", _WARPS
        smem = 4 * ((_WARPS * 16 + 2 * _F32_CHUNK) * ldt + _WARPS * 16 * ((_F32_CHUNK + 4) + (_F32_CHUNK + 8)))
    elif lk <= WHOLE_HEAD_KEYS:
        body, tiles = "whole-head", min(qtiles, _WHOLE_TILES_PER_BLOCK)
        k_tile = dpad * (WHOLE_HEAD_KEYS + _PAD) if kt else WHOLE_HEAD_KEYS * ldt
        smem = 2 * (k_tile + WHOLE_HEAD_KEYS * ldt)
    else:
        body, tiles = "streaming", _WARPS
        k_tile = dpad * (_CHUNK_KEYS + _PAD) if kt else _CHUNK_KEYS * ldt
        smem = 2 * _STAGES * (k_tile + _CHUNK_KEYS * ldt)
    return AttentionPlan(
        body=body, k_transposed=kt, scalar_loads=tuple(n for n, ok in vec.items() if not ok),
        tiles_per_block=tiles, grid=(-(-qtiles // tiles), b * h), smem_bytes=smem, flags=flags,
    )


def _check_cuda_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, normalize: str) -> None:
    if normalize not in NORMALIZE:
        raise ValueError(f"normalize must be one of {NORMALIZE}, got {normalize!r}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("attention kernel takes (B, H, L, D) tensors")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes 1 <= D <= {MAX_HEAD_DIM}, got D={d}")
    if b * h > 65535:
        raise ValueError(f"attention kernel takes B * H <= 65535, got {b * h}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    clamp: Optional[float] = None,
    normalize: str = "probs",
    round_logits: bool = False,
) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) x2 -> (B, H, Lq, D), the variant chosen
    as in ``attention_ref``. Inputs may have any strides.

    CPU tensors take ``attention_ref``. CUDA tensors launch the kernel on
    the current stream, into an output whose memory is (B, Lq, H, D);
    the counter ``K3.launches`` counts those launches. Each call is a
    ``vlfm.K3`` span with its shapes and dtype.
    """
    with span("vlfm.K3", q=q, k=k):
        if q.device.type == "cpu":
            return attention_ref(q, k, v, clamp=clamp, normalize=normalize, round_logits=round_logits)
        if q.device.type != "cuda":
            raise ValueError(f"attention runs on CPU or CUDA tensors, got {q.device}")
        from vlfm_tpu_torch.kernels.build import load_library

        _check_cuda_args(q, k, v, normalize)
        b, h, lq, d = q.shape
        lk = k.shape[2]
        out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
        if out.numel() == 0:
            return out
        if lk == 0:
            raise ValueError("attention over zero keys")
        lib = load_library()
        plan = attention_plan(q, k, v, out)
        strides = (ctypes.c_longlong * 16)(*(s for t in (q, k, v, out) for s in t.stride()))
        err = lib.vlfm_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, lq, lk, d, 1.0 / math.sqrt(d), -1.0 if clamp is None else float(clamp),
            int(clamp is None), int(normalize == "probs"), int(round_logits), plan.flags,
            _DTYPE_CODES[q.dtype], _BODY_CODES[plan.body], plan.tiles_per_block, plan.smem_bytes,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
        count("K3.launches")
        return out
