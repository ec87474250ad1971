"""vlfm_tpu_torch.ops.attention against vlfm_tpu's attention, on the CPU.

The port's plain attention (``attention_ref``, which the K3 kernel is held
to on the card) in each of its variants, against the JAX function it
stands for, on the same seeded numpy inputs:

- the Pallas kernels of vlfm_tpu/ops/attention.py in interpret mode:
  ``flash_attention_grouped`` and ``flash_attention`` (max, probs) and
  ``flash_attention_grouped_v2`` (max, output);
- ``layers.attention_bf16_softmax`` (clamp 80, output, bf16 logits) and
  ``layers.attention`` (max, probs; in bf16 JAX rounds the logits to bf16
  before its f32 softmax, which the tolerance covers);
- the diagnostic kernels of scripts/diag_attn_core.py and diag_attn3.py,
  which have no interpret switch: their kernel bodies (``_kernel``,
  ``_kt_kernel``, ``_phased_kernel``) run eagerly with numpy arrays as the
  refs. The scripts are not imported (importing them sets up a compile
  cache); the bodies are compiled from their source. ``pure_kernel``
  (diag_attn_pure.py) is ``_kt_kernel`` with ``pl.reciprocal(approx=True)``,
  which the port replaces with an exact divide, so it is held as
  ``_kt_kernel`` with ``recip=False``.

Tolerances are tests/test_attention.py's: 2e-5 in f32, 2e-2 in bf16.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import layers as JL
from vlfm_tpu.ops import attention as JA
from vlfm_tpu_torch.models.layers import FusedQKVAttention, merge_heads, split_heads
from vlfm_tpu_torch.models.layers import attention as plain_attention
from vlfm_tpu_torch.ops.attention import WHOLE_HEAD_KEYS, attention, attention_plan, attention_ref, qkv_views

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 2, 64, 32), (1, 16, 257, 88), (2, 4, 130, 16)]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, dtype, seed=0):
    np_dt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(shape).astype(np.float32).astype(np_dt) for _ in range(3)]
    jx = [jnp.asarray(a, jdt) for a in qkv]
    tx = [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in qkv]
    return jx, tx, tol


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)


PALLAS = {
    "flash_attention_grouped": (JA.flash_attention_grouped, dict(clamp=None, normalize="probs")),
    "flash_attention": (JA.flash_attention, dict(clamp=None, normalize="probs")),
    "flash_attention_grouped_v2": (JA.flash_attention_grouped_v2, dict(clamp=None, normalize="output")),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", list(PALLAS))
def test_pallas_kernels_match_plain_variant(kernel, shape, dtype):
    fn, variant = PALLAS[kernel]
    (jq, jk, jv), (q, k, v), tol = _inputs(shape, dtype)
    want = fn(jq, jk, jv, interpret=True)
    got = attention(q, k, v, **variant)  # CPU tensors: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_softmax_matches_clamped_output_variant(shape):
    (jq, jk, jv), (q, k, v), tol = _inputs(shape, "bf16", seed=1)
    want = JL.attention_bf16_softmax(jq, jk, jv)
    got = attention_ref(q, k, v, clamp=80.0, normalize="output", round_logits=True)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_layers_attention_matches_max_probs_variant(shape, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(shape, dtype, seed=2)
    want = JL.attention(jq, jk, jv)
    _close(attention_ref(q, k, v), want, tol)
    _close(plain_attention(q, k, v), want, tol)  # the port's own plain path


def _diag_kernels():
    """The diagnostic scripts' kernel bodies, compiled from their source."""
    ns = {"jax": jax, "jnp": jnp}
    for script, names in (("diag_attn3.py", ("_kt_kernel", "_phased_kernel")),
                          ("diag_attn_core.py", ("_kernel",))):
        with open(os.path.join(REPO, "scripts", script)) as f:
            tree = ast.parse(f.read())
        defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
        assert len(defs) == len(names), script
        exec(compile(ast.Module(body=defs, type_ignores=[]), script, "exec"), ns)
    return ns


DIAG = {
    # name: (kernel, its options, K transposed, scratch refs, the port's variant)
    "diag_attn_core.grouped": ("_kernel", dict(norm_after=False, max_free=False), False, False,
                               dict(clamp=None, normalize="probs")),
    "diag_attn_core.grouped_na": ("_kernel", dict(norm_after=True, max_free=False), False, False,
                                  dict(clamp=None, normalize="output")),
    "diag_attn_core.grouped_mf": ("_kernel", dict(norm_after=True, max_free=True), False, False,
                                  dict(clamp=60.0, normalize="output")),
    "diag_attn3.attn_kt": ("_kt_kernel", dict(recip=False, pexp16=False, bdot=False), True, False,
                           dict(clamp=60.0, normalize="output")),
    "diag_attn3.attn_kt_pexp16": ("_kt_kernel", dict(recip=False, pexp16=True, bdot=False), True, False,
                                  dict(clamp=60.0, normalize="output", round_logits=True)),
    "diag_attn3.attn_phased": ("_phased_kernel", dict(scratch16=True), True, True,
                               dict(clamp=60.0, normalize="output", round_logits=True)),
}


@pytest.fixture(scope="module")
def diag_kernels():
    return _diag_kernels()


@pytest.mark.parametrize("shape", [(2, 2, 64, 32), (1, 16, 257, 88)])
@pytest.mark.parametrize("name", list(DIAG))
def test_diagnostic_kernel_bodies_match_plain_variant(diag_kernels, name, shape):
    """bf16, as the scripts run them; K is passed transposed to the bodies
    that take it so, and to the port as a transposed view."""
    kernel, opts, kt, scratch, variant = DIAG[name]
    b, h, l, d = shape
    (jq, jk, jv), (q, k, v), tol = _inputs(shape, "bf16", seed=3)
    bh = b * h
    qn, kn, vn = (np.asarray(a).reshape(bh, l, d) for a in (jq, jk, jv))
    out = np.zeros((bh, l, d), jnp.bfloat16)
    refs = [qn, np.ascontiguousarray(kn.swapaxes(1, 2)) if kt else kn, vn, out]
    if scratch:
        refs += [np.zeros((bh, l, l), jnp.bfloat16), np.zeros((bh, l, 1), np.float32)]
    diag_kernels[kernel](*refs, scale=1.0 / d**0.5, **opts)
    if kt:  # the port reads K through the strides of its transposed storage
        k = torch.from_numpy(np.asarray(refs[1], np.float32)).to(torch.bfloat16).reshape(b, h, d, l)
        k = k.transpose(-1, -2)
        assert not k.is_contiguous()
    got = attention(q, k, v, **variant)
    _close(got, out.reshape(b, h, l, d), tol)


@pytest.mark.parametrize("clamp,normalize,round_logits", [
    (None, "probs", False), (None, "output", False), (60.0, "output", True), (80.0, "probs", True),
])
def test_strided_qkv_views_equal_contiguous_heads(clamp, normalize, round_logits):
    """q, k and v read through strided views of a fused (B, L, 3HD)
    projection give what the contiguous split heads give."""
    rng = np.random.default_rng(4)
    b, l, h, d = 2, 37, 3, 24
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * h * d)).astype(np.float32))
    views = qkv_views(qkv, h)
    heads = [split_heads(t, h) for t in qkv.chunk(3, dim=-1)]
    for view, head in zip(views, heads):
        assert view.shape == (b, h, l, d) and not view.is_contiguous()
        assert view.data_ptr() >= qkv.data_ptr() and torch.equal(view, head)
    variant = dict(clamp=clamp, normalize=normalize, round_logits=round_logits)
    got = attention(*views, **variant)
    want = attention_ref(*(t.contiguous() for t in heads), **variant)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_fused_qkv_attention_through_views_equals_contiguous_path():
    torch.manual_seed(0)
    mod = FusedQKVAttention(48, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 19, 48)).astype(np.float32))
    q, k, v = (split_heads(t, 4) for t in mod.qkv(x).chunk(3, dim=-1))
    want = mod.proj(merge_heads(plain_attention(q.contiguous(), k.contiguous(), v.contiguous())))
    torch.testing.assert_close(mod(x), want, atol=1e-6, rtol=0)


def test_padded_keys_do_not_leak():
    """tests/test_attention.py's check on K3c's key padding: all-equal
    values give 1 under any weighting, unless padding leaks weight (a leak
    onto zero rows would give 257/272 here, with the kernel's 16-key
    padding). The f32 tolerance covers 257 terms of 1/257."""
    ones = torch.ones((1, 1, 257, 88))
    for variant in (dict(), dict(normalize="output"), dict(clamp=60.0, normalize="output")):
        torch.testing.assert_close(attention(ones, ones, ones, **variant), ones, atol=2e-5, rtol=0)


def test_bad_variant_raises():
    q = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="normalize"):
        attention_ref(q, q, q, normalize="rows")


def _plan(shape, dtype=torch.bfloat16, layout=""):
    """The kernel's launch plan for zero tensors of this shape and layout,
    on the CPU: the plan reads shapes, strides and pointers only."""
    b, h, l, d = shape
    if layout == "qkv":
        q, k, v = qkv_views(torch.zeros(b, l, 3 * h * d, dtype=dtype), h)
    else:
        q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
        if layout == "kt":
            k = k.transpose(-1, -2).contiguous().transpose(-1, -2)
    out = torch.empty((b, l, h, d), dtype=dtype).permute(0, 2, 1, 3)  # the wrapper's output layout
    return attention_plan(q, k, v, out)


@pytest.mark.parametrize("shape,dtype,layout,body,grid,smem", [
    # ViT-g at B=32 and at the spin's 12 views: one block per head, K and V
    # whole (2 x 272 keys x (96 + 8) x 2 B)
    ((32, 16, 257, 88), torch.bfloat16, "qkv", "whole-head", (1, 512), 113152),
    ((12, 16, 257, 88), torch.bfloat16, "qkv", "whole-head", (1, 192), 113152),
    # K stored transposed: a [D][keys] tile of 96 x (272 + 8); odd L copies element by element
    ((2, 16, 257, 88), torch.bfloat16, "kt", "whole-head, K^T tile, element loads of k", (1, 32), 110336),
    ((2, 16, 256, 88), torch.bfloat16, "kt", "whole-head, K^T tile", (1, 32), 110336),
    # longer key axes: 64-query blocks, a 3-stage ring of 64-key K and V chunks
    ((2, 4, 1024, 64), torch.bfloat16, "", "streaming", (16, 8), 3 * 2 * 2 * 64 * 72),
    ((1, 2, 3000, 32), torch.bfloat16, "", "streaming", (47, 2), 3 * 2 * 2 * 64 * 40),
    ((1, 2, 1024, 64), torch.bfloat16, "kt", "streaming, K^T tile", (16, 2), 3 * 2 * (64 * 72 + 64 * 72)),
    # just over the whole-head limit: 19 query tiles in 5 blocks; far under it: one tile
    ((1, 1, 300, 32), torch.bfloat16, "", "streaming", (5, 1), 3 * 2 * 2 * 64 * 40),
    ((1, 3, 5, 8), torch.bfloat16, "", "whole-head", (1, 3), 2 * 2 * 272 * 40),  # D padded to 32
    # f32: the CUDA-core body, 64-query blocks
    ((1, 16, 257, 88), torch.float32, "", "f32", (5, 16), 4 * (192 * 104 + 64 * (68 + 72))),
])
def test_attention_plan_picks_body_grid_and_shared_memory(shape, dtype, layout, body, grid, smem):
    plan = _plan(shape, dtype, layout)
    assert (plan.describe(), plan.grid, plan.smem_bytes) == (body, grid, smem)


def test_attention_plan_fits_two_whole_head_blocks_an_sm_and_fills_the_card():
    """At ViT-g's 257 tokens: two blocks of 113 KB (each with the 1 KB the
    runtime reserves) fit an H100 SM's 228 KB; 17 query tiles of 16 rows
    make 257 of 272 rows useful; B=32 gives 512 blocks (two waves of 2 x
    132) and the spin's 12 views 192, at least one on every SM."""
    plan = _plan((32, 16, 257, 88), layout="qkv")
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.tiles_per_block == 17 and 257 / (16 * plan.tiles_per_block) > 0.94
    assert plan.grid[0] * plan.grid[1] >= 2 * 132
    spin = _plan((12, 16, 257, 88), layout="qkv")
    assert spin.grid[0] * spin.grid[1] >= 132
    assert plan.flags == spin.flags == 0b01111  # q, k, v copied 16 bytes at a time; o stored in pairs


def test_attention_plan_whole_head_limit():
    assert _plan((1, 1, WHOLE_HEAD_KEYS, 64)).body == "whole-head"
    assert _plan((1, 1, WHOLE_HEAD_KEYS + 1, 64)).body == "streaming"
