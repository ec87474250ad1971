"""The plain version of K4 (``vlfm_tpu_torch.ops.deform_gather``) against
the JAX package, on the CPU.

Two JAX references on the same numpy inputs:
- ``_deform_combine_levels(..., interpret=True, force_pallas=True)``: the
  Pallas TPU kernel's body (``vlfm_tpu/ops/deform_gather.py:_kernel``) run
  by the Pallas interpreter, once per level, with the attention weights
  folded into the tap weights;
- the module's default formulation (``_bilinear_sample_rows`` per level,
  then one einsum), which the port's plain version mirrors.

Cases: f32 and bf16 value, grids in [-1.2, 1.2] (taps on and off the
maps), grids with entries at +-1e6 (far off the maps: the anchors are
clamped before the integer conversion), and Q = 70, not a multiple of the
kernel's 512-query tile. Tolerance 1e-5 absolute (values of order 1,
softmaxed weights: f32 sums taken in other orders); against the einsum
formulation the port matches to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models.grounding_dino import _bilinear_sample_rows, _deform_combine_levels
from vlfm_tpu_torch.ops import deform_gather as D
from vlfm_tpu_torch.utils.profiling import counters, reset_counters

ATOL = 1e-5
SHAPES = ((7, 9), (4, 5), (2, 3))


def _inputs(seed, b=2, q=70, nh=2, dh=16, npts=3, shapes=SHAPES, spread=1.2, far=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, nh * dh)).astype(np.float32)
    grids = rng.uniform(-spread, spread, (b, q, nh, len(shapes), npts, 2)).astype(np.float32)
    if far:
        pick = rng.random(grids.shape) < 0.2
        grids[pick] = np.where(rng.random(int(pick.sum())) < 0.5, -1e6, 1e6)
    logits = rng.normal(size=(b, q, nh, len(shapes) * npts))
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    weights = weights.reshape(b, q, nh, len(shapes), npts).astype(np.float32)
    if dtype == "bfloat16":
        value = np.asarray(jnp.asarray(value, jnp.bfloat16))  # numpy bf16 (ml_dtypes)
    return value, grids, weights


def _jax_einsum_path(value, grids, weights, shapes, nh, dh):
    """The JAX module's default path: per-level row gather, stack, einsum."""
    b = value.shape[0]
    start, sampled = 0, []
    for li, (h, w) in enumerate(shapes):
        v_l = value[:, start:start + h * w].reshape(b, h, w, nh * dh)
        sampled.append(_bilinear_sample_rows(v_l, grids[:, :, :, li], nh, dh))
        start += h * w
    return jnp.einsum("bqhlpd,bqhlp->bqhd", jnp.stack(sampled, axis=3), weights)


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("far", [False, True])
def test_plain_matches_pallas_kernel_body(dtype, far):
    value, grids, weights = _inputs(1, far=far, dtype=dtype)
    nh, dh = 2, 16
    want = _deform_combine_levels(jnp.asarray(value), jnp.asarray(grids), jnp.asarray(weights), SHAPES,
                                  nh, dh, interpret=True, force_pallas=True)
    got = D.deform_gather(_torch(value), SHAPES, _torch(grids), _torch(weights))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 70, nh, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("far", [False, True])
def test_plain_matches_jax_einsum_path(dtype, far):
    value, grids, weights = _inputs(2, q=33, nh=4, dh=8, npts=4, far=far, dtype=dtype)
    want = _jax_einsum_path(jnp.asarray(value), jnp.asarray(grids), jnp.asarray(weights), SHAPES, 4, 8)
    got = D.deform_gather(_torch(value), SHAPES, _torch(grids), _torch(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_samples_off_the_maps_contribute_nothing():
    value, grids, weights = _inputs(3, q=5)
    grids[:] = 1e6
    got = D.deform_gather(_torch(value), SHAPES, _torch(grids), _torch(weights))
    assert torch.equal(got, torch.zeros_like(got))


def test_centre_of_a_cell_reads_that_cell():
    """A sample at a pixel centre reads that pixel alone (align_corners=False)."""
    h, w, nh, dh = 3, 4, 1, 2
    value = torch.arange(h * w * dh, dtype=torch.float32).reshape(1, h * w, dh)
    gx, gy = (2 * 1 + 1) / w - 1, (2 * 2 + 1) / h - 1  # pixel (y=2, x=1)
    grids = torch.tensor([gx, gy]).reshape(1, 1, nh, 1, 1, 2)
    out = D.deform_gather(value, [(h, w)], grids, torch.ones(1, 1, nh, 1, 1))
    torch.testing.assert_close(out.reshape(-1), value[0, 2 * w + 1], rtol=0, atol=1e-6)


def test_plain_version_equals_grid_sample():
    """The function is HF's multi_scale_deformable_attention: one
    F.grid_sample (bilinear, zeros, align_corners=False) per level, then the
    weighted sum."""
    value, grids, weights = _inputs(4, q=9, nh=2, dh=4, npts=2)
    v, g, wt = (_torch(a) for a in (value, grids, weights))
    b, q, nh, nl, npts, _ = g.shape
    dh = v.shape[-1] // nh
    start, per_level = 0, []
    for li, (h, w) in enumerate(SHAPES):
        v_l = v[:, start:start + h * w].reshape(b, h, w, nh, dh).permute(0, 3, 4, 1, 2).reshape(b * nh, dh, h, w)
        g_l = g[:, :, :, li].permute(0, 2, 1, 3, 4).reshape(b * nh, q, npts, 2)
        s = torch.nn.functional.grid_sample(v_l, g_l, mode="bilinear", padding_mode="zeros", align_corners=False)
        per_level.append(s.reshape(b, nh, dh, q, npts))
        start += h * w
    samp = torch.stack(per_level, dim=-2)  # (B, nh, dh, Q, nl, P)
    want = (samp * wt.permute(0, 2, 1, 3, 4)[:, :, None]).sum((-1, -2)).permute(0, 3, 1, 2)
    torch.testing.assert_close(D.deform_gather(v, SHAPES, g, wt), want, rtol=0, atol=1e-5)


def test_wrapper_routes_by_device_and_counts_only_kernel_launches():
    value, grids, weights = _inputs(5, q=3)
    reset_counters()
    D.deform_gather(_torch(value), SHAPES, _torch(grids), _torch(weights))
    assert counters().get("K4.launches", 0) == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        D.deform_gather(_torch(value).to("meta"), SHAPES, _torch(grids).to("meta"), _torch(weights).to("meta"))


def test_tolerance_scales_with_the_values():
    v = torch.full((1, 4, 2), 3.0)
    w = torch.full((1, 1, 1, 2, 2), 0.25)
    assert D.deform_gather_tolerance(v, w) == pytest.approx(3e-5)
    assert D.deform_gather_tolerance(v * 0.01, w) == pytest.approx(1e-5)
