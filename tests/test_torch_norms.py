"""vlfm_tpu_torch LayerNorm (K1) against the JAX Pallas kernel.

On the CPU the port's ``layer_norm`` runs its plain version; it is held to
``vlfm_tpu.ops.norms.layer_norm`` in interpret mode on the cases of
tests/test_norms.py. The fused entry ``add_layer_norm`` runs its plain
version here too, which is ``x + h`` then ``layer_norm_ref``, bit for bit;
the models that route their residual adds through it keep their state-dict
keys. The CUDA kernel itself is held to the plain version by
tests/test_torch_cuda.py (skips without a card) and by chip_smoke.py.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.ops.norms import layer_norm as jax_layer_norm
from vlfm_tpu_torch.kernels import build as B
from vlfm_tpu_torch.models import blip2_itm as TB
from vlfm_tpu_torch.models import owl_vit as TO
from vlfm_tpu_torch.models.layers import FastLayerNorm, LayerNormF32
from vlfm_tpu_torch.models.params import port_layout
from vlfm_tpu_torch.ops.norms import add_layer_norm, add_layer_norm_ref, layer_norm, layer_norm_ref
from vlfm_tpu_torch.utils.profiling import counters, reset_counters


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,row_tile", [
    ((2, 7, 96), 4),       # ragged final row tile (14 rows, tile 4)
    ((3, 128), 128),       # exactly one tile
    ((1, 1, 33), 8),       # tiny, ragged feature dim
    ((260,), 256),         # 1 row total
])
def test_layer_norm_matches_jax_f32(shape, row_tile):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     eps=1e-6, row_tile=row_tile, interpret=True))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_layer_norm_bf16_input_matches_jax(eps):
    x, scale, bias = _inputs((64, 384), seed=3)
    x = x * 1.5 + 4.0  # a large mean: the two-pass variance matters
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(
        jax_layer_norm(xj, jnp.asarray(scale), jnp.asarray(bias), eps=eps, interpret=True),
        np.float32,
    )
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    got = layer_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), eps)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_fast_layer_norm_is_drop_in_for_nn_layer_norm():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 48)).astype(np.float32))
    ref = torch.nn.LayerNorm(48, eps=1e-5)
    ours = FastLayerNorm(48, eps=1e-5)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(1 + 0.05 * rng.standard_normal(48).astype(np.float32)))
        ref.bias.copy_(torch.from_numpy(0.05 * rng.standard_normal(48).astype(np.float32)))
        ours.load_state_dict(ref.state_dict())
        np.testing.assert_allclose(ours(x).numpy(), ref(x).numpy(), atol=1e-5)
    # LayerNormF32 keeps the flax scope name ``ln`` for its parameters.
    assert set(LayerNormF32(48).state_dict()) == {"ln.weight", "ln.bias"}


def _k1_launches():
    """(K1.launches, K1.fused_launches) since the last reset."""
    c = counters()
    return c.get("K1.launches", 0), c.get("K1.fused_launches", 0)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, scale, bias = _inputs((5, 64), seed=5)
    reset_counters()
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    want = layer_norm_ref(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    assert torch.equal(got, want)
    assert _k1_launches() == (0, 0)
    x, h, scale, bias = _add_inputs((5, 64), (5, 64), torch.bfloat16, seed=5)
    s, y = add_layer_norm(x, h, scale, bias, keep_sum=True)
    want_s, want_y = add_layer_norm_ref(x, h, scale, bias, keep_sum=True)
    assert torch.equal(s, want_s) and torch.equal(y, want_y)
    assert _k1_launches() == (0, 0)


def test_other_devices_raise():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        layer_norm(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        add_layer_norm(x, x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), keep_sum=True)


def _add_inputs(shape, h_shape, dtype, seed):
    """x, h (h of ``h_shape``, broadcast against x), scale, bias: residual
    streams with a large mean, so the two-pass variance and the sum's
    rounding both matter."""
    x, scale, bias = _inputs(shape, seed)
    h = np.random.default_rng(seed + 1).standard_normal(h_shape).astype(np.float32) * 3.0 + 4.0
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(h).to(dtype), torch.from_numpy(scale),
            torch.from_numpy(bias))


# (x's shape, h's shape): one row, leading shapes, h broadcast over the batch
# (a position table), and a ragged width.
ADD_SHAPES = [((1, 64), (1, 64)), ((2, 7, 96), (2, 7, 96)), ((3, 9, 48), (1, 9, 48)),
              ((2, 5, 33), (5, 33))]


@pytest.mark.parametrize("keep_sum", [True, False])
@pytest.mark.parametrize("eps", [1e-6, 1e-12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,h_shape", ADD_SHAPES)
def test_add_layer_norm_is_add_then_layer_norm_bit_for_bit(shape, h_shape, dtype, eps, keep_sum):
    x, h, scale, bias = _add_inputs(shape, h_shape, dtype, seed=sum(shape) + len(h_shape))
    s_want = x + h
    y_want = layer_norm_ref(s_want, scale, bias, eps)
    reset_counters()
    for fn in (add_layer_norm_ref, add_layer_norm):  # the wrapper takes the plain version on the CPU
        got = fn(x, h, scale, bias, eps, keep_sum=keep_sum)
        s, y = got if keep_sum else (None, got)
        assert y.dtype == dtype and y.shape == shape
        assert torch.equal(y, y_want)
        if keep_sum:
            assert s.dtype == dtype and torch.equal(s, s_want)
    assert _k1_launches() == (0, 0)


def test_add_layer_norm_raises_on_mismatched_dtype_or_shape():
    x, h, scale, bias = _add_inputs((4, 32), (4, 32), torch.float32, seed=6)
    with pytest.raises(TypeError, match="one dtype"):
        add_layer_norm(x, h.to(torch.bfloat16), scale, bias, keep_sum=False)
    with pytest.raises(ValueError, match="trailing dimensions"):
        add_layer_norm(x[:1], h, scale, bias, keep_sum=True)


def _jax_keys(module, *args) -> set:
    """The state-dict keys ``from_jax_params`` fills from ``module``'s JAX
    parameter tree (shapes only: ``jax.eval_shape`` of its init)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return set(port_layout(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)))


def _model_keys(model: str):
    """(the port's tiny module's state-dict keys, the keys JAX's tree fills)."""
    if model == "blip2":
        jcfg, jmod, tmod = JB.BLIP2ITMConfig.tiny(), JB.BLIP2ITMModule, TB.BLIP2ITMModule(
            TB.BLIP2ITMConfig.tiny(), device="cpu")
        s = jcfg.vit.image_size
    else:
        jcfg, jmod, tmod = JO.OwlViTDetConfig.tiny(), JO.OwlViTDetectionModule, TO.OwlViTDetectionModule(
            TO.OwlViTDetConfig.tiny(), device="cpu")
        s = jcfg.vision.image_size
    want = _jax_keys(jmod(jcfg), jnp.zeros((1, s, s, 3)), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool))
    return set(tmod.state_dict()), want


@pytest.mark.parametrize("model,prefix", [("blip2", "vision."), ("blip2", "qformer."), ("owl_vit", "")])
def test_fused_models_keep_their_state_dict_keys(model, prefix):
    """ViT-g, the Q-Former and OWL-ViT route their adds through
    ``add_layer_norm`` with the same modules: their keys are still exactly
    those a JAX tree fills."""
    got, want = _model_keys(model)
    got = {k for k in got if k.startswith(prefix)}
    want = {k for k in want if k.startswith(prefix)}
    assert got and got == want


def _fake_nvcc(tmp_path, body: str):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(B, "_nvcc", lambda: _fake_nvcc(tmp_path, 'echo "bad token" >&2\nexit 2\n'))
    with pytest.raises(RuntimeError, match="bad token"):
        B.build()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    # A stand-in nvcc that writes its -o target and logs each call's arguments.
    log = tmp_path / "calls"
    body = f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(B, "_nvcc", lambda: _fake_nvcc(tmp_path, body))
    lib = B.build()
    assert lib.exists() and lib.parent.name == B._source_hash(B._sources())
    assert B.build() == lib  # unchanged sources: no second compile
    calls = log.read_text().splitlines()
    sources = B._sources()
    compiles, links = calls[:len(sources)], calls[len(sources):]
    assert len(links) == 1 and "-shared" in links[0].split()  # one compile per source, one link
    for src in sources:
        assert sum(str(src) in c for c in compiles) == 1
    assert all("-c" in c.split() and "arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert os.path.basename(str(lib)) == B.LIB_NAME
    assert not list(lib.parent.glob("*.o"))  # objects are removed after the link
