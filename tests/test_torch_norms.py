"""vlfm_tpu_torch LayerNorm (K1) against the JAX Pallas kernel.

On the CPU the port's ``layer_norm`` runs its plain version; it is held to
``vlfm_tpu.ops.norms.layer_norm`` in interpret mode on the cases of
tests/test_norms.py. The CUDA kernel itself is held to the plain version by
tests/test_torch_cuda.py (skips without a card) and by chip_smoke.py.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.ops.norms import layer_norm as jax_layer_norm
from vlfm_tpu_torch.kernels import build as B
from vlfm_tpu_torch.models.layers import FastLayerNorm, LayerNormF32
from vlfm_tpu_torch.ops.norms import layer_norm, layer_norm_ref


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


def test_cpu_tensor_takes_plain_version_without_counting():
    x, scale, bias = _inputs((5, 64), seed=5)
    before = layer_norm.launches
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    want = layer_norm_ref(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    assert torch.equal(got, want)
    assert layer_norm.launches == before


def test_other_devices_raise():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        layer_norm(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


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
