"""vlfm_tpu_torch's threefry draws beyond uniform bits against ``jax.random``
on the CPU, bit for bit.

``uniform`` with bounds, ``gumbel``, ``categorical`` and ``normal`` for
many keys and shapes, single keys and a (B, 2) batch against ``jax.vmap``.
They rest on the port's restatements of XLA's CPU ``log``, ``log1p`` and
``erf_inv`` (Cephes and Giles polynomials with the fused multiply-adds the
compiled code has), held here bit for bit to ``jnp.log``, ``jnp.log1p`` and
``jax.lax.erf_inv`` over every f32 that ``uniform`` can produce on the
domains the draws use (a stride through the 2^23 mantissas) and over random
bit patterns of the whole f32 range, and on the exact ``fma`` they use,
held to exact rational arithmetic. 0 ulps everywhere: the draws are
bit-equal.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu_torch.ops import threefry as T

TINY = np.finfo(np.float32).tiny
LO = np.nextafter(np.float32(-1), np.float32(0))
SHAPES = [(), (7,), (3, 4), (2, 3, 5), (1000,)]


def _mantissa_uniforms(stride: int = 13) -> np.ndarray:
    """Every stride-th float of jax's [0, 1) uniform (the 23 random bits
    under 1.0's exponent, minus 1), with both ends."""
    m = np.concatenate([np.arange(0, 2**23, stride), [2**23 - 1]]).astype(np.uint32)
    return (m | 0x3F800000).view(np.float32) - np.float32(1.0)


def _random_floats(n: int = 2**18, seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.int64).astype(np.uint32).view(np.float32)
    return np.concatenate([x, np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40, TINY],
                                       np.float32)])


def _bits_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(got) & np.isnan(want) if np.issubdtype(want.dtype, np.floating) else False
    bad = (got.view(np.int32) != want.view(np.int32)) & ~nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, e.g. at {np.argwhere(bad)[:3].tolist()}"


def _domain(name: str) -> np.ndarray:
    u = _mantissa_uniforms()
    if name == "gumbel_inner":  # uniform(tiny, 1): the argument of gumbel's inner log
        return np.maximum(np.float32(TINY), u + np.float32(TINY))
    if name == "gumbel_outer":  # -log of that: the outer log's argument
        return -np.asarray(jax.jit(jnp.log)(_domain("gumbel_inner")))
    return np.maximum(LO, u * np.float32(2.0) + LO)  # uniform(nextafter(-1, 0), 1): normal's erf_inv argument


@pytest.mark.parametrize("domain", ["gumbel_inner", "gumbel_outer", "all"])
def test_xla_log_bit_equal(domain):
    x = _random_floats() if domain == "all" else _domain(domain)
    _bits_equal(T.xla_log(torch.from_numpy(x)), jax.jit(jnp.log)(x))


@pytest.mark.parametrize("domain", ["normal", "all"])
def test_xla_log1p_and_erf_inv_bit_equal(domain):
    x = _random_floats(seed=1) if domain == "all" else _domain(domain)
    _bits_equal(T.xla_erf_inv(torch.from_numpy(x)), jax.jit(jax.lax.erf_inv)(x))
    y = x * -x if domain == "normal" else x  # erf_inv's log1p argument
    _bits_equal(T.xla_log1p(torch.from_numpy(y)), jax.jit(jnp.log1p)(y))


def test_fma_rounds_once():
    rng = np.random.default_rng(0)
    n = 3000
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    c = (rng.standard_normal(n) * rng.choice([1e-9, 1e-3, 1.0, 1e3, 1e9], n)).astype(np.float32)
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(np.float32)  # near-cancellations
    got = T.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = np.float32(float(exact))
        cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        err = [abs(Fraction(float(v)) - exact) for v in cands]
        best = [v for v, e in zip(cands, err) if e == min(err)]
        if len(best) > 1:  # a tie rounds to the even mantissa
            best = [v for v in best if not np.array(v).view(np.int32) & 1]
        assert got[i] == best[0], (a[i], b[i], c[i])


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 12345])
@pytest.mark.parametrize("shape", SHAPES)
def test_draws_match_jax(seed, shape):
    key, tkey = jax.random.PRNGKey(seed), T.PRNGKey(seed, device="cpu")
    _bits_equal(T.uniform(tkey, shape, -2.5, 3.7), jax.random.uniform(key, shape, minval=-2.5, maxval=3.7))
    _bits_equal(T.uniform(tkey, shape, 0.25, 0.5), jax.random.uniform(key, shape, minval=0.25, maxval=0.5))
    _bits_equal(T.gumbel(tkey, shape), jax.random.gumbel(key, shape))
    _bits_equal(T.normal(tkey, shape), jax.random.normal(key, shape))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", [(4,), (8, 4), (3, 5, 2), (64, 1000)])
def test_categorical_matches_jax(seed, shape):
    logits = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    logits[..., 0] = logits[..., -1]  # equal maxima: both take the first
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, logits))
    got = T.categorical(T.PRNGKey(seed, device="cpu"), torch.from_numpy(logits))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for axis in range(len(shape)):
        np.testing.assert_array_equal(T.categorical(T.PRNGKey(seed, device="cpu"), torch.from_numpy(logits),
                                                    axis=axis).numpy(),
                                      np.asarray(jax.random.categorical(key, logits, axis=axis)))


def test_batched_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    tkeys = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(np.int64))
    for name in ("gumbel", "normal"):
        want = jax.vmap(lambda k: getattr(jax.random, name)(k, (3, 4)))(keys)
        _bits_equal(getattr(T, name)(tkeys, (3, 4)), want)
    want = jax.vmap(lambda k: jax.random.uniform(k, (5,), minval=-1.0, maxval=4.0))(keys)
    _bits_equal(T.uniform(tkeys, (5,), -1.0, 4.0), want)
    with pytest.raises(ValueError, match="one"):
        T.categorical(tkeys, torch.zeros(6, 4))
