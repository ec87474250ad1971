"""vlfm_tpu_torch's threefry against ``jax.random`` on the CPU, bit for bit.

Keys, splits, fold-ins, f32 uniforms and int32 randints from both, for
single keys and for a (B, 2) batch of keys against ``jax.vmap``. The port
is pinned to jax's default 32-bit mode with ``jax_threefry_partitionable``
on; the first test checks that the installed jax runs in that mode.
"""

import jax
import numpy as np
import pytest
import torch

from vlfm_tpu_torch.ops import threefry as T

SEEDS = [0, 1, 2**31 - 1, -1]


def _key(seed):
    return T.PRNGKey(seed, device="cpu")


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)


def test_jax_runs_in_the_pinned_mode():
    assert jax.config.jax_threefry_partitionable and not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    got = _key(seed)
    assert got.dtype == torch.int64
    _eq(got, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    _eq(T.split(_key(seed), num), jax.random.split(jax.random.PRNGKey(seed), num))


def test_fold_in_matches_jax():
    for seed in SEEDS:
        for step in (0, 1, 7, 12, 499, 2**31 - 1):
            _eq(T.fold_in(_key(seed), step), jax.random.fold_in(jax.random.PRNGKey(seed), step))
    # a split key folded in again, as the episode loop derives step keys
    k = T.split(_key(3), 4)[2]
    _eq(T.fold_in(k, 5), jax.random.fold_in(jax.random.split(jax.random.PRNGKey(3), 4)[2], 5))


@pytest.mark.parametrize("shape", [(512,), (3, 4)])
@pytest.mark.parametrize("seed", [0, 42])
def test_uniform_matches_jax(seed, shape):
    got = T.uniform(_key(seed), shape)
    assert got.dtype == torch.float32
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("lo,hi", [(0, 4), (-3, 1_000_003), (0, 7), (10, 10), (-(2**31), 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    for seed in (0, 9):
        got = T.randint(_key(seed), (64,), lo, hi)
        assert got.dtype == torch.int32
        _eq(got, jax.random.randint(jax.random.PRNGKey(seed), (64,), lo, hi))


def test_batched_keys_match_jax_vmap():
    """A (B, 2) batch of keys through every function in one call, against
    jax.vmap over the same keys; and a (B,) batch of seeds and steps."""
    seeds = np.array([0, 1, 5, 2**31 - 1, 77], np.int32)
    keys = T.PRNGKey(torch.from_numpy(seeds))
    jkeys = jax.vmap(jax.random.PRNGKey)(seeds)
    _eq(keys, jkeys)
    _eq(T.split(keys, 3), jax.vmap(lambda k: jax.random.split(k, 3))(jkeys))
    steps = np.array([0, 3, 8, 100, 2**20], np.int32)
    _eq(T.fold_in(keys, torch.from_numpy(steps)), jax.vmap(jax.random.fold_in)(jkeys, steps))
    got = T.uniform(keys, (6, 5))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (6, 5)))(jkeys))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    _eq(T.randint(keys, (9,), 0, 4), jax.vmap(lambda k: jax.random.randint(k, (9,), 0, 4))(jkeys))
    nested = T.split(keys, 2)  # (B, 2, 2): keys of keys
    _eq(T.randint(nested, (4,), 0, 5),
        jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (4,), 0, 5)))(jax.vmap(jax.random.split)(jkeys)))
