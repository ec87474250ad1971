"""jax's threefry2x32 PRNG in PyTorch, bit-equal to ``jax.random``.

Counterpart of the forms of ``jax.random`` that the policy step and the
object map use: ``PRNGKey``, ``split``, ``fold_in``, ``uniform`` (f32) and
``randint`` (int32). Pinned to jax 0.9.0 in its default configuration:
32-bit mode (``jax_enable_x64`` off) and ``jax_threefry_partitionable`` on.
In that mode (jax/_src/prng.py):

- a key is two uint32 words; ``PRNGKey(seed)`` is ``[0, seed mod 2^32]``
  (the seed is taken as a 32-bit integer, so the high word is 0);
- ``split(key, n)`` hashes the counters (hi, lo) = (0, i), i < n, and
  key i is the pair of hash words (``_threefry_split_foldlike``);
- ``fold_in(key, d)`` hashes the one counter (0, d mod 2^32)
  (``threefry_fold_in``);
- random bits of a shape hash the counters (0, i) over the flat iota of
  the shape and XOR the two words
  (``_threefry_random_bits_partitionable``);
- ``uniform`` puts the top 23 bits under the exponent of 1.0 and subtracts
  1 (``random._uniform``); ``randint`` draws two words from
  ``split(key)`` and reduces them modulo the span
  (``random._randint``).

Each uint32 word is held in an int64 whose upper 32 bits are zero, and
every add, shift and rotate is masked back to 32 bits (as in
``ops/bitpack.py``). Keys are explicit (..., 2) tensors passed by the
caller, so B lanes' keys go through one call; there is no global
generator.
"""

from __future__ import annotations

import torch

from vlfm_tpu_torch.device import default_device

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 holding uint32, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x[0] + x[1]) & M32
            x = [x0, _rotl(x[1], r) ^ x0]
        x = [(x[0] + ks[(i + 1) % 3]) & M32, (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32]
    return x[0], x[1]


def PRNGKey(seed: int | torch.Tensor, *, device: torch.device | str = default_device()) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (..., 2) int64 keys from integer seeds
    (a Python int, or an integer tensor of any shape, on its own device)."""
    if not torch.is_tensor(seed):
        seed = torch.full((), int(seed) & M32, dtype=torch.int64, device=device)
    lo = seed.to(torch.int64) & M32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def _hash_counters(key: torch.Tensor, counts: torch.Tensor):
    """Hash counters (0, counts) under each key: key (..., 2), counts of
    shape S; returns two (..., *S) words."""
    extra = (None,) * counts.ndim
    k1 = key[(..., 0, *extra)]
    k2 = key[(..., 1, *extra)]
    return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for each key: (..., 2) -> (..., num, 2)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    return torch.stack(_hash_counters(key, counts), dim=-1)


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: (..., 2) keys and integer data
    (an int, or a tensor that broadcasts against the keys' leading shape)."""
    if not torch.is_tensor(data):
        data = torch.full((), int(data) & M32, dtype=torch.int64, device=key.device)
    d = data.to(torch.int64) & M32
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element, (..., *shape) int64 holding uint32."""
    n = 1
    for d in shape:
        n *= d
    counts = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    b1, b2 = _hash_counters(key, counts)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 on [0, 1) for each key:
    (..., *shape). jax's scale to [0, 1) and its clamp at 0 leave these
    floats unchanged."""
    bits = random_bits(key, shape)
    float_bits = (bits >> 9) | 0x3F800000  # 32 - 23 mantissa bits; 1.0's exponent
    return float_bits.to(torch.int32).view(torch.float32) - 1.0


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for uint32 words, in 16-bit halves so nothing
    overflows int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    cross = ((a_hi * b_lo + a_lo * b_hi) & 0xFFFF) << 16
    return (a_lo * b_lo + cross) & M32


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for each
    key: (..., *shape). minval and maxval are Python ints in int32's range."""
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & M32
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & M32) % span  # uint32 products wrap
    offset = (_mul32(higher % span, torch.full((), multiplier, dtype=torch.int64, device=key.device))
              + lower % span) & M32
    offset = offset % span
    return (minval + offset).to(torch.int32)
