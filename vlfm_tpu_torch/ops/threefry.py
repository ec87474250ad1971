"""jax's threefry2x32 PRNG in PyTorch, bit-equal to ``jax.random``.

Counterpart of the forms of ``jax.random`` that the policy step, the
object map and PointNav's stochastic heads use: ``PRNGKey``, ``split``,
``fold_in``, ``uniform`` (f32, with ``minval``/``maxval``), ``randint``
(int32), ``gumbel`` (mode "low"), ``categorical`` (with replacement) and
``normal`` (f32). Pinned to jax 0.9.0 in its default configuration:
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
- ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts
  1, scales to [minval, maxval) and clamps at minval (``random._uniform``);
  ``randint`` draws two words from ``split(key)`` and reduces them modulo
  the span (``random._randint``);
- ``gumbel`` is ``-log(-log(uniform(key, shape, tiny, 1)))``,
  ``categorical`` the argmax of ``gumbel + logits`` (the first of equal
  maxima), and ``normal`` ``sqrt(2) * erf_inv(uniform(key, shape,
  nextafter(-1, 0), 1))``.

The logarithm and ``erf_inv`` are not PyTorch's: XLA's CPU backend computes
``log`` with a Cephes polynomial, ``log1p`` with a Cephes rational form
below |x| < 0.4142, and ``erf_inv`` with Giles' single-precision
polynomial over ``log1p`` (as jax 0.9.0's XLA emits them), and LLVM fuses
a product into the sum that takes it where x86's FMA allows. ``xla_log``,
``xla_log1p`` and ``xla_erf_inv`` restate them op for op in f32, with
``fma`` (exact in f64, rounded to odd, then to f32) where the compiled
code has a fused multiply-add, so the draws are bit-equal to jax on the
CPU and the same bits on the card (IEEE products, sums, quotients and
square roots, each its own PyTorch op).

Each uint32 word is held in an int64 whose upper 32 bits are zero, and
every add, shift and rotate is masked back to 32 bits (as in
``ops/bitpack.py``). Keys are explicit (..., 2) tensors passed by the
caller, so B lanes' keys go through one call; there is no global
generator.
"""

from __future__ import annotations

import struct

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


def _f32(x: float, device) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-d tensor on ``device``: a fill, not a
    copy from host memory, so a CUDA graph can capture it."""
    return torch.full((), x, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in f32 on
    [minval, maxval) for each key: (..., *shape). The bounds are rounded to
    f32 first, ``maxval - minval`` is an f32 op and the scale and shift one
    fused multiply-add, as XLA compiles ``random._uniform``; on [0, 1) they
    leave the floats as they are."""
    bits = random_bits(key, shape)
    float_bits = (bits >> 9) | 0x3F800000  # 32 - 23 mantissa bits; 1.0's exponent
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def _hexf(word: str) -> float:
    """An f32 constant as XLA's emitted LLVM IR prints it (the double of
    the f32 value, in hex)."""
    return struct.unpack(">d", bytes.fromhex(word))[0]


# XLA's f32 log (Cephes): the mantissa's polynomial p0..p8 and ln 2 in two parts
_LOG_P = [_hexf(w) for w in ("3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000", "BFBFCBA9E0000000",
                             "3FC23D37E0000000", "BFC555CA00000000", "3FC999D580000000", "BFCFFFFF80000000",
                             "3FD5555540000000")]
_LOG_Q1, _LOG_Q2 = _hexf("BF2BD01060000000"), 0.693359375
_SQRT_HALF = _hexf("3FE6A09E60000000")
_MIN_NORMAL = 2.0**-126
# XLA's f32 log1p below |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x) (Cephes)
_LOG1P_SMALL = _hexf("3FDA8279A0000000")
_LOG1P_P = [_hexf(w) for w in ("3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
                               "404E798EC0000000", "404C8E75A0000000", "40340A2020000000")]
_LOG1P_Q = [_hexf(w) for w in ("402E2035A0000000", "4054C30B60000000", "406BB865A0000000", "4073519460000000",
                               "406B0DB140000000", "404E0F3040000000")]
# XLA's f32 erf_inv (Giles): the coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as a fused multiply-add: the
    product is exact in f64, the sum is rounded to odd there (TwoSum gives
    its error), and the f64 -> f32 cast then rounds as one f32 operation
    would. Tensors or Python floats, broadcast together."""
    a, b, c = (t.to(torch.float64) if torch.is_tensor(t) else t for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormals flushed to a zero of their sign, as XLA's CPU code runs
    (flush-to-zero and denormals-are-zero)."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 quotient, from f64 (whose rounding, then
    f32's, is innocuous for a quotient of f32s)."""
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of an f32 tensor as XLA's CPU backend computes it, bit
    for bit: the exponent split off, the mantissa m in [sqrt(1/2), sqrt(2))
    as z = m - 1, ``z - z^2/2 + z^3 P(z) + e ln 2``, with the fused
    multiply-adds LLVM forms from it. XLA reads a subnormal input as 0:
    0 gives -inf whatever its sign, +inf gives +inf, a negative or NaN
    input NaN."""
    x = _ftz(x)
    t = torch.where(x > _MIN_NORMAL, x, torch.full_like(x, _MIN_NORMAL))
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)  # sign and mantissa under 0.5's exponent
    below = m < _SQRT_HALF
    z = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(torch.float32)
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    a = fma(fma(z, p[0], p[1]), z, p[2])
    b = fma(fma(z, p[3], p[4]), z, p[5])
    c = fma(fma(z, p[6], p[7]), z, p[8])
    y = fma(fma(fma(a, z3, b), z3, c), z3, e * _LOG_Q1)
    out = fma(_LOG_Q2, e, fma(-0.5, z2, z) + y)
    out = torch.where(x > 0, out, torch.full_like(out, float("nan")))
    out = torch.where(x == 0, torch.full_like(out, float("-inf")), out)
    return torch.where(x == float("inf"), x, out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of an f32 tensor as XLA's CPU backend computes it:
    ``xla_log(x + 1)``, and below |x| < sqrt(2) - 1 the rational form
    ``x + (x^3 P(x)/Q(x) - x^2/2)`` (Horner steps and the last term as
    fused multiply-adds). Subnormals in and out flush to zero."""
    x = _ftz(x)
    x2 = x * x
    p = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    q = torch.ones_like(x)
    for c in _LOG1P_Q:
        q = fma(q, x, c)
    small = x + fma(-0.5, x2, (x * x2) * _div(p, q))
    return _ftz(torch.where(x.abs() < _LOG1P_SMALL, small, xla_log(x + 1.0)))


def xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of an f32 tensor as XLA computes it: w =
    -log1p(-x^2), a degree-8 polynomial (fused Horner steps) in w - 2.5
    (w < 5) or sqrt(w) - 3, times x; +-1 give +-inf. The square root is
    taken in f64 and rounded to f32, the correctly rounded f32 root (the
    CPU's f32 ``torch.sqrt`` is not, in the last bit). Subnormals in and
    out flush to zero."""
    x = _ftz(x)
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w + -2.5, torch.sqrt(w.to(torch.float64)).to(torch.float32) + -3.0)
    coeff = [torch.where(lt, _f32(a, x.device), _f32(b, x.device)) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coeff[0]
    for c in coeff[1:]:
        p = fma(p, w, c)
    return _ftz(x * torch.where(x.abs() == 1.0, torch.full_like(p, float("inf")), p))


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (f32, mode "low") for each key:
    (..., *shape)."""
    u = uniform(key, shape, minval=float(torch.finfo(torch.float32).tiny), maxval=1.0)
    return -xla_log(-xla_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` with replacement and
    ``shape=None``, for one (2,) key: the argmax over ``axis`` of
    ``gumbel(key, logits.shape) + logits`` (int64; the first of equal
    maxima, as ``jnp.argmax``)."""
    if key.shape != (2,):
        raise ValueError(f"categorical takes one (2,) key, got {tuple(key.shape)}")
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits.to(torch.float32), dim=axis)


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32 for each key: (..., *shape)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, minval=lo, maxval=1.0)
    return _f32(2.0**0.5, key.device) * xla_erf_inv(u)


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
