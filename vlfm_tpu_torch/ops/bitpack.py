"""Bit-packed binary masks: 32 grid columns per 32-bit word.

Counterpart of ``vlfm_tpu/ops/bitpack.py``. The JAX words are ``uint32``;
most PyTorch ops do not take ``torch.uint32``, and ``>>`` on ``int32`` is
an arithmetic shift, so the port holds each 32-bit word in an ``int64``
whose upper 32 bits are zero. Every left shift and complement is masked
back to 32 bits, so shifts are logical and bit 31 behaves as in uint32.

- vertical neighbours: row rolls, which WRAP at the edges like
  ``jnp.roll`` (the wrapped rows land in the always-empty storage padding,
  see GridSpec2D);
- horizontal neighbours: in-word shifts with cross-word carries, the
  carries rolled across the row with the same wrap.
"""

from __future__ import annotations

import torch

WORD_MASK = 0xFFFFFFFF


def _bit_weights(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_cols(mask: torch.Tensor) -> torch.Tensor:
    """(S, C) bool -> (S, C//32) words; bit b of word w is column w*32+b."""
    s, c = mask.shape
    assert c % 32 == 0, c
    bits = mask.reshape(s, c // 32, 32).to(torch.int64)
    return (bits << _bit_weights(mask.device)).sum(dim=-1)


def unpack_cols(packed: torch.Tensor, cols: int) -> torch.Tensor:
    s, w = packed.shape
    bits = (packed[:, :, None] >> _bit_weights(packed.device)) & 1
    return bits.reshape(s, w * 32)[:, :cols].to(torch.bool)


def invert(words: torch.Tensor) -> torch.Tensor:
    """Bitwise NOT of 32-bit words."""
    return ~words & WORD_MASK


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word (SWAR), as int64."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD_MASK) >> 24


def dilate8_packed(cur: torch.Tensor) -> torch.Tensor:
    """One 8-connected dilation sweep on packed words. k sweeps give a
    (2k+1)x(2k+1) square dilation."""
    n = cur | torch.roll(cur, -1, dims=0) | torch.roll(cur, 1, dims=0)
    carry_lo = torch.roll(n, 1, dims=1) >> 31  # bit 31 of word w-1 -> bit 0
    carry_hi = (torch.roll(n, -1, dims=1) << 31) & WORD_MASK  # bit 0 of word w+1 -> bit 31
    return n | ((n << 1) & WORD_MASK) | carry_lo | (n >> 1) | carry_hi


def first_set_bits_packed(mask_p: torch.Tensor, size: int):
    """(rows, cols, valid) of the first ``size`` set bits, row-major order.

    A popcount prefix over the words, a search for each wanted bit's word,
    then its rank within the word. Invalid entries are 0."""
    s, w = mask_p.shape
    dev = mask_p.device
    prefix = torch.cumsum(popcount(mask_p).reshape(-1), 0)
    total = prefix[-1]
    targets = torch.arange(1, size + 1, dtype=torch.int64, device=dev)
    widx = torch.searchsorted(prefix, targets)  # side="left"
    valid = targets <= total
    widx_c = torch.where(valid, widx, 0)
    before = torch.where(widx_c > 0, prefix[torch.clamp(widx_c - 1, min=0)], 0)
    rank = targets - before  # 1-based rank of the wanted bit within its word
    words = mask_p.reshape(-1)[widx_c]
    bits = (words[:, None] >> _bit_weights(dev)) & 1
    # the rank-th set bit sits where the running count first reaches rank
    bitpos = (torch.cumsum(bits, dim=1) < rank[:, None]).sum(dim=1)
    rows = widx_c // w
    cols = (widx_c % w) * 32 + bitpos
    return torch.where(valid, rows, 0), torch.where(valid, cols, 0), valid


def flood_packed(
    mask_p: torch.Tensor, seed_p: torch.Tensor, max_iters: int = 2048, check_every: int = 16
) -> torch.Tensor:
    """Geodesic flood on packed masks (both (S, W) words): dilate-and-mask
    sweeps until nothing changes, checked (one host read) every
    ``check_every`` sweeps, for at most ``max_iters`` sweeps rounded up to a
    whole check, as the JAX while_loop runs them."""
    cur = seed_p & mask_p
    i = 0
    while i < max_iters:
        nxt = cur
        for _ in range(check_every):
            nxt = dilate8_packed(nxt) & mask_p
        changed = bool((nxt != cur).any())
        cur = nxt
        i += check_every
        if not changed:
            break
    return cur
