"""Exact masked median along the last axis.

Counterpart of ``vlfm_tpu/ops/median.py``. The JAX version selects the two
middle order statistics by radix bisection on float bit patterns, a TPU
workaround for slow small sorts; here a sort gives the same values.
"""

from __future__ import annotations

import torch


def masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of ``vals[valid]`` along the LAST axis; -1 where none valid.

    vals: (..., N) float, valid: (..., N) bool. Returns (...) float32: the
    exact (lo + hi) / 2 of the two middle valid values.
    """
    v = torch.where(valid, vals.to(torch.float32), torch.inf)
    srt = torch.sort(v, dim=-1).values
    n = valid.sum(dim=-1)
    k_lo = torch.clamp((n - 1) // 2, min=0)
    k_hi = torch.clamp(n // 2, min=0)
    lo = torch.gather(srt, -1, k_lo[..., None])[..., 0]
    hi = torch.gather(srt, -1, k_hi[..., None])[..., 0]
    med = (lo + hi) * 0.5
    return torch.where(n > 0, med, -1.0)
