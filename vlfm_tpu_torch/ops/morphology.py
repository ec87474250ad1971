"""Binary morphology with square structuring elements.

Counterpart of ``vlfm_tpu/ops/morphology.py`` (which replaces cv2.dilate /
cv2.erode: obstacle_map.py:105-109,125,159-163). A dilation by a (k, k)
ones kernel is a (k, k) max filter with SAME padding, which here is one
zero pad and two separable max pools over the mask as f32 0/1 values
(exact). Even k pads one more cell after than before, as XLA's SAME
padding does. Erosion is the complement of the complement's dilation, so
cells outside the mask count as set, as in cv2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Binary dilation of a 2-D bool mask with a (k, k) ones kernel."""
    if k <= 1:
        return mask
    lo = (k - 1) // 2
    hi = k - 1 - lo
    x = F.pad(mask.to(torch.float32)[None, None], (lo, hi, lo, hi))
    x = F.max_pool2d(x, (1, k), stride=1)
    x = F.max_pool2d(x, (k, 1), stride=1)
    return x[0, 0] > 0


def erode(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Binary erosion with a (k, k) ones kernel (set padding, like cv2)."""
    if k <= 1:
        return mask
    return ~dilate(~mask, k)


def erode_repeated_3x3(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """cv2.erode(kernel=None, iterations=n): n 3x3 erosions, which equal one
    (2n+1, 2n+1) erosion."""
    if iterations <= 0:
        return mask
    return erode(mask, 2 * iterations + 1)


def max_pool_downsample(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """Coarsen a bool mask: any set pixel in a (factor, factor) tile sets it."""
    h, w = mask.shape
    return mask.reshape(h // factor, factor, w // factor, factor).any(dim=3).any(dim=1)


def upsample_nearest(mask: torch.Tensor, factor: int) -> torch.Tensor:
    return mask.repeat_interleave(factor, dim=0).repeat_interleave(factor, dim=1)
