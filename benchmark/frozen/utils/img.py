"""Image utilities on the device.

Counterpart of ``vlfm_tpu/utils/img.py``: the reference's torch
``image_resize`` (obs_transformers/utils.py:9-48, mode 'area') as an
anti-aliased linear resample, two dense interpolation matmuls in f32
(``ops/resize.py``). The matmuls follow
``torch.backends.cuda.matmul.allow_tf32``, which PyTorch leaves off; a
caller that turns it on gets TF32 depth here.
"""

from __future__ import annotations

import torch

from benchmark.frozen.ops.resize import resize_bilinear_hw


def resize_area(img: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Resize (B, H, W) images to the spatial ``shape``."""
    return resize_bilinear_hw(img, shape[0], shape[1])
