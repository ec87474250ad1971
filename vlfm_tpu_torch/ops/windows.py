"""Window-local read/modify/write helpers over padded map storage.

Counterpart of ``vlfm_tpu/ops/windows.py``. Per-step map updates touch only
a fixed (window x window) region around the camera. Start indices follow
``jax.lax.dynamic_slice`` and ``dynamic_update_slice``: a negative start
counts from the end of the axis, then the start is clamped so the window
lies inside the tensor. Maps are stored padded (``GridSpec2D.pad``), so
neither rule acts while the camera is on the map.

The centre is read to the host (one small device-to-host copy per call):
slicing a tensor needs Python ints.
"""

from __future__ import annotations

import torch


def _axis_start(center: int, window: int, size: int) -> int:
    start = center - window // 2
    if start < 0:
        start += size
    return min(max(start, 0), size - window)


def _start(center_storage_rc: torch.Tensor, window: int, shape) -> tuple[int, int]:
    r, c = (int(v) for v in center_storage_rc.tolist())
    return _axis_start(r, window, shape[0]), _axis_start(c, window, shape[1])


def read_window(arr: torch.Tensor, center_storage_rc: torch.Tensor, window: int) -> torch.Tensor:
    """(window, window[, C]) view of ``arr`` centred at ``center_storage_rc``."""
    r0, c0 = _start(center_storage_rc, window, arr.shape)
    return arr[r0 : r0 + window, c0 : c0 + window]


def write_window(arr: torch.Tensor, block: torch.Tensor, center_storage_rc: torch.Tensor) -> torch.Tensor:
    """Write ``block`` into ``arr`` IN PLACE at the window centred at
    ``center_storage_rc``, and return ``arr``.

    Unlike the JAX version, which returns a new array, this mutates the state
    tensor: a map is tens of MB and the window a small part of it.
    """
    window = block.shape[0]
    r0, c0 = _start(center_storage_rc, window, arr.shape)
    arr[r0 : r0 + window, c0 : c0 + window] = block
    return arr
