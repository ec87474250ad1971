"""Window-local read/modify/write helpers over padded, batched map storage.

Counterpart of ``vlfm_tpu/ops/windows.py``. Per-step map updates touch only
a fixed (window x window) region around each lane's camera. Start indices
follow ``jax.lax.dynamic_slice`` and ``dynamic_update_slice`` per lane: a
negative start counts from the end of the axis, then the start is clamped
so the window lies inside the map. Maps are stored padded
(``GridSpec2D.pad``), so neither rule acts while the camera is on the map.

Maps are square, ``(B, S, S[, C])``, and centres ``(B, 2)`` on the map's
device. ``window_index`` turns the centres into flat cell indices once;
every read (``index_select``) and write (``index_copy_``) at that centre
and window reuses them. The starts are tensor arithmetic, so nothing is
copied to the host.
"""

from __future__ import annotations

import torch


def window_starts(center_storage_rc: torch.Tensor, window: int, size: int) -> torch.Tensor:
    """(B, 2) int64 window starts for (B, 2) centres on a map of side
    ``size``, by dynamic_slice's rule."""
    start = center_storage_rc.to(torch.int64) - window // 2
    return torch.where(start < 0, start + size, start).clamp_(0, size - window)


def window_index(center_storage_rc: torch.Tensor, window: int, size: int) -> torch.Tensor:
    """(B, W, W) int64: where each lane's (window x window) block lies in a
    (B, S, S[, C]) map of side ``size`` flattened over its first three
    axes."""
    starts = window_starts(center_storage_rc, window, size)
    ar = torch.arange(window, device=starts.device)
    lanes = torch.arange(starts.shape[0], device=starts.device)[:, None]
    rows = (lanes * size + starts[:, 0:1] + ar) * size  # (B, W)
    cols = starts[:, 1:2] + ar  # (B, W)
    return rows[:, :, None] + cols[:, None, :]


def read_window(arr: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, W, W[, C]) copy of each lane's window of ``arr`` (B, S, S[, C])."""
    cells = arr.reshape(-1, *arr.shape[3:])
    return cells.index_select(0, index.reshape(-1)).reshape(*index.shape, *arr.shape[3:])


def write_window(arr: torch.Tensor, block: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Write ``block`` (B, W, W[, C]) into ``arr`` IN PLACE at each lane's
    window, and return ``arr``.

    Unlike the JAX version, which returns a new array, this mutates the state
    tensor: a map is tens of MB and the window a small part of it.
    """
    cells = arr.view(-1, *arr.shape[3:])  # a view, so the copy lands in ``arr``
    cells.index_copy_(0, index.reshape(-1), block.reshape(-1, *arr.shape[3:]))
    return arr
