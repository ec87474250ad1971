"""Shared top-down grid conventions for all episodic maps.

Counterpart of ``vlfm_tpu/mapping/grid.py`` (same frozen fields, same
world -> pixel convention):

    row = round(x * pixels_per_meter) + origin_row
    col = origin_col - round(y * pixels_per_meter)

The stored tensor is padded by ``pad`` pixels on every side so that
window-local updates around the camera never clamp while the camera is
inside the logical map.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vlfm_tpu_torch.device import default_device


@dataclass(frozen=True)
class GridSpec2D:
    """Static description of an episodic top-down grid."""

    size: int = 1024  # logical H == W, pixels
    pixels_per_meter: int = 20
    pad: int = 160  # storage padding per side, >= splat_window//2

    @property
    def storage_size(self) -> int:
        return self.size + 2 * self.pad

    @property
    def origin(self) -> int:
        """Pixel of world (0, 0) in logical coordinates (row == col)."""
        return self.size // 2

    # --- world <-> logical pixel ------------------------------------------------
    def xy_to_px(self, xy: torch.Tensor) -> torch.Tensor:
        """(..., 2) world meters -> (..., 2) int32 (row, col), logical frame."""
        x, y = xy[..., 0], xy[..., 1]
        row = torch.round(x * self.pixels_per_meter).to(torch.int32) + self.origin
        col = self.origin - torch.round(y * self.pixels_per_meter).to(torch.int32)
        return torch.stack([row, col], dim=-1)

    def px_to_xy(self, rc: torch.Tensor) -> torch.Tensor:
        """(..., 2) (row, col) logical pixels -> (..., 2) world meters."""
        row = rc[..., 0].to(torch.float32)
        col = rc[..., 1].to(torch.float32)
        x = (row - self.origin) / self.pixels_per_meter
        y = (self.origin - col) / self.pixels_per_meter
        return torch.stack([x, y], dim=-1)

    # --- logical <-> storage ----------------------------------------------------
    def to_storage(self, rc: torch.Tensor) -> torch.Tensor:
        return rc + self.pad

    def in_bounds(self, rc: torch.Tensor) -> torch.Tensor:
        return torch.all((rc >= 0) & (rc < self.size), dim=-1)

    def crop_logical(self, arr: torch.Tensor) -> torch.Tensor:
        """Strip padding: storage tensor -> logical (size, size[, C]) view."""
        return arr[self.pad : self.pad + self.size, self.pad : self.pad + self.size]

    def zeros(
        self,
        dtype: torch.dtype = torch.float32,
        channels: int | None = None,
        *,
        device: torch.device | str = default_device(),
    ) -> torch.Tensor:
        s = self.storage_size
        shape = (s, s) if channels is None else (s, s, channels)
        return torch.zeros(shape, dtype=dtype, device=device)
