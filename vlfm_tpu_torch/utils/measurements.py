"""Episode measurements: the port's copy of ``vlfm_tpu/utils/measurements.py``.

Parity target: vlfm/measurements/traveled_stairs.py — flags an episode whose
vertical travel (z peak-to-peak over the pose history) exceeds 0.9 m; used by
the failure-cause taxonomy to distinguish stair episodes.
"""

from __future__ import annotations

from typing import List

STAIR_PEAK_TO_PEAK_M = 0.9


class TraveledStairs:
    def __init__(self) -> None:
        self._z: List[float] = []

    def reset(self) -> None:
        self._z.clear()

    def update(self, position_z: float) -> None:
        self._z.append(float(position_z))

    @property
    def traveled_stairs(self) -> bool:
        if not self._z:
            return False
        return (max(self._z) - min(self._z)) > STAIR_PEAK_TO_PEAK_M
