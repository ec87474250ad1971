"""Where the port's entry points put their tensors unless told otherwise.

Every public constructor of the port (models' ``init_random`` and
``from_jax_params``, the maps' and the acyclic enforcer's ``create``,
``GridSpec2D.zeros``) defaults to the card. A caller who wants the CPU,
as the CPU tests do, passes ``device="cpu"``. Nothing in the port moves to
the CPU on its own: without a card, a call that does not name the CPU
fails with PyTorch's own error.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device every public constructor of the port defaults to."""
    return torch.device("cuda")
