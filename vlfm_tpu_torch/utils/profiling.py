"""Tracing and step timing.

Counterpart of ``vlfm_tpu/utils/profiling.py``. The reference has no
systematic profiling (wall-clock prints only). Here:

- ``trace(logdir)``: ``torch.profiler`` around a block, the host and the
  card, written as a Chrome trace (Perfetto, ``chrome://tracing``);
- ``StepTimer``: named wall-clock sections, each ending in a synchronise of
  the card that holds the section's result, with summary percentiles;
- ``time_fn``: seconds per call of a callable, amortised over a few calls.

PyTorch returns before the card finishes, so a section or a call is timed
up to ``force_sync``, which waits for the card of the first CUDA tensor it
finds. A CPU tensor has nothing to wait for.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, supported_activities

from vlfm_tpu_torch.runner.checkpoint import map_tensors


def force_sync(tree) -> None:
    """Wait for the device work that feeds ``tree``'s tensors: a
    ``torch.cuda.synchronize`` of the card of its first CUDA tensor. With
    only CPU tensors (or none) there is nothing to wait for."""
    cards = []
    map_tensors(lambda t: cards.append(t.device) if t.is_cuda else None, tree)
    if cards:
        torch.cuda.synchronize(cards[0])


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` over the block: the host's ops and, where this
    PyTorch traces a card, its kernels. Yields the profiler
    (``key_averages()`` for sums by op and kernel) and writes
    ``logdir/trace.json`` (by default under the temporary directory) when
    the block ends."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "vlfm_tpu_torch_trace")
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA) if a in supported_activities()]
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Named wall-clock sections with a device sync at their end.
    ``sync_on`` may be any tensor on the card: the synchronise waits for
    all of the card's work, not only the work that feeds it."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                force_sync(sync_on)
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "count": len(xs),
                "mean_ms": statistics.mean(xs) * 1e3,
                "p50_ms": statistics.median(xs) * 1e3,
                "max_ms": max(xs) * 1e3,
            }
        return out


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``, amortised over ``iters`` calls
    after ``warmup`` ones, synchronised on the last call's result."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    force_sync(out)
    return (time.perf_counter() - t0) / iters
