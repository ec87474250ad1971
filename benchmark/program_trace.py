"""The program's own spans and counters over a few decisions after the trace.

The port keeps spans at its layer boundaries and counters of its work
(``vlfm_tpu_torch/utils/profiling.py``). After ``tracing.trace(ctx)`` the
readers of the program's metrics share one phase, run once per context:
the mix's ``trace.profiled`` decisions again, with the program's tracing
on and no profiler, so the host's times are those of a run at full speed
plus the spans' own cost. Per decision it keeps each span name's inclusive
host ms and the summed host ms of the ``vlfm.wait.*`` spans (the host
blocked on a device value), whose medians the readers give; over the phase
the counters' deltas and the K1 calls' bound seconds from their shapes, a
decision. A program without the spans (an older port) gives None, and so
does every reader of these metrics.
"""

from __future__ import annotations

import math
import statistics
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from benchmark.tracing import HBM_BYTES_PER_S

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
ROOTS = ("vlfm.dispatch", "vlfm.act")


def k1_cost(x_shape: Sequence[int], dtype: str, entry: str = "plain", h_shape: Optional[Sequence[int]] = None) -> float:
    """Bytes one K1 call must move (PERF.md §6's "Bound" column): the plain
    entry reads x and writes y (2 passes of the rows); the fused entry also
    reads h's rows and writes the sum when it keeps it (4 passes with the sum
    kept, 3 without, for an h of x's shape); the f32 scale and bias once."""
    d = x_shape[-1]
    rows = math.prod(x_shape) // d
    passes = 2 * rows
    if entry != "plain":
        passes += math.prod(h_shape) // d + (rows if entry == "add_keep_sum" else 0)
    return float(ITEMSIZE[dtype] * passes * d + 2 * 4 * d)


def k1_bound_s(attrs: dict) -> float:
    """Seconds at HBM's rate for the ``vlfm.K1`` span's attrs."""
    x, h = attrs["x"], attrs.get("h")
    return k1_cost(x["shape"], x["dtype"], attrs["entry"], h["shape"] if h else None) / HBM_BYTES_PER_S


@dataclass
class ProgramTrace:
    decision_ms: List[float]  # each decision on the driver's host clock
    host_ms: Dict[str, List[float]]  # each decision's inclusive host ms by span name
    wait_ms: List[float]  # each decision's vlfm.wait.* spans together
    counters: Dict[str, float]  # deltas a decision, over all of them
    k1_bound_s: float  # a decision, over all of them

    def median_ms(self, name: str) -> Optional[float]:
        """The median over the decisions: one slow decision (the host's own
        noise) moves it little."""
        return statistics.median(self.host_ms[name]) if name in self.host_ms else None


def record(ctx) -> Optional[ProgramTrace]:
    """The program-traced phase of ``ctx``, run at its first call and kept on
    ``ctx``; None where the program has no spans or none was recorded."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = _run(ctx)
    return ctx.program_trace


def _run(ctx) -> Optional[ProgramTrace]:
    import torch

    from vlfm_tpu_torch.utils import profiling

    if not all(hasattr(profiling, f) for f in ("tracing", "spans", "reset_spans", "counters")):
        return None
    n = int(ctx.cell.mix.get("trace", {}).get("profiled", 4))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    profiling.reset_spans()
    before = profiling.counters()
    walls = []
    with profiling.tracing():
        for _ in range(n):
            _, (a, b) = ctx.driver.decide()
            walls.append(1e3 * (b - a))
    after = profiling.counters()
    recs = profiling.spans()
    roots = [r for r in recs if r.parent is None and r.name in ROOTS]
    if len(roots) != n:
        return None
    index = {r.decision: k for k, r in enumerate(sorted(roots, key=lambda r: r.start_ns))}
    host: Dict[str, List[float]] = {}
    wait = [0.0] * n
    bound = 0.0
    for r in recs:
        k = index.get(r.decision)
        if k is None:
            continue
        ms = (r.end_ns - r.start_ns) / 1e6
        host.setdefault(r.name, [0.0] * n)[k] += ms
        if r.name.startswith("vlfm.wait."):
            wait[k] += ms
        elif r.name == "vlfm.K1":
            bound += k1_bound_s(r.attrs)
    pt = ProgramTrace(decision_ms=walls, host_ms=host, wait_ms=wait,
                      counters={k: (after.get(k, 0) - before.get(k, 0)) / n for k in after}, k1_bound_s=bound / n)
    root = host[roots[0].name]
    kids = {r.name for r in recs if r.parent == roots[0].id}
    cover = [100 * a / b for a, b in zip(root, walls)]
    parts = [100 * sum(host[c][k] for c in kids) / root[k] for k in range(n)]
    print(f"[program] {n} decisions traced by the program, {len(recs) / n:.1f} spans each; {roots[0].name} covers "
          f"{min(cover):.1f}-{max(cover):.1f} % of each decision ({', '.join(f'{w:.1f}' for w in walls)} ms), its "
          f"children {min(parts):.1f}-{max(parts):.1f} % of it; median host ms "
          f"{ {k: round(pt.median_ms(k), 3) for k in sorted(host)} }, waits {statistics.median(wait):.3f}; counters a "
          f"decision {pt.counters}", file=sys.stderr)
    return pt


def host_ms(ctx, name: str) -> Optional[float]:
    """The median over the phase's decisions of ``name``'s host ms."""
    pt = record(ctx)
    return None if pt is None else pt.median_ms(name)


def wait_ms(ctx) -> Optional[float]:
    """The median over the phase's decisions of the wait spans' host ms."""
    pt = record(ctx)
    return None if pt is None else statistics.median(pt.wait_ms)


def counted(ctx, name: str) -> Optional[float]:
    """The counter's delta a decision over the phase."""
    pt = record(ctx)
    return None if pt is None else pt.counters.get(name, 0.0)


def k1_roofline(ctx) -> Optional[float]:
    """100 x K1's bound seconds a decision (the program-traced phase) over
    K1's device seconds a profiled decision (``vlfm.K1`` in the trace)."""
    pt, tr = record(ctx), ctx.trace
    device_s = tr.span_device_s.get("vlfm.K1", 0.0) if tr and tr.decisions else 0.0
    if pt is None or pt.k1_bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * pt.k1_bound_s / (device_s / tr.decisions)
