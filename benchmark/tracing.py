"""The traced part of a ``--trace 1`` run and the arithmetic over its trace.

After the measured window (which ``--trace 1`` runs as ``--trace 0`` does,
so ``mfu`` divides by an unprofiled window), a run profiles ``profiled``
more decisions under ``torch.profiler`` (CPU and CUDA activities), each in
a ``decision`` span, with the driver's spans inside (``perception.itm``,
``perception.pipeline``) and, around each call of the
K2 and K3 kernels, a ``kernel.K2`` / ``kernel.K3`` span that also records
the call's shapes. Then ``sync_counted`` decisions run under
``torch.cuda.set_sync_debug_mode("warn")`` and count the warnings
(the arithmetic of ``chip_smoke.py``'s ``host_syncs``).

A device activity (kernel, copy, set) belongs to a span when the runtime
call that launched it (linked by CUPTI's correlation id) lies inside the
span on the host. The traced window runs from the first decision's start
to the last one's end; busy time is the union of the device activities'
intervals inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense: FLOP/s by compute dtype, HBM3 bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_SPANS = ("kernel.K2", "kernel.K3")


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals:
    overlaps count once (``chip_smoke.py``'s ``busy_ms``)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def roofline_seconds(n_bytes: float, n_flops: float, dtype: str) -> float:
    """The least time the card could take: bytes over HBM's rate or
    operations over the dtype's peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_FLOPS[dtype])


def k2_cost(x_shape, w1_shape, w3_shape, itemsize: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one MBConv chain (K2): x (B, H, W, Cin) -> 1x1 to
    Ch -> 3x3 depthwise -> 1x1 to Cout; x read once, the output written
    once, the weights read once."""
    b, h, w, cin = x_shape
    ch, cout = w1_shape[1], w3_shape[1]
    px = b * h * w
    weights = cin * ch + 9 * ch + ch * cout + 2 * ch + cout
    return float(itemsize * (px * cin + px * cout + weights)), float(2 * px * (cin * ch + 9 * ch + ch * cout))


def k3_cost(q_shape, lk: int, itemsize: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one attention call (K3): q, k, v read once, the
    output written once; QK^T and PV."""
    b, h, lq, d = q_shape
    return float(itemsize * b * h * (2 * lq * d + 2 * lk * d)), float(4 * b * h * lq * lk * d)


@dataclass
class Trace:
    decisions: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    activities: int = 0
    linked: int = 0
    span_device_s: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)  # name -> [(bound s, time s)]
    syncs: Optional[float] = None
    kinds: Dict[str, int] = field(default_factory=dict)  # profiler events by activity type


@dataclass
class Context:
    cell: object
    driver: object
    window: object
    setup_s: float
    record: dict
    trace: Optional[Trace] = None
    breakdown: Optional[dict] = None
    flops: Optional[List[Tuple[float, str]]] = None


def _dtype(t) -> str:
    return str(t.dtype).rpartition(".")[2]


@contextlib.contextmanager
def kernel_spans(calls: Dict[str, List[Tuple[float, float]]]):
    """Wrap every binding of the port's K2 and K3 entry points in the
    loaded ``vlfm_tpu_torch`` modules with a span that records each call's
    (bytes, FLOPs), and put them back after."""
    import torch

    try:
        from vlfm_tpu_torch.ops import attention as k3_mod, conv_fused as k2_mod
    except ImportError:
        yield
        return

    def k2(fn):
        def wrapped(x, w1, b1, w2, b2, w3, b3, **kw):
            calls.setdefault("kernel.K2", []).append(
                (*k2_cost(tuple(x.shape), tuple(w1.shape), tuple(w3.shape), x.element_size()), _dtype(x)))
            with torch.profiler.record_function("kernel.K2"):
                return fn(x, w1, b1, w2, b2, w3, b3, **kw)
        return wrapped

    def k3(fn):
        def wrapped(q, k, v, **kw):
            calls.setdefault("kernel.K3", []).append((*k3_cost(tuple(q.shape), k.shape[2], q.element_size()), _dtype(q)))
            with torch.profiler.record_function("kernel.K3"):
                return fn(q, k, v, **kw)
        return wrapped

    targets = [(getattr(k2_mod, "mbconv_chain", None), k2), (getattr(k3_mod, "attention", None), k3)]
    patched = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("vlfm_tpu_torch.") or mod is None:
            continue
        for attr, value in list(vars(mod).items()):
            for fn, wrap in targets:
                if fn is not None and value is fn and name not in ("vlfm_tpu_torch.ops.attention",
                                                                   "vlfm_tpu_torch.ops.conv_fused"):
                    setattr(mod, attr, wrap(fn))
                    patched.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def count_syncs(driver, n: int) -> float:
    """Host synchronisations per decision over ``n`` decisions."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                driver.decide()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught) / n


def _innermost(starts, events, t: float, limit: int = 4000) -> str:
    """Name of the latest-starting host event that contains ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - limit, -1), -1):
        s, e, name = events[j]
        if e >= t:
            return name
    return "host"


# The benchmark's spans: "decision" around each timed call, "<layer>.<call>"
# around the calls into a layer (perception.itm, perception.pipeline) and
# "kernel.<name>" around each call of a hand-written kernel.
LAYER_PREFIXES = ("perception.", "monodepth.")


def is_span(name: str) -> bool:
    return name == "decision" or name.startswith(LAYER_PREFIXES + ("kernel.",))


def _kind(e) -> str:
    """device (a kernel, copy or set on the card), runtime (a CUDA API call on
    the host), user_annotation (a span), cpu_op, or other. Uses the event's
    activity type where this PyTorch has it, its device and name elsewhere."""
    act = e.activity_type() if hasattr(e, "activity_type") else None
    on_device = "CUDA" in str(e.device_type())
    if act is not None:
        if act in DEVICE_KINDS:
            return "device"
        if act in ("cuda_runtime", "cuda_driver"):
            return "runtime"
        if act in ("user_annotation", "cpu_op"):
            return act
        return "other"
    name = e.name()
    annotation = e.is_user_annotation() if hasattr(e, "is_user_annotation") else is_span(name)
    if on_device:
        return "other" if annotation or is_span(name) else "device"
    if annotation:
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "runtime"
    return "cpu_op"


def _link(e, runtime) -> Optional[int]:
    """The host time of the runtime call that launched a device activity."""
    for corr in (e.correlation_id(), e.linked_correlation_id() if hasattr(e, "linked_correlation_id") else None):
        if corr and corr in runtime:
            return corr
    return None


def analyse(prof, decisions: int, calls: Dict[str, List[Tuple[float, float]]]):
    """(Trace, breakdown) from a finished ``torch.profiler.profile``."""
    evs = prof.profiler.kineto_results.events()
    host, device, runtime = [], [], {}
    kinds: Dict[str, int] = {}
    for e in evs:
        kind = _kind(e)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "device":
            device.append(e)
        elif kind == "runtime":
            runtime[e.correlation_id()] = e.start_ns()
        elif kind in ("cpu_op", "user_annotation"):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), kind == "user_annotation"))
    spans = [(s, t, n) for s, t, n, ann in host if ann]
    dec = sorted((s, t) for s, t, n in spans if n == "decision")
    tr = Trace(decisions=decisions, kinds=kinds)
    if not dec:
        return tr, None
    w0, w1 = dec[0][0], dec[-1][1]
    tr.window_s = (w1 - w0) / 1e9
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), _link(e, runtime)) for e in device]
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    tr.activities = len(dev)
    busy = merged([(max(s, w0), min(t, w1)) for s, t, _, _ in dev])
    tr.busy_s = sum(t - s for s, t in busy) / 1e9
    by_name: Dict[str, List[Tuple[int, int]]] = {}
    for s, t, n in spans:
        by_name.setdefault(n, []).append((s, t))
    for n in by_name:
        by_name[n].sort()
    kernel_time: Dict[str, List[float]] = {}
    span_s: Dict[str, float] = {}
    for s, t, name, corr in dev:
        launch = runtime.get(corr)
        if launch is None:
            continue
        tr.linked += 1
        for n, ivs in by_name.items():
            i = bisect.bisect_right(ivs, (launch, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= launch <= ivs[i][1]:
                span_s[n] = span_s.get(n, 0.0) + (t - s) / 1e9
                if n in KERNEL_SPANS:
                    kernel_time.setdefault(n, [0.0] * len(ivs))[i] += (t - s) / 1e9
    tr.span_device_s = span_s
    for n, times in kernel_time.items():
        bounds = calls.get(n, [])
        if len(bounds) == len(times):
            tr.kernel_calls[n] = [(roofline_seconds(b, f, dt), tm) for (b, f, dt), tm in zip(bounds, times)]
    # breakdown: the device's largest operations, and its idle gaps by what the host was doing
    op_s: Dict[str, float] = {}
    for s, t, name, _ in dev:
        op_s[name] = op_s.get(name, 0.0) + (t - s) / 1e9
    ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    thread_events = sorted((s, t, n) for s, t, n, _ in host if s >= w0 and s <= w1)
    starts = [s for s, _, _ in thread_events]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:400]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        label = _innermost(starts, thread_events, (a + b) / 2)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    breakdown = {"device_ops": [[n, v] for n, v in ops],
                 "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
    return tr, breakdown


def trace(ctx: Context) -> None:
    """Profile the mix's ``profiled`` decisions, count syncs over
    ``sync_counted`` more, and fill ``ctx.trace``, ``ctx.breakdown``,
    ``ctx.flops`` and the device record's ``busy_s`` / ``window_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    plan = ctx.cell.mix.get("trace", {})
    n = int(plan.get("profiled", 4))
    calls: Dict[str, List[Tuple[float, float, str]]] = {}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    ctx.driver.decide()  # one decision between the window and the trace, outside both
    with kernel_spans(calls):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(n):
                ctx.driver.decide()  # the driver opens its "decision" span around what it times
    tr, ctx.breakdown = analyse(prof, n, calls)
    if torch.cuda.is_available():
        tr.syncs = count_syncs(ctx.driver, int(plan.get("sync_counted", 2)))
    print(f"[trace] {n} decisions, window {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s, {tr.activities} device "
          f"activities ({tr.linked} linked to a launch), spans {sorted(tr.span_device_s)}, kernel calls "
          f"{ {k: len(v) for k, v in calls.items()} }, events by kind {tr.kinds}", file=sys.stderr)
    ctx.trace = tr
    ctx.flops = ctx.driver.flops_per_decision()
    ctx.record["busy_s"] = tr.busy_s
    ctx.record["window_s"] = tr.window_s


# --- what the metric readers share -----------------------------------------------------


def per_decision(ctx: Context, total) -> Optional[float]:
    tr = ctx.trace
    if not tr or total is None or tr.decisions == 0 or tr.activities == 0:
        return None
    return total / tr.decisions


def span_ms(ctx: Context, prefix: str) -> Optional[float]:
    """Device ms per traced decision launched inside the spans whose names
    start with ``prefix`` (a layer's, such as "perception."); None where
    none of them ran."""
    tr = ctx.trace
    names = [n for n in tr.span_device_s if n.startswith(prefix)] if tr else []
    if not names:
        return None
    return per_decision(ctx, 1e3 * sum(tr.span_device_s[n] for n in names))


def step_ms(ctx: Context) -> Optional[float]:
    tr = ctx.trace
    if not tr or "decision" not in tr.span_device_s:
        return None
    rest = sum(v for n, v in tr.span_device_s.items() if n.startswith(LAYER_PREFIXES))
    return per_decision(ctx, 1e3 * (tr.span_device_s["decision"] - rest))


def roofline_share(ctx: Context, span: str) -> Optional[float]:
    """100 x the calls' bound seconds over their kernel seconds; None where
    the kernel did not run or its calls could not be matched to the trace."""
    tr = ctx.trace
    calls = tr.kernel_calls.get(span) if tr else None
    if not calls or sum(t for _, t in calls) <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(t for _, t in calls)


def mfu(ctx: Context) -> Optional[float]:
    if not ctx.flops or ctx.window.seconds <= 0:
        return None
    per = sum(f / PEAK_FLOPS[dt] for f, dt in ctx.flops)
    return 100.0 * per * len(ctx.window.starts) / ctx.window.seconds


def idle_share(ctx: Context) -> Optional[float]:
    """100 x (1 - device busy seconds per decision / wall seconds per
    decision): the busy time from the trace, the wall time from the
    unprofiled window, since the profiler slows the host (about twice at
    8 lanes) and would count its own time as the device's idle."""
    tr, w = ctx.trace, ctx.window
    busy = per_decision(ctx, tr.busy_s) if tr else None
    if busy is None or w.seconds <= 0 or not w.starts:
        return None
    return 100.0 * (1.0 - busy / (w.seconds / len(w.starts)))
