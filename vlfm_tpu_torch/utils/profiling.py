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

The program's own spans and counters live here too:

- ``span(name, **attrs)``: a span around a layer's call. It is on inside
  ``tracing()`` or while a ``torch.profiler`` records; then it keeps a
  record (name, start and end on the profiler's host clock, its parent's
  id, its root's ``decision`` id, ``attrs`` with each tensor given as its
  shape and dtype) in a bounded ring, and under a profiler it is also a
  ``record_function`` annotation of the same name. Off, it is one flag
  check and one profiler check. Every name starts with ``vlfm.``; a
  ``vlfm.wait.<site>`` span holds one host read of a device value, so its
  duration is the time the host blocked for the device.
- ``count(name, n=1)``, ``counters()``, ``reset_counters()``: host integers,
  always counted, such as ``K1.launches`` or ``sam.passes``;
  ``device_counter(name, device)``: the counter's int64 accumulator on a
  device, which a kernel adds into (``map.sweeps`` from the flood and
  labelling kernels), so a CUDA graph's replays count too. ``counters()``
  adds each accumulator to its host count: one read a device, only when it
  is called.
- ``spans()``, ``reset_spans()`` and ``write_spans(path)`` (a Chrome trace
  of the kept spans and the counters, for Perfetto).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import tempfile
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

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


# --- the program's spans and counters -------------------------------------------------

SPAN_CAPACITY = 1 << 16
_profiler_enabled = torch._C._autograd._profiler_enabled
_counters: Dict[str, int] = defaultdict(int)
_device_counters: Dict[tuple, torch.Tensor] = {}


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # the profiler's host clock (time.time_ns)
    end_ns: int
    id: int
    parent: Optional[int]  # the enclosing span's id; None for a root
    decision: Optional[int]  # the root span's ``decision`` attr
    thread: int
    attrs: Dict[str, Any]


class _OpenSpans(threading.local):
    """Per thread: the open spans. The ring of kept spans and their ids are
    the process's (``_Ring``)."""

    def __init__(self):
        self.stack: List["_Span"] = []


class _Ring:
    def __init__(self):
        self.records: deque = deque(maxlen=SPAN_CAPACITY)
        self.ids = itertools.count()
        self.lock = threading.Lock()


class _Null:
    """The span of a run with tracing off: enters and leaves, and keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_on = False
_ring = _Ring()
_open = _OpenSpans()
_NULL = _Null()


def _attr(v):
    if isinstance(v, torch.Tensor):
        return {"shape": list(v.shape), "dtype": str(v.dtype).rpartition(".")[2]}
    return v


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "decision", "t0", "rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _open.stack
        parent = stack[-1] if stack else None
        self.id = next(_ring.ids)
        self.parent = None if parent is None else parent.id
        decision = self.attrs.pop("decision", None)
        self.decision = decision if parent is None else parent.decision
        stack.append(self)
        self.rf = None
        if _profiler_enabled():
            # The annotation stamps its start inside __enter__: the midpoint
            # of the stamps around it is the nearest on the host's clock.
            t = time.time_ns()
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            self.t0 = (t + time.time_ns()) // 2
        else:
            self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.stack.pop()
        rec = SpanRecord(self.name, self.t0, t1, self.id, self.parent, self.decision, threading.get_ident(),
                         {k: _attr(v) for k, v in self.attrs.items()})
        with _ring.lock:
            if len(_ring.records) == _ring.records.maxlen:
                _counters["spans.dropped"] += 1
            _ring.records.append(rec)
        return False


def span(name: str, **attrs):
    """A span named ``name`` (``vlfm.<layer>``) around the block. On inside
    ``tracing()`` or while a ``torch.profiler`` records, else a shared null
    context. ``decision=`` on a root span is the id its children carry; a
    tensor attr is kept as its shape and dtype."""
    if _on or _profiler_enabled():
        return _Span(name, attrs)
    return _NULL


@contextlib.contextmanager
def tracing():
    """Keep the program's spans in memory while the block runs (with or
    without a profiler); ``spans()`` reads them."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def spans() -> List[SpanRecord]:
    """The kept spans, oldest first (the ring's newest ``SPAN_CAPACITY``),
    in the order they ended."""
    with _ring.lock:
        return list(_ring.records)


def reset_spans() -> None:
    with _ring.lock:
        _ring.records.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``: a host integer, counted whether or
    not tracing is on; it never reads a device value."""
    _counters[name] += n


def device_counter(name: str, device) -> torch.Tensor:
    """The (1,) int64 accumulator of the counter ``name`` on ``device``,
    made at its first use and kept for the process: a kernel (or a CUDA
    graph that replays it) adds into it by its address. Its first use must
    not lie inside a graph capture, which would record its zero fill."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    acc = _device_counters.get((name, dev))
    if acc is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the device counter {name!r} is first used inside a graph capture")
        acc = _device_counters[(name, dev)] = torch.zeros(1, dtype=torch.int64, device=dev)
    return acc


def counters() -> Dict[str, int]:
    """The host counts, each device accumulator added to its name's (one
    read a device; accumulators that read 0 add no name)."""
    out = dict(_counters)
    for (name, _), acc in _device_counters.items():
        n = int(acc.item())
        if n:
            out[name] = out.get(name, 0) + n
    return out


def reset_counters() -> None:
    """Clear the host counts and zero the device accumulators in place (a
    graph keeps their addresses)."""
    _counters.clear()
    for acc in _device_counters.values():
        acc.zero_()


def write_spans(path: str) -> None:
    """The kept spans and the counters as a Chrome trace (Perfetto,
    ``chrome://tracing``): one complete event per span, in microseconds on
    the profiler's host clock, its attrs, id, parent and decision as args;
    the counters at the end of the last span."""
    recs = sorted(spans(), key=lambda r: r.start_ns)
    pid = os.getpid()
    events = [{"name": r.name, "ph": "X", "ts": r.start_ns / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
               "pid": pid, "tid": r.thread,
               "args": {**r.attrs, "id": r.id, "parent": r.parent, "decision": r.decision}} for r in recs]
    end = max((r.end_ns for r in recs), default=time.time_ns()) / 1e3
    events += [{"name": name, "ph": "C", "ts": end, "pid": pid, "args": {name: value}}
               for name, value in sorted(counters().items())]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms", "otherData": {"counters": counters()}}, f)
