"""Spans of the port's request path and phases of its set-up.

`span(name, **attrs)` marks a stretch of the fused request path: the
workload driver's run, each bucket, each blocking device-to-host
transfer (`sync.*`).  While no torch profiler records it returns one
shared no-op after a single check of the profiler's flag, so the
serving path pays almost nothing for it.  While a profiler records,
the span opens the profiler's cheapest record function (it lands on
the profiler's timeline, beside the device's events, under its own
name) and is kept for `spans()`, which returns the spans of the current
profiled stretch alone.  A stretch starts at the first span that finds
a profiler recording after one that found none (as the benchmark's
unprofiled warm-up precedes its traced window), and that span drops the
records the last stretch left.  A stretch keeps its spans as names and
numbers in flat lists, which hold no object the garbage collector
counts: a traced window keeps tens of thousands of spans, and as
objects they would set off collections inside the window that the
untraced program never makes, each of which may free whatever the
process left in reference cycles.

`phase(name, **attrs)` marks one step of set-up (the store's sorts, the
views' materialization, the uploads, the warm run).  Phases last
seconds and come a handful at a time, so every phase is timed,
profiler or not; `phases()` keeps the last finished phase of each name,
with the phases opened inside it as its `children`.  Under a profiler
a phase is a span too.

The names carry the kind (`bucket.join`, `sync.rows`): a breakdown
prints names only.  Attributes are counts and sizes (`rows`, `bytes`,
`cap`, ...).  One thread's spans nest within that thread.
"""
from __future__ import annotations

import threading
import time

import torch
import torch.autograd.profiler as _profiler

# the profiler's cheapest span primitive in this torch; record_function
# where the fast one is missing
_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Span:
    """One timed stretch: `name`, `start_ns` / `end_ns` on
    `time.perf_counter_ns`, the span or phase it opened inside
    (`parent`), its `attrs`, and, for a phase, the phases opened inside
    it (`children`; None for a span)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs",
                 "children", "_phase", "_into", "_at", "_rf")

    def __init__(self, name: str, attrs: dict, phase: bool, traced: bool):
        self.name = name
        self.attrs = attrs
        self.children: list[Span] = [] if phase else None
        self.parent: Span | None = None
        self.start_ns = self.end_ns = 0
        self._phase = phase
        # the stretch this span is kept in, and its place there
        self._into = _stretch if traced else None
        self._at = -1
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs) -> None:
        """Add attributes known only once the work has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if self._into is not None:
            order = self._into[0]
            self._at = len(order)
            order.append(-1)
            self._rf = (_FAST or _profiler.record_function)(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
            order, data = self._into
            up = self.parent
            order[self._at] = len(data)
            data += (self.name, self.start_ns, self.end_ns,
                     up._at if up is not None and up._into is self._into
                     else -1, len(self.attrs))
            for item in self.attrs.items():
                data += item
        _stack().pop()
        if self._phase:
            _phases[self.name] = self
            if self.parent is not None and self.parent._phase:
                self.parent.children.append(self)


class _Off:
    """The span returned while no profiler records: it does nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


OFF = _Off()
# the current stretch's spans: in the order they were entered, where
# each closed span starts in the data (-1 while it is open); the data:
# name, start_ns, end_ns, the parent's place in the order (-1 for none),
# the number of attrs, then each attr's key and value
_stretch: tuple[list, list] = ([], [])
_phases: dict[str, Span] = {}
_local = threading.local()
# whether the last span() found a profiler recording: a span that finds
# one after a span that did not starts a new stretch
_profiled = False


def _stack() -> list[Span]:
    """This thread's open spans and phases, the innermost last."""
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def _tracing() -> bool:
    """Whether a profiler records now; starts new records at the first
    span of a profiled stretch."""
    global _profiled, _stretch
    on = _profiler._is_profiler_enabled
    if on and not _profiled:
        _stretch = ([], [])
    _profiled = on
    return on


def span(name: str, **attrs):
    """A span of the request path, recorded only while a torch profiler
    records (else the shared no-op `OFF`)."""
    global _profiled
    if not _profiler._is_profiler_enabled:
        _profiled = False
        return OFF
    _tracing()
    return Span(name, attrs, phase=False, traced=True)


def phase(name: str, **attrs) -> Span:
    """A set-up phase, always timed; a span as well under a profiler."""
    return Span(name, attrs, phase=True, traced=_tracing())


def spans() -> list[Span]:
    """The closed spans of the current (or last) profiled stretch, in
    the order they were entered."""
    order, data = _stretch
    out: list[Span | None] = []
    for at in order:
        s = None
        if at >= 0:
            name, start, end, up, n = data[at:at + 5]
            kv = data[at + 5:at + 5 + 2 * n]
            s = Span(name, dict(zip(kv[::2], kv[1::2])), phase=False,
                     traced=False)
            s.start_ns, s.end_ns = start, end
            s.parent = out[up] if up >= 0 else None
        out.append(s)
    return [s for s in out if s is not None]


def phases() -> dict[str, Span]:
    """The last finished phase of each name."""
    return dict(_phases)
