"""Interval tracing on top of utils/timers.Timers.

`Tracer` is the runtime's Timers: `time(name)` and `count(name, n)` sum as
Timers' do (`acc`, `n`, `counters`, the `[timers]` line). Between
`start_trace()` and `stop_trace()` every `time()` also records one `Span`:
its name, its parent (the innermost span open in the same context), the
batch it belongs to, the role of its thread, its start and end on the
`time.perf_counter_ns` clock and the thread CPU time
(`time.thread_time_ns`) spent inside it, read at its two ends (an end
within CPU_REUSE_NS of the thread's last read takes that read).

The batch id is drawn by each `map_batch` span opened outside any other
span (`TorchRuntime.map_batch`); every span opened inside it inherits it,
and `carry(fn)` hands the calling context (batch, parent, a role) to a
function that runs on another thread (an executor or a thread does not
carry it by itself). Roles: `batch` (a thread inside a `map_batch` span),
`host_lane` (carried into the host lane's workers), `steal_lane` (the
stealing routing's device lane), `main` (the main thread outside any
batch, e.g. `feed_wait`) and `other`. Tracing is off by default; then
`time()` costs one attribute check more than Timers'.

Code that computes a launch's work counters only for a trace asks
`active()`: true inside a span of a tracer that is tracing.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import NamedTuple

from .timers import Timers

__all__ = ["Span", "Tracer", "active", "carry", "clock_map"]


class Span(NamedTuple):
    id: int
    parent: int          # 0: a root
    name: str
    batch: int           # 0: outside any batch
    role: str
    thread: int          # threading.get_ident() of the thread it ran on
    start_ns: int        # perf_counter_ns
    end_ns: int
    cpu_ns: int          # thread CPU time inside the span


# A read of the thread CPU clock is a system call (about 3 us on the
# card's host): a boundary less than this long after the thread's last read
# takes that read, so a span's CPU time is exact to this much at each end
# (and held within its wall time)
CPU_REUSE_NS = 20_000
_wall_ns, _cpu_ns = time.perf_counter_ns, time.thread_time_ns
_ident = threading.get_ident
# the context's innermost open span (an _Open, or a _Carried one)
_CUR: contextvars.ContextVar = contextvars.ContextVar("mm2tpu_span",
                                                     default=None)


class Tracer(Timers):
    def __init__(self):
        super().__init__()
        self.tracing = False
        self._spans: list[tuple] = []    # Span fields, as they ended
        self._ids = itertools.count(1)
        self._batches = itertools.count(1)

    def start_trace(self) -> None:
        """Record every span opened from now on."""
        with self._lock:
            self._spans = []
            self.tracing = True

    def stop_trace(self) -> list[Span]:
        """Stop recording; returns the spans that ended since
        start_trace(), in the order they ended."""
        with self._lock:
            self.tracing = False
            out, self._spans = self._spans, []
        return [Span._make(r) for r in out]

    def time(self, name: str):
        if not self.tracing:
            return Timers.time(self, name)
        return _Open(self, name)


class _Open:
    """One span while it is open (a context manager); the context's value
    while it is the innermost. `lt`, `lc`: the thread's last reading of its
    CPU clock (perf_counter ns when read, thread CPU ns)."""
    __slots__ = ("tr", "name", "sid", "parent", "batch", "role", "token",
                 "up", "t0", "c0", "lt", "lc")

    def __init__(self, tr: Tracer, name: str):
        self.tr, self.name = tr, name

    def __enter__(self):
        tr = self.tr
        cur = _CUR.get()
        up = None
        if cur is not None and cur.tr is tr:
            self.parent, self.batch, self.role = cur.sid, cur.batch, cur.role
            if type(cur) is _Open:      # an _Open's context is its thread's
                up = cur
        elif self.name == "map_batch":
            self.parent, self.batch, self.role = 0, next(tr._batches), "batch"
        else:
            self.parent, self.batch = 0, 0
            self.role = "main" if threading.current_thread() \
                is threading.main_thread() else "other"
        self.up = up
        self.sid = next(tr._ids)
        self.token = _CUR.set(self)
        self.t0 = t0 = _wall_ns()
        if up is not None and t0 - up.lt < CPU_REUSE_NS:
            self.lt, self.c0 = up.lt, up.lc
        else:
            self.lt, self.c0 = t0, _cpu_ns()
        self.lc = self.c0

    def __exit__(self, exc_type, exc, tb):
        t1 = _wall_ns()
        if t1 - self.lt >= CPU_REUSE_NS:
            self.lt, self.lc = t1, _cpu_ns()
        _CUR.reset(self.token)
        up = self.up
        if up is not None:
            up.lt, up.lc = self.lt, self.lc
        tr, name, t0 = self.tr, self.name, self.t0
        cpu = self.lc - self.c0
        if cpu > t1 - t0:
            cpu = t1 - t0
        rec = (self.sid, self.parent, name, self.batch, self.role, _ident(),
               t0, t1, cpu)
        with tr._lock:
            tr.acc[name] += (t1 - t0) * 1e-9
            tr.n[name] += 1
            if tr.tracing:
                tr._spans.append(rec)
        return False


class _Carried:
    """The context `carry` hands to another thread: a span's batch and id
    under another role."""
    __slots__ = ("tr", "sid", "batch", "role")

    def __init__(self, tr, sid, batch, role):
        self.tr, self.sid, self.batch, self.role = tr, sid, batch, role


def active() -> bool:
    """True inside a span of a tracer that is tracing."""
    cur = _CUR.get()
    return cur is not None and cur.tr.tracing


def carry(fn, role: str = "host_lane"):
    """`fn`, to run on another thread inside the calling context's
    innermost span (its batch, as `role`); `fn` itself where no span of a
    tracing tracer is open."""
    cur = _CUR.get()
    if cur is None or not cur.tr.tracing:
        return fn
    state = _Carried(cur.tr, cur.sid, cur.batch, role)

    def run(*a, **kw):
        token = _CUR.set(state)
        try:
            return fn(*a, **kw)
        finally:
            _CUR.reset(token)
    return run


def clock_map(anchor0: tuple[int, int], anchor1: tuple[int, int]):
    """A function from perf_counter_ns to another clock's ns, linear
    through two anchors (perf_counter ns, the other clock's ns) taken at
    the start and the end of a window, so that the two clocks' drift over
    the window cancels."""
    (p0, o0), (p1, o1) = anchor0, anchor1
    rate = (o1 - o0) / (p1 - p0) if p1 != p0 else 1.0
    return lambda ns: o0 + (ns - p0) * rate
