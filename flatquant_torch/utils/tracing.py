"""Spans and counters of the serving path, on the host clock
(`time.perf_counter`). The tracer has no JAX counterpart.

Process-wide and off by default. `enable()` turns it on, `disable()`
off, and `drain()` hands back and forgets what was recorded:

    with tracing.span("decode", rids=[3, 5]):   # a span, nested by a stack
        ...
    tracing.record("queued", t_submit, now, rid=3)  # a span begun earlier
    tracing.count("decode.calls")                # a counter
    with tracing.sync("h2d.tokens"):             # a site where the host
        ...                                      # waits for the device

A span is recorded as (id, parent id, name, t0, t1, attrs): its parent
is the span open around it when it began (None for a root, and for a
span given by `record`). `sync(site)` is a span named
"sync" with attribute `site`, counted in "host_syncs" and
"host_syncs.<site>".

Off, `span()` and `sync()` return one shared no-op object, reading no
clock and allocating nothing, and `count()` and `record()` return at
once; callers build costly attributes (lists of request ids) only under
`if tracing.ON`. The tracer never synchronizes with the device: spans
time the host, and device time comes from a profiler trace.
"""

from __future__ import annotations

import itertools
import time

ON = False

_clock = time.perf_counter
_spans: list = []
_counts: dict = {}
_stack: list = []
_ids = itertools.count(1)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.id)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        _stack.pop()
        _spans.append((self.id, self.parent, self.name, self.t0, t1,
                       self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records a span around its body."""
    if not ON:
        return NOOP
    return _Span(name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Record a span whose start was taken earlier (on `now()`'s clock).
    It began before the spans open now, so it has no parent."""
    if ON:
        _spans.append((next(_ids), None, name, t0, t1, attrs))


def count(name: str, n: int = 1) -> None:
    if ON:
        _counts[name] = _counts.get(name, 0) + n


def sync(site: str):
    """A span named "sync" around a site where the host waits for the
    device (a device-to-host read, or a copy from pageable host memory
    that is not non-blocking), counted in "host_syncs" and
    "host_syncs.<site>"."""
    if not ON:
        return NOOP
    count("host_syncs")
    count("host_syncs." + site)
    return _Span("sync", {"site": site})


def now() -> float:
    """The tracer's clock."""
    return _clock()


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def drain():
    """(spans, counters) recorded since the last drain; both are then
    forgotten. Spans are in the order they closed."""
    global _spans, _counts
    out = (_spans, _counts)
    _spans, _counts = [], {}
    return out
