"""Spans: the port's named phases, timed on request and traced when on.

`span(name, times)` marks one phase, as a `with` block or, around a whole
function, as its decorator.  What it does depends on the caller:

* `times` given: the CUDA device is synchronised at both ends and the
  phase's seconds are added to `times[name]`, so the time covers the queued
  work (the port of zksaas_tpu/utils/trace.py's span).
* tracing on (inside `tracing()`): the span is kept in memory with its
  name, its parent span, the current request (`request()`) and its host
  start and end, and opens a torch.profiler `record_function` range of the
  same name, which any profiler trace of the host's activity shows.  It adds
  no synchronisation of its own.
* neither: nothing is synchronised or recorded; the cost is one test.

Tracing is off by default and is switched on only by a caller's
`with tracing() as tr:`; `tr.spans` holds the spans, in the order they
opened, and `tr.self_ns()` each span's self time: its duration less the
time its child spans cover.  Spans are stamped with time.perf_counter_ns();
`tr.wall_offset_ns`, taken when tracing is switched on, maps them onto
time.time_ns(), the clock of torch.profiler's Chrome traces (an event's
`ts` in microseconds plus the trace's `baseTimeNanoseconds`), so spans and
device operations lie on one time line.

One trace records one thread: the port's protocol runs each party's
rounds on one thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Span:
    name: str
    parent: int  # index in Trace.spans of the span open around it, -1 for none
    request: object  # the request open when it opened (request()), None for none
    start_ns: int  # time.perf_counter_ns()
    end_ns: int = -1  # -1 while open


@dataclasses.dataclass
class Request:
    id: object
    start_ns: int
    end_ns: int = -1


class Trace:
    """The spans and requests recorded while tracing was on."""

    def __init__(self):
        self.spans: list[Span] = []
        self.requests: list[Request] = []
        self.wall_offset_ns = time.time_ns() - time.perf_counter_ns()
        self._open: list[int] = []  # indices of the open spans, innermost last
        self._request: object = None

    def self_ns(self) -> list[int]:
        """Each span's duration less what its child spans cover (children
        of one span never overlap: they open and close in turn)."""
        out = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end_ns - s.start_ns
        return out


_active: Trace | None = None  # the trace being recorded; None while tracing is off


@contextlib.contextmanager
def tracing():
    """Record spans until the block ends; yields the Trace."""
    global _active
    outer, _active = _active, Trace()
    try:
        yield _active
    finally:
        _active = outer


@contextlib.contextmanager
def request(rid):
    """Spans that open inside the block belong to request `rid`; with
    tracing on, the request's host start and end are recorded too."""
    tr = _active
    if tr is None:
        yield
        return
    req = Request(rid, time.perf_counter_ns())
    tr.requests.append(req)
    outer, tr._request = tr._request, rid
    try:
        yield
    finally:
        tr._request = outer
        req.end_ns = time.perf_counter_ns()


@contextlib.contextmanager
def span(name: str, times: dict | None = None):
    tr = _active
    if tr is None and times is None:
        yield
        return
    if times is not None:
        _sync()
        t0 = time.perf_counter()
    if tr is not None:
        index = len(tr.spans)
        tr.spans.append(Span(name, tr._open[-1] if tr._open else -1, tr._request,
                             time.perf_counter_ns()))
        tr._open.append(index)
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    try:
        yield
    finally:
        if tr is not None:
            rf.__exit__(None, None, None)
            tr._open.pop()
            tr.spans[index].end_ns = time.perf_counter_ns()
        if times is not None:
            _sync()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
