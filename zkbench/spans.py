"""Reduce the program's spans over the traced proofs: host seconds and
self seconds a proof by span name, and the device's idle seconds a proof by
the innermost span open over them.

The program (zksaas_tpu_torch/utils/trace.py) records, while its tracing
is on, each span's name, parent, request and host start and end on
time.perf_counter_ns(), and the offset that maps that clock onto
time.time_ns().  A torch.profiler Chrome trace stamps its events in
microseconds (`ts`) from its `baseTimeNanoseconds`, on time.time_ns()'s
clock, so the spans and the device's operations lie on one time line.

The traced proofs are the requests numbered 1 and up (request 0 is the
profiler's warm-up step); their window runs from the first one's start to
the last one's end.  Each stretch of that window that no device operation
covers (stats.gaps) is cut at the span boundaries, and each piece goes to
the innermost span open over it, or to `outside` where none is: between
proofs, and in the host work of a proof outside every span.
"""

from __future__ import annotations

import json

from .stats import gaps
from .trace import DEVICE_CATS

OUTSIDE = "outside"


def device_intervals(trace_path: str) -> list[tuple[int, int]]:
    """The device operations of a Chrome trace as (start, end) in
    time.time_ns() nanoseconds."""
    with open(trace_path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    return [(base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3))
            for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def traced(tr) -> tuple[list, tuple[int, int] | None]:
    """The spans of the traced proofs (requests 1 and up), as (start, end,
    name, self ns) in time.time_ns() nanoseconds, in the order they opened,
    and the window of those requests; no window when there is none."""
    reqs = [r for r in tr.requests if r.id >= 1]
    if not reqs:
        return [], None
    off = tr.wall_offset_ns
    own = tr.self_ns()
    ids = {r.id for r in reqs}
    spans = [(s.start_ns + off, s.end_ns + off, s.name, own[i])
             for i, s in enumerate(tr.spans) if s.request in ids]
    return spans, (min(r.start_ns for r in reqs) + off, max(r.end_ns for r in reqs) + off)


def seconds_by_name(spans, proofs: int) -> dict:
    """By span name, seconds a proof: `seconds` (the spans' durations) and
    `self_s` (less what their child spans cover)."""
    out: dict = {"seconds": {}, "self_s": {}}
    for s, e, name, self_ns in spans:
        for key, ns in (("seconds", e - s), ("self_s", self_ns)):
            out[key][name] = out[key].get(name, 0.0) + ns * 1e-9 / proofs
    return out


def innermost(spans, start: int, end: int) -> list[tuple[int, int, str]]:
    """[start, end] cut into stretches, each with the innermost span open
    over it (OUTSIDE where none is).  The spans come in the order they
    opened, and nest: they are one thread's stack."""
    out: list = []
    at = start

    def emit(upto, name):
        nonlocal at
        upto = min(max(upto, at), end)
        if upto > at:
            out.append((at, upto, name))
            at = upto

    stack: list = []  # (end, name), innermost last
    for s, e, name, _ in spans:
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0], stack[-1][1])
            stack.pop()
        emit(s, stack[-1][1] if stack else OUTSIDE)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0], stack[-1][1])
        stack.pop()
    emit(end, OUTSIDE)
    return out


def idle_by_span(device, spans, window: tuple[int, int]) -> dict:
    """Seconds of the window that no device operation covers, by the
    innermost span open over them."""
    start, end = window
    out: dict = {}
    pieces = innermost(spans, start, end)
    i = 0
    for gs, ge in gaps(device, start, end):
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            s, e, name = pieces[j]
            cut = min(e, ge) - max(s, gs)
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut * 1e-9
            j += 1
    return out


def reduce(trace_path: str, tr, proofs: int) -> dict | None:
    """What the record keeps of the traced proofs' spans: their seconds by
    name a proof and, where the trace holds device operations, the idle
    seconds a proof by innermost span (`idle_s`, None without them).
    None when the program recorded no request."""
    spans, window = traced(tr)
    if window is None:
        return None
    out = seconds_by_name(spans, proofs)
    device = device_intervals(trace_path)
    idle = idle_by_span(device, spans, window) if device else None
    out["idle_s"] = {k: v / proofs for k, v in sorted(idle.items())} if device else None
    return out
