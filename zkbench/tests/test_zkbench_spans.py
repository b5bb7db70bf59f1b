"""The program's spans over the traced proofs: seconds by span name, the
device's idle seconds by innermost span on synthetic intervals, and, on the
card, that the spans and a CUDA-only trace share one clock."""

import json
import time

import pytest

from zkbench import spans, stats
from zksaas_tpu_torch.utils import trace as program_trace


def _trace():
    """Two traced proofs (requests 1 and 2) after the profiler's warm-up
    proof (request 0), in microseconds from 0 on both clocks."""
    us = 1000
    tr = program_trace.Trace()
    tr.wall_offset_ns = 0
    S, R = program_trace.Span, program_trace.Request
    tr.requests = [R(0, 0, 60 * us), R(1, 100 * us, 200 * us), R(2, 210 * us, 300 * us)]
    tr.spans = [S("zk.warm", -1, 0, 0, 50 * us),
                S("zk.a", -1, 1, 110 * us, 190 * us),
                S("zk.b", 1, 1, 120 * us, 150 * us),
                S("zk.c", 1, 1, 160 * us, 170 * us),
                S("zk.a", -1, 2, 220 * us, 290 * us)]
    device = [(0, 60), (100, 115), (130, 140), (165, 200), (205, 230), (280, 300)]
    return tr, [(s * us, e * us) for s, e in device]


def test_seconds_and_self_seconds_by_name():
    tr, _ = _trace()
    got, window = spans.traced(tr)
    assert window == (100_000, 300_000)
    assert [s[2] for s in got] == ["zk.a", "zk.b", "zk.c", "zk.a"]
    by = spans.seconds_by_name(got, 2)
    assert by["seconds"] == pytest.approx({"zk.a": 75e-6, "zk.b": 15e-6, "zk.c": 5e-6})
    assert by["self_s"] == pytest.approx({"zk.a": 55e-6, "zk.b": 15e-6, "zk.c": 5e-6})


def test_idle_goes_to_the_innermost_span_and_sums_to_the_gaps(tmp_path):
    """Gaps 115-130 (a 5, b 10), 140-165 (b 10, a 10, c 5), 200-205 between
    the proofs (outside 5) and 230-280 (a 50); the warm-up proof's spans and
    device time lie outside the window."""
    tr, device = _trace()
    got, window = spans.traced(tr)
    idle = spans.idle_by_span(device, got, window)
    want = {"zk.a": 65e-6, "zk.b": 20e-6, "zk.c": 5e-6, spans.OUTSIDE: 5e-6}
    assert idle == pytest.approx(want)
    assert sum(idle.values()) == pytest.approx(
        sum(e - s for s, e in stats.gaps(device, *window)) * 1e-9)
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": s / 1e3, "dur": (e - s) / 1e3}
              for s, e in device]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 100,
                   "dur": 50})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": 0}))
    red = spans.reduce(str(path), tr, 2)
    assert red["idle_s"] == pytest.approx({k: v / 2 for k, v in want.items()})
    assert red["self_s"]["zk.a"] == pytest.approx(55e-6)
    # a trace with no device operation (a CPU run) has no idle seconds
    path.write_text(json.dumps({"traceEvents": events[-1:], "baseTimeNanoseconds": 0}))
    assert spans.reduce(str(path), tr, 2)["idle_s"] is None
    assert spans.reduce(str(path), program_trace.Trace(), 2) is None


def test_innermost_covers_the_window_once():
    tr, _ = _trace()
    got, _ = spans.traced(tr)
    pieces = spans.innermost(got, 90_000, 320_000)
    assert pieces[0] == (90_000, 110_000, spans.OUTSIDE)
    assert pieces[-1] == (290_000, 320_000, spans.OUTSIDE)
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert [p[2] for p in pieces[1:6]] == ["zk.a", "zk.b", "zk.a", "zk.c", "zk.a"]


@pytest.mark.card
def test_spans_share_the_device_trace_clock(cuda_card, tmp_path):
    """A span around a 20 ms host sleep between two kernels, the first
    synchronised, lies inside the device's idle gap between them in a trace
    with CUDA activity alone, and covers at least 95% of it.  The same
    steps run once before, under the profiler, so that first calls (the
    profiler's range, the launches under it) do not stretch the gap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with program_trace.tracing() as tr:
            for i in range(2):
                with program_trace.request(i):
                    x.mul_(2)
                    torch.cuda.synchronize()
                    with program_trace.span("zk.sleep"):
                        time.sleep(0.02)
                    x.mul_(3)
                    torch.cuda.synchronize()
    path = tmp_path / "clock.json"
    prof.export_chrome_trace(str(path))
    device = spans.device_intervals(str(path))
    [(s, e, _, _)], window = spans.traced(tr)
    gap = [g for g in stats.gaps(device, *window) if g[1] - g[0] > 10_000_000]
    assert len(gap) == 1, gap
    (g0, g1), = gap
    print(f"span {(e - s) / 1e6:.3f} ms in a gap of {(g1 - g0) / 1e6:.3f} ms, "
          f"{(s - g0) / 1e3:.1f} us after its start, {(g1 - e) / 1e3:.1f} us before its end")
    assert g0 <= s and e <= g1
    assert (e - s) >= 0.95 * (g1 - g0)
