"""The metric arithmetic: the window over its proofs, the 90th percentile
over all proofs, interval unions and gaps, the trace's reduction."""

import json
import statistics

import pytest

from zkbench import loader, stats, trace


def _record(latencies, window_s):
    return {"setup_s": 12.5, "window_s": window_s, "memory_peak_bytes": 3 * 2**30,
            "proofs": [{"latency_s": t, "deal_s": 0.1,
                        "phases": {"prove.ext_wit": 0.2, "prove.A": 0.1, "prove.B_g1": 0.1,
                                   "prove.B_g2": 0.1, "prove.C": 0.15}} for t in latencies],
            "counters": {"net_rounds": 9 * len(latencies), "gathered_elems": 3_000_000,
                         "port_launches": 5000 * len(latencies)},
            "trace": {"proofs": 2, "window_s": 2.0, "busy_s": 0.5, "port_kernel_s": 0.2,
                      "torch_kernel_s": 0.3, "copy_s": 0.08}}


def test_window_rate_and_p90_over_all_proofs():
    lat = [1.0] * 50 + [2.0] * 10
    rec = _record(lat, window_s=70.0)
    read = {m: loader.metric_reader(m) for m in ("proof_s", "proof_p90_s.serial", "setup_s")}
    assert read["proof_s"](rec) == pytest.approx(70.0 / 60)  # the window, not the sum
    p90 = read["proof_p90_s.serial"](rec)
    assert p90 == pytest.approx(statistics.quantiles(lat, n=100)[89]) and 1.0 < p90 <= 2.0
    assert read["setup_s"](rec) == 12.5
    assert stats.percentile([1.0], 90) is None


def test_per_layer_readers():
    rec = _record([1.0, 1.2], window_s=2.4)
    got = {m["name"]: loader.metric_reader(m["name"])(rec) for m in loader.benchmark()["per_layer"]}
    want = {"deal_s": 0.1, "ext_wit_s": 0.2, "msm_phases_s": 0.45, "net_rounds": 9,
            "gathered_melem": 1.5, "port_launches": 5000, "port_kernel_s": 0.1,
            "torch_kernel_s": 0.15, "copy_s": 0.04, "device_idle_pct": 100 * (1 - 0.25 / 1.2),
            "peak_mem_gib": 3.0}
    # the cell that reports proof_card_s has each of them, and proof_s, under a name of its own
    want |= {f"{k}.card": v for k, v in want.items()} | {"proof_s.card": 1.2}
    want["proof_p90_s.serial"] = statistics.quantiles([1.0, 1.2], n=100)[89]
    assert got == pytest.approx(want)
    rec["trace"] = None
    rec["memory_peak_bytes"] = 0
    for name in ("port_kernel_s", "torch_kernel_s", "copy_s", "device_idle_pct",
                 "peak_mem_gib"):
        assert loader.metric_reader(name)(rec) is None  # nothing to read: left out


def test_card_seconds_a_proof_over_the_window():
    """proof_card_s: the device's busy seconds in the trace of the whole
    window over the window's proofs; nothing to read without that trace."""
    rec = _record([3.0] * 12, window_s=36.0)
    rec["window_trace"] = {"proofs": 12, "window_s": 36.0, "busy_s": 13.2, "port_kernel_s": 3.0,
                           "torch_kernel_s": 8.0, "copy_s": 2.0}
    read = loader.metric_reader("proof_card_s")
    assert read(rec) == pytest.approx(1.1)
    rec["window_trace"] = None
    assert read(rec) is None
    del rec["window_trace"]
    assert read(rec) is None


def test_interval_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 11)]
    assert stats.union_length(iv) == 5
    assert stats.merged(iv) == [(0, 3), (5, 6), (10, 11)]
    assert stats.gaps(iv, 1, 10.5) == [(3, 5), (6, 10)]
    assert stats.gaps([], 0, 1) == [(0, 1)]
    assert stats.without_farthest([5, 2, 9.5, 6, 4]) == [5, 2, 6, 4]
    assert stats.spread([1, 2, 3, 4]) == pytest.approx(
        (statistics.quantiles([1, 2, 3, 4], n=4)[2] - statistics.quantiles([1, 2, 3, 4], n=4)[0])
        / 2.5)


def test_trace_reduction(tmp_path):
    """Busy time is the union of the device intervals over the proofs' host
    seconds; the port's kernels, the others, and copies are told apart;
    gaps in a trace with host operations lie inside the proofs'
    annotations and take the annotation and host op around them."""
    device = [
        {"ph": "X", "cat": "kernel", "name": "void zk::add_kernel<zk::RingFq<8> >(int)",
         "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128>(int)",
         "ts": 60, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": device}))
    r = trace.device_time(str(path), 200e-6, 2)
    assert r["proofs"] == 2 and r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(50e-6) and r["device_span_s"] == pytest.approx(120e-6)
    assert r["port_kernel_s"] == pytest.approx(30e-6)
    assert r["torch_kernel_s"] == pytest.approx(20e-6) and r["copy_s"] == pytest.approx(10e-6)
    assert r["top_ops"][0][0] == "zk::add_kernel<zk::RingFq<8> >"
    host = [
        {"ph": "X", "cat": "user_annotation", "name": "zkbench.proof", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "zkbench.proof", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "zkbench.deal", "ts": 0, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_select", "ts": 10, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "before the window", "ts": -50, "dur": 20},
    ]
    path.write_text(json.dumps({"traceEvents": device + host}))
    gaps = trace.idle_gaps(str(path))
    assert gaps[0][1] == pytest.approx(70e-6)  # 80 .. 150
    assert gaps[1] == ["zkbench.deal/aten::index_select", pytest.approx(40e-6)]
    path.write_text(json.dumps({"traceEvents": device}))
    assert trace.idle_gaps(str(path)) == [] and trace.device_time(str(path), 1.0, 1)
    path.write_text(json.dumps({"traceEvents": host[:4]}))
    assert trace.device_time(str(path), 1.0, 1) is None
