"""Reduce torch.profiler Chrome traces of a few proofs to what the
per-layer metrics and the breakdown read.

The method is profile_prove's (zksaas_tpu_torch/profile_prove.py, copied
here with its kernel-name shortening and its pattern for the port's own
kernels): device time is the union of the device operations' intervals.
Two traces serve: one with CUDA activity alone, so that the host runs as
in the window, gives the device's time, by operation, over the host
seconds of its proofs; one with the host's operations too gives the idle
gaps, each a stretch of the `zkbench.proof` annotations that no device
operation covers, named by the benchmark annotation around it and the host
operation that overlaps it most.
"""

from __future__ import annotations

import json
import re

from .stats import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
# the port's own kernels, by their short names (csrc/: the ring and point
# kernels in namespace zk, montmul and the sort's passes in kernels.cu)
PORT_KERNEL = re.compile(r"zk::|montmul_kernel|radix_\w+_kernel")
PROOF = "zkbench.proof"
TOP = 10


def short(name: str) -> str:
    """A kernel's name without its parameters, and without its template
    arguments unless it is one of the port's (their ring tells G1 from G2)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    head = name.split("(")[0]
    if "zk::" not in head:
        head = re.sub(r"<.*", "", head)
    return head.strip()[:80]


def _gap_label(gap, annotations, ops) -> str:
    s, e = gap
    mid = (s + e) / 2
    where = [a for a in annotations if a["ts"] <= mid <= a["ts"] + a["dur"]]
    where = min(where, key=lambda a: a["dur"])["name"] if where else "outside"
    best, best_overlap = None, 0.0
    for op in ops:
        overlap = min(e, op["ts"] + op["dur"]) - max(s, op["ts"])
        if overlap > best_overlap:
            best, best_overlap = op, overlap
    return f"{where}/{best['name'] if best else 'python'}"


def _events(trace_path: str) -> list[dict]:
    with open(trace_path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def device_time(trace_path: str, window_s: float, proofs: int) -> dict | None:
    """The device's busy seconds (the union of its operations' intervals)
    in a trace of `proofs` proofs that took `window_s` host seconds;
    seconds in the port's kernels, in the other kernels and in copies and
    fills; the top device operations.  None when the trace holds no device
    operation."""
    device = [e for e in _events(trace_path) if e.get("cat") in DEVICE_CATS]
    if not device:
        return None
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    per: dict = {}
    split = {"port_kernel_s": 0.0, "torch_kernel_s": 0.0, "copy_s": 0.0}
    for e in device:
        name = short(e["name"])
        seconds = e["dur"] * 1e-6
        per[name] = per.get(name, 0.0) + seconds
        if e["cat"] != "kernel":
            split["copy_s"] += seconds
        elif PORT_KERNEL.search(name):
            split["port_kernel_s"] += seconds
        else:
            split["torch_kernel_s"] += seconds
    return {
        "proofs": proofs,
        "window_s": window_s,
        "busy_s": union_length(spans) * 1e-6,
        "device_span_s": (max(e for _, e in spans) - min(s for s, _ in spans)) * 1e-6,
        "device_ops": len(device),
        **split,
        "top_ops": sorted(([n, s] for n, s in per.items()), key=lambda r: -r[1])[:TOP],
    }


def idle_gaps(trace_path: str) -> list:
    """The longest stretches of the traced `zkbench.proof` annotations that
    no device operation covers, each as [where/host operation, seconds]."""
    events = _events(trace_path)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    proofs = [e for e in host if e["name"] == PROOF]
    if not proofs:
        return []
    start = min(e["ts"] for e in proofs)
    end = max(e["ts"] + e["dur"] for e in proofs)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    annotations = [e for e in host if e["name"].startswith("zkbench.") and e["ts"] < end
                   and e["ts"] + e["dur"] > start]
    ops = [e for e in host if e.get("cat") == "cpu_op" and not e["name"].startswith("zkbench.")
           and e["ts"] < end and e["ts"] + e["dur"] > start]
    idle = sorted(gaps(spans, start, end), key=lambda g: g[0] - g[1])[:TOP]
    return [[_gap_label(g, annotations, _near(ops, g)), (g[1] - g[0]) * 1e-6] for g in idle]


def _near(ops, gap):
    """The host operations that overlap the gap."""
    s, e = gap
    return [op for op in ops if op["ts"] < e and op["ts"] + op["dur"] > s]
