"""Where the flagship prove's time goes on the card.

  python -m zksaas_tpu_torch.profile_prove

Sets up the flagship as sha256_e2e does, runs one warm-up prove, one timed
prove, then one prove under torch.profiler (device activity only), and
prints one JSON line: both proves' wall seconds (device-synchronised), the
device-busy seconds (the union of all kernel intervals in the trace), the
device's idle share over the profiled prove, device seconds
and launches per kernel name, and the launches of the port's own kernels
by their counters.  It also compiles csrc/kernels.cu once more with
`-Xptxas -v` and reports each kernel's registers and spill bytes.  The
Chrome trace is written to the git-ignored build directory.  Needs a CUDA
device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import time

import torch

from . import kernels
from .device import resolve_device
from .groth16.prove import d_prove
from .sha256_e2e import setup
from .utils.rng import generator


def _busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _short(name: str) -> str:
    """A kernel's name without its parameters, and without its template
    arguments unless it is one of the port's (their ring tells G1 from G2)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    head = name.split("(")[0]
    if "zk::" not in head:
        head = re.sub(r"<.*", "", head)
    return head.strip()[:80]


def _kernel_table(trace_path: str) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    per: dict = {}
    for e in kern:
        row = per.setdefault(_short(e["name"]), [0.0, 0])
        row[0] += e["dur"] * 1e-6
        row[1] += 1
    busy = _busy_seconds((e["ts"], e["ts"] + e["dur"]) for e in kern) * 1e-6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])
    return {
        "device_busy_s": busy,
        "kernels_in_trace": len(kern),
        "by_name": [{"name": n, "device_s": s, "launches": c} for n, (s, c) in top[:25]],
    }


def _ptxas() -> list:
    """Registers and spill bytes of each kernel, from nvcc -Xptxas -v."""
    src = os.path.join(kernels.CSRC, "kernels.cu")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = os.path.join(kernels.BUILD, "ptxas_check.cubin")
    res = subprocess.run([kernels.nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", out, src],
                         capture_output=True, text=True, timeout=900, check=True)
    rows = []
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(
                r"(montmul|ring_mul|ring_inv|aadd|madd_if|add|double|sort_tile|sort_step)_kernel",
                mangled).group(0)
            ring = "Fq2" if "RingFq2" in mangled else "Fq" if "RingFq" in mangled else None
            name = f"{base}<{ring}>" if ring else base
            rows.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def main() -> dict:
    dev = resolve_device("cuda")
    _r1cs, _z, _vk, args = setup(1, 2, dev, {})
    d_prove(*args, generator(10))  # warm-up: tables, caches, the kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_prove(*args, generator(10))
    torch.cuda.synchronize()
    wall_unprofiled = time.perf_counter() - t0
    kernels.reset_launches()
    # device activity only: no host-op records, so the profiler adds little
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d_prove(*args, generator(10))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    os.makedirs(kernels.BUILD, exist_ok=True)
    trace = os.path.join(kernels.BUILD, "prove_trace.json")
    prof.export_chrome_trace(trace)
    table = _kernel_table(trace)
    return {
        "device": torch.cuda.get_device_name(dev),
        "prove_wall_s": wall,
        "prove_wall_unprofiled_s": wall_unprofiled,
        **table,
        "device_idle_share": 1.0 - table["device_busy_s"] / wall,
        "port_kernel_launches": launches,
        "ptxas": _ptxas(),
        "trace": trace,
    }


if __name__ == "__main__":
    print(json.dumps(main()))
