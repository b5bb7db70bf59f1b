"""Where the flagship prove's time goes on the card.

  python -m zksaas_tpu_torch.profile_prove [--curve bn254|bls12_381|bls12_377]

Sets up the flagship as sha256_e2e does (over BN254 unless --curve names
another curve), runs one warm-up prove, one timed
prove, then one prove under torch.profiler (device activity only), and
prints one JSON line: both proves' wall seconds (device-synchronised), the
device-busy seconds (the union of all kernel intervals in the trace), the
device's idle share over the profiled prove, device seconds
and launches per kernel name (the 25 names with the most device time, and
every kernel of the port's), and the launches of the port's own kernels
by their counters.  It also compiles every CUDA source once more with
`-Xptxas -v` (all at once) and reports each kernel's registers, stack
frame and spill bytes.  The
Chrome trace is written to the git-ignored build directory.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import torch

from . import kernels
from .curves.curve import CURVE_FAMILIES
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


# the port's own kernels, by their short names (csrc/: the ring and point
# kernels in namespace zk, montmul and the sort's passes in kernels.cu)
PORT_KERNEL = re.compile(r"zk::|montmul_kernel|radix_\w+_kernel")
TOP = 25


def _kernel_table(trace_path: str) -> dict:
    """Device-busy seconds and, per kernel name, device seconds and
    launches: the TOP names by time, and every kernel of the port's
    whatever its rank."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    per: dict = {}
    for e in kern:
        row = per.setdefault(_short(e["name"]), [0.0, 0])
        row[0] += e["dur"] * 1e-6
        row[1] += 1
    busy = _busy_seconds((e["ts"], e["ts"] + e["dur"]) for e in kern) * 1e-6
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    return {
        "device_busy_s": busy,
        "kernels_in_trace": len(kern),
        "by_name": [{"name": n, "device_s": s, "launches": c}
                    for i, (n, (s, c)) in enumerate(ranked) if i < TOP or PORT_KERNEL.search(n)],
    }


def _kernel_label(mangled: str) -> str:
    """add_kernel<Fq2[12, nr -5]> and the like, from a mangled kernel name
    (whose identifiers each follow their length), with a second template
    argument after the ring (ring_mul_kernel<Fq2[8, nr -1], 3>: threads a
    row)."""
    base, i = mangled, 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        name = mangled[i + m.end(): i + m.end() + int(m.group())]
        if name.endswith("_kernel"):
            base = name
            break
        i += m.end() + len(name)
    m = re.search(r"RingFq(2?)ILi(\d+)E(?:Li(\d+)E)?EE(?:Li(\d+)E)?", mangled)
    if m:
        ring = f"Fq2[{m.group(2)}, nr -{m.group(3)}]" if m.group(1) else f"Fq[{m.group(2)}]"
        return f"{base}<{ring}, {m.group(4)}>" if m.group(4) else f"{base}<{ring}>"
    m = re.search(r"montmul_kernelILi(\d+)E", mangled)
    return f"{base}<{m.group(1)}>" if m else base


def _ptxas() -> list:
    """Registers and spill bytes of each kernel, from nvcc -Xptxas -v."""
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    os.makedirs(kernels.BUILD, exist_ok=True)
    procs = []
    for src in kernels.cuda_sources():
        out = os.path.join(kernels.BUILD, os.path.basename(src) + ".ptxas_check.cubin")
        procs.append(subprocess.Popen(
            [kernels.nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    rows = []
    for p in procs:
        _, err = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(err[-4000:])
        rows += _parse_ptxas(err)
    return rows


def _parse_ptxas(err: str) -> list:
    """One row per entry function of one `-Xptxas -v` log: its label,
    registers, and its own stack frame and spill bytes (not those of a
    non-inlined function it calls, which ptxas lists under that function's
    name)."""
    rows = []
    entry = props = None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            rows.append({"kernel": _kernel_label(entry)})
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows and props == entry:
            rows[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def main(curve: str = "bn254") -> dict:
    dev = resolve_device("cuda")
    _r1cs, _z, _vk, args = setup(1, 2, dev, {}, curve)
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
    by_field = {k.name: dict(k.by_field) for k in kernels.KERNELS}
    os.makedirs(kernels.BUILD, exist_ok=True)
    trace = os.path.join(kernels.BUILD, f"prove_trace_{curve}.json")
    prof.export_chrome_trace(trace)
    table = _kernel_table(trace)
    return {
        "curve": curve,
        "device": torch.cuda.get_device_name(dev),
        "prove_wall_s": wall,
        "prove_wall_unprofiled_s": wall_unprofiled,
        **table,
        "device_idle_share": 1.0 - table["device_busy_s"] / wall,
        "port_kernel_launches": launches,
        "port_kernel_launches_by_field": by_field,
        "ptxas": _ptxas(),
        "trace": trace,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="device time of one flagship prove")
    ap.add_argument("--curve", default="bn254", choices=CURVE_FAMILIES)
    print(json.dumps(main(ap.parse_args().curve)))
