"""The point add, add-if, double, affine+affine add and key sort of two
checkouts, timed on one card.

  python -m zksaas_tpu_torch.kernel_ab --ref DIR [--out FILE]

DIR is another checkout of the repo (say the parent commit, unpacked with
`git archive`).  Both checkouts' kernels are built first (at once), then
each checkout is timed in its own process, in the order DIR, this, this,
DIR, so that a drift of the card over the call shows as a difference
between the two runs of one checkout.  Each run times, for every
coordinate ring (G1 and G2 of BN254, BLS12-381, BLS12-377):

* point_add_if, point_add and point_double (k = 1) at 16 points, the main
  path's batch (the king's mat-vec of 2 x 8 products), and point_double at
  8 points with k = 128, the last step of Pippenger's window fold, as
  device time: the launches are captured in one CUDA graph and replayed, so
  the host's launch time between them does not count;
* point_add_if, point_add and point_double (k = 1 and 4) at 2^18 points
  (G1) or 2^16 (G2), the shapes of PERF.md's kernel table, with CUDA
  events;
* point_aadd at 2^21 pairs (Pippenger's tree level 1 in the path's
  2^14-chunk MSMs) and 2^22 (the 2^15-chunk h-query MSM), with P == Q,
  P == -Q and infinity flags mixed in, with CUDA events;

and the key sort over 8 rows of 2^19 and of 2^20 keys beside torch.sort on
the same keys, with the sort's device time per kernel name from
torch.profiler.  The inputs are chip_smoke.test_points / affine_pairs /
random keys from fixed seeds, the same in every run.  The empty kernel's
graph time (this checkout only) is the launch floor.  Prints the card's name and
power limit and one JSON line: every run's numbers under its checkout.
Needs a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def graph_ms(fn, iters: int = 200) -> float:
    """Device ms per call of fn(), from `iters` calls captured in one CUDA
    graph (fn must launch on the current stream and not synchronise)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def launch_floor_ms() -> float:
    """Graph time of the empty kernel (csrc/kernels.cu::zk_empty)."""
    import torch

    from zksaas_tpu_torch import kernels

    lib = kernels.cuda_lib()

    def empty():
        rc = lib.zk_empty(torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel launch failed with error {rc}")

    return graph_ms(empty)


def _device_ms_by_kernel(fn, calls: int) -> dict:
    """Device ms per call of fn() for each kernel name, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zksaas_tpu_torch.profile_prove import _short

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us:
            name = _short(ev.key)
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def _worker(root: str) -> dict:
    """Time the kernels of the checkout at `root` (this process imports its
    package and its chip_smoke.py)."""
    sys.path.insert(0, root)
    import torch

    from chip_smoke import affine_pairs, cuda_ms, test_points
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po
    from zksaas_tpu_torch.curves.curve import CURVE_FAMILIES, curve_g1, curve_g2
    from zksaas_tpu_torch.fields.sortperm import sort_u32

    kernels.cuda_lib()
    res = {}
    if hasattr(kernels.cuda_lib(), "zk_empty"):
        res["launch_floor"] = launch_floor_ms()
    for fam in CURVE_FAMILIES:
        for C, lg in ((curve_g1(fam), 18), (curve_g2(fam), 16)):
            spec, nc = C.spec, C._ncoord
            gen = torch.Generator().manual_seed(2026)
            P, Q, cond, _ = test_points(C, 16, gen)
            res[f"{C.name} add_if n=16"] = graph_ms(lambda: po.point_add_if(spec, nc, P, Q, cond))
            res[f"{C.name} add n=16"] = graph_ms(lambda: po.point_add(spec, nc, P, Q))
            res[f"{C.name} double n=16"] = graph_ms(lambda: po.point_double(spec, nc, P, 1))
            P8 = tuple(c[:8].contiguous() for c in P)
            res[f"{C.name} double n=8 k=128"] = graph_ms(
                lambda: po.point_double(spec, nc, P8, 128), 20)
            P, Q, cond, _ = test_points(C, 1 << lg, gen)
            res[f"{C.name} add_if n=2^{lg}"] = cuda_ms(lambda: po.point_add_if(spec, nc, P, Q, cond), 10)
            res[f"{C.name} add n=2^{lg}"] = cuda_ms(lambda: po.point_add(spec, nc, P, Q), 10)
            for k in (1, 4):
                res[f"{C.name} double n=2^{lg} k={k}"] = cuda_ms(
                    lambda: po.point_double(spec, nc, P, k), 10)
            del P, Q, cond
            for la in (21, 22):
                P, Q, kind = affine_pairs(C, 1 << la, gen)
                P, Q = tuple(c.contiguous() for c in P[:2]), tuple(c.contiguous() for c in Q[:2])
                inf1, inf2 = (kind == 3) | (kind == 5), (kind == 4) | (kind == 5)
                res[f"{C.name} aadd n=2^{la}"] = cuda_ms(
                    lambda: po.point_aadd(spec, nc, P, Q, inf1, inf2), 5)
                del P, Q, inf1, inf2
            torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(7)
    for lg in (19, 20):
        keys = torch.randint(-(1 << 31), 1 << 31, (8, 1 << lg), generator=gen,
                             dtype=torch.int64).int().to("cuda")
        wide = keys.long() & 0xFFFFFFFF
        res[f"sort 8x2^{lg}"] = cuda_ms(lambda: sort_u32(keys), 10)
        res[f"torch.sort 8x2^{lg}"] = cuda_ms(lambda: torch.sort(wide, dim=-1), 10)
        res[f"sort 8x2^{lg} by kernel"] = _device_ms_by_kernel(lambda: sort_u32(keys), 5)
    kernels.reset_launches()
    return res


def _run(args, timeout=1500):
    p = subprocess.run([sys.executable, os.path.abspath(__file__), *args], capture_output=True,
                       text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"kernel_ab {' '.join(args)} failed:\n{p.stderr[-4000:]}")
    return p.stdout


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", help="the other checkout's root directory")
    ap.add_argument("--out", help="also write the JSON line to this file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.build:
        sys.path.insert(0, a.build)
        from zksaas_tpu_torch import kernels

        kernels.cuda_lib()
        return
    if a.worker:
        print(json.dumps(_worker(a.worker)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device is available")
    if not a.ref:
        sys.exit("kernel_ab: --ref DIR is required")
    ref = os.path.abspath(a.ref)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"card: {card}", flush=True)
    builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", r])
              for r in (ref, ROOT)]
    if any(b.wait(timeout=1500) for b in builds):
        sys.exit("kernel_ab: a build failed")
    runs = {"ref": [], "this": []}
    for who in ("ref", "this", "this", "ref"):
        out = _run(["--worker", ref if who == "ref" else ROOT])
        runs[who].append(json.loads(out.strip().splitlines()[-1]))
        print(f"{who} run {len(runs[who])} done", flush=True)
    line = json.dumps({"card": card, "ref": ref, "runs": runs})
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
