"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from zksaas_tpu_torch/csrc with nvcc;
3. runs each kernel on the card at the main path's shapes and holds it
   bit for bit against its plain PyTorch version on the same inputs
   (tolerance: exact equality), timing both;
4. drives the flagship, zksaas_tpu_torch.sha256_e2e (the 51,454-constraint
   SHA-256 circuit, m = 2^16, 8 parties, l = 2, BN254), with every launch
   count set to 0 just before and read just after, and asserts that the
   pairing check passes and that every kernel launched;
5. prints the kernels line and, last, the device line.

Exits non-zero, before printing any result, when no CUDA device is present
or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit
# integer multiply-adds at the non-tensor float32 rate.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# 32-bit multiply instructions per BN254 Montgomery product: 8x8 a*b and
# 8x8 m*p wide products (lo + hi each) and 8 m's.
OPS_PER_MUL = 2 * (64 + 64) + 8
MULS_ADD, MULS_DBL_BRANCH, MULS_DOUBLE = 16, 15, 7


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    """Mean device ms of fn() over `iters` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def max_err(xs, ys):
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(xs, ys))


def bound(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_montmul(spec, n, gen):
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.fields.field import field
    from zksaas_tpu_torch.fields.montmul import montmul, montmul_plain

    F = field(spec)
    a, b = F.rand(gen, (n,), "cuda"), F.rand(gen, (n,), "cuda")
    before = kernels.MONTMUL.launches
    out = montmul(spec, a, b)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: montmul_plain(spec, a.long(), b.long()), 1)
    ref = montmul_plain(spec, a.long(), b.long())
    err = max_err([out], [ref])
    ms = cuda_ms(lambda: montmul(spec, a, b), 20)
    kernels.MONTMUL.launches = before
    bms, by = bound(3 * n * 16 * 4, n * OPS_PER_MUL)
    return dict(case=f"{spec.name} n=2^{n.bit_length() - 1}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def test_points(curve, n, gen, dev="cuda"):
    """n Jacobian points P, Q with random Z, and every special case of the
    complete add in the mix: P == Q (other Z), P == -Q, P or Q or both at
    infinity; and a random 0/1 cond."""
    import random

    F = curve.R.F
    rng = random.Random(7)
    pool = curve.encode([curve.ref.rand(rng) for _ in range(32)], device=dev)
    idx = torch.randint(0, 32, (2, n), generator=gen).to(dev)
    P = [c[idx[0]] for c in pool]
    Q = [c[idx[1]] for c in pool]
    kind = torch.arange(n, device=dev) % 16
    v = lambda m, c: m.view((-1,) + (1,) * (c.dim() - 1))
    same, neg = kind == 1, kind == 2
    Q = [torch.where(v(same, q), p, q) for p, q in zip(P, Q)]
    Q = [torch.where(v(neg, q), m, q) for m, q in zip(curve.neg(tuple(P)), Q)]

    def rescale(pt):  # (X l^2, Y l^3, Z l): the same point, another Z
        lam = F.rand(gen, (n,) + curve.R.coord_shape[:-1], dev)
        lam2 = curve.R.square(lam)
        return (curve.R.mul(pt[0], lam2), curve.R.mul(pt[1], curve.R.mul(lam2, lam)),
                curve.R.mul(pt[2], lam))

    P, Q = rescale(P), rescale(Q)
    inf = curve.infinity((n,), dev)
    pin = (kind == 3) | (kind == 5)
    qin = (kind == 4) | (kind == 5)
    P = tuple(torch.where(v(pin, c), o, c).contiguous() for c, o in zip(P, inf))
    Q = tuple(torch.where(v(qin, c), o, c).contiguous() for c, o in zip(Q, inf))
    cond = (torch.rand(n, generator=gen) < 0.5).to(dev)
    return P, Q, cond, dict(pin=pin, qin=qin, same=same, neg=neg)


def check_points(curve, n, gen):
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    P, Q, cond, cases = test_points(curve, n, gen)
    ring_muls = 1 if nc == 1 else 3
    nbytes_coord = n * 16 * nc * 4
    normal = ~(cases["pin"] | cases["qin"] | cases["neg"] | cases["same"])
    dbl_lanes = cases["same"] & ~(cases["pin"] | cases["qin"])
    neg_lanes = cases["neg"] & ~(cases["pin"] | cases["qin"])
    add_muls = (int(normal.sum()) * MULS_ADD + int(dbl_lanes.sum()) * MULS_DBL_BRANCH
                + int(neg_lanes.sum()) * 8)
    saved = [k.launches for k in kernels.KERNELS]
    rows = []
    tag = f"{curve.name} n=2^{n.bit_length() - 1}"

    out = po.point_add(spec, nc, P, Q)
    ref = po.point_add_plain(spec, nc, P, Q)
    torch.cuda.synchronize()
    bms, by = bound(9 * nbytes_coord, add_muls * ring_muls * OPS_PER_MUL)
    rows.append(("point_add", dict(
        case=tag, max_abs_err=max_err(out, ref),
        ms=cuda_ms(lambda: po.point_add(spec, nc, P, Q), 10),
        plain_ms=cuda_ms(lambda: po.point_add_plain(spec, nc, P, Q), 1),
        bound_ms=bms, bound_by=by)))

    out = po.point_add_if(spec, nc, P, Q, cond)
    ref = po.point_add_if_plain(spec, nc, P, Q, cond)
    torch.cuda.synchronize()
    frac = float(cond.float().mean())
    bms, by = bound(6 * nbytes_coord + int(cond.sum()) * 3 * 16 * nc * 4 + n,
                    add_muls * frac * ring_muls * OPS_PER_MUL)
    rows.append(("point_add_if", dict(
        case=tag, max_abs_err=max_err(out, ref),
        ms=cuda_ms(lambda: po.point_add_if(spec, nc, P, Q, cond), 10),
        plain_ms=cuda_ms(lambda: po.point_add_if_plain(spec, nc, P, Q, cond), 1),
        bound_ms=bms, bound_by=by)))

    for k in (1, 4):
        out = po.point_double(spec, nc, P, k)
        ref = po.point_double_plain(spec, nc, P, k)
        torch.cuda.synchronize()
        bms, by = bound(6 * nbytes_coord, n * k * MULS_DOUBLE * ring_muls * OPS_PER_MUL)
        rows.append(("point_double", dict(
            case=f"{tag} k={k}", max_abs_err=max_err(out, ref),
            ms=cuda_ms(lambda: po.point_double(spec, nc, P, k), 10),
            plain_ms=cuda_ms(lambda: po.point_double_plain(spec, nc, P, k), 1),
            bound_ms=bms, bound_by=by)))
    for kern, c in zip(kernels.KERNELS, saved):
        kern.launches = c  # comparison launches do not count
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}")

    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
    from zksaas_tpu_torch.fields.spec import BN254_FQ, BN254_FR

    t0 = time.perf_counter()
    kernels.cuda_lib()
    log(f"build: kernels built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(2026)
    cases = {k.name: [] for k in kernels.KERNELS}
    for spec in (BN254_FR, BN254_FQ):
        row = check_montmul(spec, 1 << 20, gen)
        cases["montmul"].append(row)
        log(f"check montmul {json.dumps(row)}")
    for curve, lg in ((curve_g1(), 18), (curve_g2(), 16)):
        for name, row in check_points(curve, 1 << lg, gen):
            cases[name].append(row)
            log(f"check {name} {json.dumps(row)}")
    for name, rows in cases.items():
        bad = [r for r in rows if r["max_abs_err"] != 0]
        if bad:
            raise SystemExit(f"{name} disagrees with its plain version: {bad}")

    from zksaas_tpu_torch import sha256_e2e

    kernels.reset_launches()
    res = sha256_e2e.main(device="cuda")
    path_launches = {k.name: k.launches for k in kernels.KERNELS}
    prove_launches = res["detail"]["launches"]
    log(f"flagship {json.dumps(res)}")
    if not res["verified"]:
        raise SystemExit("flagship proof failed the pairing check")
    if res["detail"]["constraints"] != 51454 or res["detail"]["domain"] != 1 << 16:
        raise SystemExit(f"flagship ran at the wrong size: {res['detail']}")
    idle = [n for n, c in path_launches.items() if c == 0]
    idle += [n for n, c in prove_launches.items() if c == 0]
    if idle:
        raise SystemExit(f"kernels never launched on the main path: {idle}")

    out = []
    for k in kernels.KERNELS:
        rows = cases[k.name]
        head = rows[0]
        out.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": path_launches[k.name], "prove_launches": prove_launches[k.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "case": head["case"],
            "cases": rows,
        })
    print(f"card: {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
