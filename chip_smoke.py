"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from zksaas_tpu_torch/csrc with nvcc;
3. runs each kernel on the card at the main path's shapes and holds it
   bit for bit against its plain PyTorch version on the same inputs
   (tolerance: exact equality), timing both, and torch.sort beside the
   key sort as its library yardstick: every field instance of every
   kernel, BN254 (16 16-bit limbs), BLS12-381 and BLS12-377 (24 limbs,
   Fq2 nr = -5 for BLS12-377), G1 and G2;
4. runs the bucket-Pippenger MSM (curves/pippenger.py::msm_best) on the
   card for one party's 2^15 BN254 G1 points and holds its affine result
   against scalar_mul_w4 + sum on the same card;
5. drives the flagship, zksaas_tpu_torch.sha256_e2e (the 51,454-constraint
   SHA-256 circuit, m = 2^16, 8 parties, l = 2), first over BN254, then
   over BLS12-381, each with every launch count set to 0 just before and
   read just after, and asserts that the pairing check passes, that every
   kernel launched, in the whole run and in the timed prove, and that the
   BLS12-381 prove went through the BLS12-381 instance of every point and
   ring kernel;
6. prints the kernels line and, last, the device line.

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

# H100 SXM memory rate (NVIDIA data sheet).  The operations peak is set in
# main() from the card: SMs x 64 32-bit integer multiplies (or compares)
# per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x the card's max SM clock.
PEAK_BYTES = 3.35e12
PEAK_OPS = None
MULS_ADD, MULS_DBL_BRANCH, MULS_DOUBLE = 16, 15, 7
# Montgomery products per lane of the new point kernels' branches
MULS_AADD, MULS_MADD, MULS_MADD_NEG = 6, 11, 4


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


def ops_per_mul(spec):
    """32-bit multiply instructions per Montgomery product over NL 32-bit
    limbs: NL x NL a*b and NL x NL m*p wide products (lo + hi each) and NL
    m's (264 at NL = 8, 588 at NL = 12)."""
    nl = spec.nlimbs // 2
    return 2 * (2 * nl * nl) + nl


def check_montmul(spec, n, gen):
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.fields.field import field
    from zksaas_tpu_torch.fields.montmul import montmul, montmul_plain

    F = field(spec)
    a, b = F.rand(gen, (n,), "cuda"), F.rand(gen, (n,), "cuda")
    saved = kernels.save_launches()
    out = montmul(spec, a, b)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: montmul_plain(spec, a.long(), b.long()), 1)
    ref = montmul_plain(spec, a.long(), b.long())
    err = max_err([out], [ref])
    ms = cuda_ms(lambda: montmul(spec, a, b), 20)
    kernels.restore_launches(saved)
    bms, by = bound(3 * n * spec.nlimbs * 4, n * ops_per_mul(spec))
    return dict(case=f"{spec.name} n=2^{n.bit_length() - 1}", field=spec.name, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def _v(m, c):
    return m.view((-1,) + (1,) * (c.dim() - 1))


def affine_pairs(curve, n, gen, dev="cuda"):
    """n pairs of Z = 1 points P, Q from a pool of 32, with Q == P in every
    16th lane and Q == -P in the next."""
    import random

    rng = random.Random(7)
    pool = curve.encode([curve.ref.rand(rng) for _ in range(32)], device=dev)
    idx = torch.randint(0, 32, (2, n), generator=gen).to(dev)
    P = [c[idx[0]] for c in pool]
    Q = [c[idx[1]] for c in pool]
    kind = torch.arange(n, device=dev) % 16
    same, neg = kind == 1, kind == 2
    Q = [torch.where(_v(same, q), p, q) for p, q in zip(P, Q)]
    Q = [torch.where(_v(neg, q), m, q) for m, q in zip(curve.neg(tuple(P)), Q)]
    return P, Q, kind


def same_coord(a, b):
    """Lanes whose canonical coordinates agree."""
    return (a == b).flatten(1).all(1)


def rescale(curve, pt, gen):
    """(X l^2, Y l^3, Z l) for random l: the same points, another Z."""
    n = pt[0].shape[0]
    lam = curve.R.F.rand(gen, (n,) + curve.R.coord_shape[:-1], pt[0].device)
    lam2 = curve.R.square(lam)
    return (curve.R.mul(pt[0], lam2), curve.R.mul(pt[1], curve.R.mul(lam2, lam)),
            curve.R.mul(pt[2], lam))


def test_points(curve, n, gen, dev="cuda"):
    """n Jacobian points P, Q with random Z, and every special case of the
    complete add in the mix: P == Q (other Z), P == -Q, P or Q or both at
    infinity; and a random 0/1 cond."""
    P, Q, kind = affine_pairs(curve, n, gen, dev)
    same, neg = kind == 1, kind == 2
    P, Q = rescale(curve, P, gen), rescale(curve, Q, gen)
    inf = curve.infinity((n,), dev)
    pin = (kind == 3) | (kind == 5)
    qin = (kind == 4) | (kind == 5)
    P = tuple(torch.where(_v(pin, c), o, c).contiguous() for c, o in zip(P, inf))
    Q = tuple(torch.where(_v(qin, c), o, c).contiguous() for c, o in zip(Q, inf))
    cond = (torch.rand(n, generator=gen) < 0.5).to(dev)
    return P, Q, cond, dict(pin=pin, qin=qin, same=same, neg=neg)


def check_points(curve, n, gen):
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    P, Q, cond, cases = test_points(curve, n, gen)
    ring_muls = 1 if nc == 1 else 3
    opm = ops_per_mul(spec)
    coord = spec.nlimbs * nc * 4  # bytes per coordinate
    nbytes_coord = n * coord
    normal = ~(cases["pin"] | cases["qin"] | cases["neg"] | cases["same"])
    dbl_lanes = cases["same"] & ~(cases["pin"] | cases["qin"])
    neg_lanes = cases["neg"] & ~(cases["pin"] | cases["qin"])
    add_muls = (int(normal.sum()) * MULS_ADD + int(dbl_lanes.sum()) * MULS_DBL_BRANCH
                + int(neg_lanes.sum()) * 8)
    saved = kernels.save_launches()
    rows = []
    tag = f"{curve.name} n=2^{n.bit_length() - 1}"

    out = po.point_add(spec, nc, P, Q)
    ref = po.point_add_plain(spec, nc, P, Q)
    torch.cuda.synchronize()
    bms, by = bound(9 * nbytes_coord, add_muls * ring_muls * opm)
    rows.append(("point_add", dict(
        case=tag, field=spec.name, max_abs_err=max_err(out, ref),
        ms=cuda_ms(lambda: po.point_add(spec, nc, P, Q), 10),
        plain_ms=cuda_ms(lambda: po.point_add_plain(spec, nc, P, Q), 1),
        bound_ms=bms, bound_by=by)))

    out = po.point_add_if(spec, nc, P, Q, cond)
    ref = po.point_add_if_plain(spec, nc, P, Q, cond)
    torch.cuda.synchronize()
    frac = float(cond.float().mean())
    bms, by = bound(6 * nbytes_coord + int(cond.sum()) * 3 * coord + n,
                    add_muls * frac * ring_muls * opm)
    rows.append(("point_add_if", dict(
        case=tag, field=spec.name, max_abs_err=max_err(out, ref),
        ms=cuda_ms(lambda: po.point_add_if(spec, nc, P, Q, cond), 10),
        plain_ms=cuda_ms(lambda: po.point_add_if_plain(spec, nc, P, Q, cond), 1),
        bound_ms=bms, bound_by=by)))

    for k in (1, 4):
        out = po.point_double(spec, nc, P, k)
        ref = po.point_double_plain(spec, nc, P, k)
        torch.cuda.synchronize()
        bms, by = bound(6 * nbytes_coord, n * k * MULS_DOUBLE * ring_muls * opm)
        rows.append(("point_double", dict(
            case=f"{tag} k={k}", field=spec.name, max_abs_err=max_err(out, ref),
            ms=cuda_ms(lambda: po.point_double(spec, nc, P, k), 10),
            plain_ms=cuda_ms(lambda: po.point_double_plain(spec, nc, P, k), 1),
            bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)  # comparison launches do not count
    return rows


def check_ring(curve, n, gen):
    """ring_mul at n and ring_inv at the inversion tree's root width 1,024,
    zeros among the inputs."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    shape = (n,) + curve.R.coord_shape[:-1]
    a, b = curve.R.F.rand(gen, shape, "cuda"), curve.R.F.rand(gen, shape, "cuda")
    a[:4] = 0
    saved = kernels.save_launches()
    rows = []
    ring_muls = 1 if nc == 1 else 3
    opm = ops_per_mul(spec)
    coord = spec.nlimbs * nc * 4
    out, ref = po.ring_mul(spec, nc, a, b), po.ring_mul_plain(spec, nc, a, b)
    torch.cuda.synchronize()
    bms, by = bound(3 * n * coord, n * ring_muls * opm)
    rows.append(("ring_mul", dict(
        case=f"{curve.name} n=2^{n.bit_length() - 1}", field=spec.name,
        max_abs_err=max_err([out], [ref]),
        ms=cuda_ms(lambda: po.ring_mul(spec, nc, a, b), 20),
        plain_ms=cuda_ms(lambda: po.ring_mul_plain(spec, nc, a, b), 1),
        bound_ms=bms, bound_by=by)))
    x = a[:1024].contiguous()
    e = spec.p - 2
    fermat = e.bit_length() - 1 + bin(e).count("1") - 1  # squares + products
    out, ref = po.ring_inv(spec, nc, x), po.ring_inv_plain(spec, nc, x)
    torch.cuda.synchronize()
    bms, by = bound(2 * 1024 * coord, 1024 * (fermat + (0 if nc == 1 else 4)) * opm)
    rows.append(("ring_inv", dict(
        case=f"{curve.name} n=1024", field=spec.name, max_abs_err=max_err([out], [ref]),
        ms=cuda_ms(lambda: po.ring_inv(spec, nc, x), 5),
        plain_ms=cuda_ms(lambda: po.ring_inv_plain(spec, nc, x), 1),
        bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)
    return rows


def check_affine_adds(curve, n_aadd, n_madd, gen):
    """point_aadd over n_aadd affine pairs with P == Q, P == -Q and infinity
    flags mixed in; point_madd_if over n_madd Jacobian accumulators (random
    Z, some at infinity) and affine nodes equal to them, to their
    negatives, or other, under a random cond."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    coord = spec.nlimbs * nc * 4
    ring_muls = 1 if nc == 1 else 3
    opm = ops_per_mul(spec)
    saved = kernels.save_launches()
    rows = []

    P, Q, kind = affine_pairs(curve, n_aadd, gen)
    P, Q = tuple(c.contiguous() for c in P[:2]), tuple(c.contiguous() for c in Q[:2])
    inf1, inf2 = (kind == 3) | (kind == 5), (kind == 4) | (kind == 5)
    live = ~(inf1 | inf2)
    samex, samey = (same_coord(P[i], Q[i]) for i in range(2))
    muls = (int((live & ~samex).sum()) * MULS_AADD
            + int((live & samex & samey).sum()) * MULS_DOUBLE)

    # the plain version in slices: the int64 temporaries of 2^22 G2 lanes
    # pass 80 GB; 2^20 lanes of 16 limbs, 2^19 of the 1.5x wider 24
    sl = 1 << 20 if spec.nlimbs == 16 else 1 << 19

    def plain():
        parts = [po.point_aadd_plain(spec, nc, tuple(c[i : i + sl] for c in P),
                                     tuple(c[i : i + sl] for c in Q),
                                     inf1[i : i + sl], inf2[i : i + sl])
                 for i in range(0, n_aadd, sl)]
        return tuple(torch.cat(cs) for cs in zip(*parts))

    out = po.point_aadd(spec, nc, P, Q, inf1, inf2)
    err = max_err(out, plain())
    del out
    bms, by = bound(7 * n_aadd * coord + 2 * n_aadd, muls * ring_muls * opm)
    rows.append(("point_aadd", dict(
        case=f"{curve.name} n=2^{n_aadd.bit_length() - 1}", field=spec.name, max_abs_err=err,
        ms=cuda_ms(lambda: po.point_aadd(spec, nc, P, Q, inf1, inf2), 5),
        plain_ms=cuda_ms(plain, 1), bound_ms=bms, bound_by=by)))
    del P, Q, inf1, inf2

    P, Q, kind = affine_pairs(curve, n_madd, gen)
    pin = kind == 3
    inf = curve.infinity((n_madd,), "cuda")
    A = tuple(torch.where(_v(pin, c), o, c).contiguous()
              for c, o in zip(rescale(curve, P, gen), inf))
    N = tuple(c.contiguous() for c in Q[:2])
    cond = (torch.rand(n_madd, generator=gen) < 0.5).to("cuda")
    on = cond & ~pin
    samex, samey = (same_coord(P[i], Q[i]) for i in range(2))
    muls = (int((on & ~(samex & ~samey)).sum()) * MULS_MADD
            + int((on & samex & ~samey).sum()) * MULS_MADD_NEG)
    out = po.point_madd_if(spec, nc, A, N, cond)
    ref = po.point_madd_if_plain(spec, nc, A, N, cond)
    torch.cuda.synchronize()
    bms, by = bound(6 * n_madd * coord + n_madd + int(cond.sum()) * 2 * coord,
                    muls * ring_muls * opm)
    rows.append(("point_madd_if", dict(
        case=f"{curve.name} n={n_madd}", field=spec.name, max_abs_err=max_err(out, ref),
        ms=cuda_ms(lambda: po.point_madd_if(spec, nc, A, N, cond), 10),
        plain_ms=cuda_ms(lambda: po.point_madd_if_plain(spec, nc, A, N, cond), 1),
        bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)
    return rows


def check_sort(rows_, n, gen):
    """sort_u32 over rows_ rows of n random keys, half with bit 31 set, and
    torch.sort of the same keys (widened to int64, as the plain version
    does) as the library yardstick."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.fields.sortperm import sort_u32, sort_u32_plain

    keys = torch.randint(-(1 << 31), 1 << 31, (rows_, n), generator=gen,
                         dtype=torch.int64).int().to("cuda")
    saved = kernels.save_launches()
    out, ref = sort_u32(keys), sort_u32_plain(keys)
    torch.cuda.synchronize()
    wide = keys.long() & 0xFFFFFFFF
    stages = (n.bit_length() - 1) * n.bit_length() // 2
    bms, by = bound(2 * 4 * keys.numel(), keys.numel() // 2 * stages)
    row = dict(case=f"{rows_} rows x 2^{n.bit_length() - 1} keys", max_abs_err=max_err([out], [ref]),
               ms=cuda_ms(lambda: sort_u32(keys), 10),
               plain_ms=cuda_ms(lambda: sort_u32_plain(keys), 3),
               library_ms=cuda_ms(lambda: torch.sort(wide, dim=-1), 10),
               bound_ms=bms, bound_by=by)
    kernels.restore_launches(saved)
    return [("sort_u32", row)]


def check_pippenger(curve, m, gen):
    """msm_best on the card for one party's m points (random Z, some at
    infinity, some zero scalars) against scalar_mul_w4 + sum on the card,
    as decoded affine points, with both wall times."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves.pippenger import msm_best

    saved = kernels.save_launches()
    P, _, kind = affine_pairs(curve, m, gen)
    inf = curve.infinity((m,), "cuda")
    P = tuple(torch.where(_v(kind == 3, c), o, c).contiguous()
              for c, o in zip(rescale(curve, P, gen), inf))
    s = curve.fr.rand(gen, (m,), "cuda")
    s[kind == 4] = 0
    times = {}
    for name, fn in (("msm_best", lambda: msm_best(curve, tuple(c[None] for c in P), s[None])),
                     ("w4_sum", lambda: curve.sum(curve.scalar_mul_w4(P, s), axis=0))):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0, curve.decode(tuple(c.reshape((1,) + c.shape[-curve._ncoord:]) for c in out)))
    kernels.restore_launches(saved)
    equal = times["msm_best"][1] == times["w4_sum"][1]
    return dict(case=f"{curve.name} m=2^{m.bit_length() - 1}, one party", equal=equal,
                msm_best_s=times["msm_best"][0], w4_sum_s=times["w4_sum"][0])


def card_peak_ops():
    """32-bit integer multiplies per second: SMs x 64 a clock x max SM clock."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * mhz * 1e6, sms, mhz


def main():
    global PEAK_OPS
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}")
    PEAK_OPS, sms, mhz = card_peak_ops()
    log(f"peak: {PEAK_BYTES:.3e} B/s; {PEAK_OPS:.4e} int32 multiplies/s ({sms} SMs x 64 x {mhz:.0f} MHz)")

    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves.curve import CURVE_FAMILIES, curve_g1, curve_g2
    from zksaas_tpu_torch.fields.spec import BLS12_377_FQ, BLS12_381_FQ, BN254_FQ, BN254_FR

    t0 = time.perf_counter()
    kernels.cuda_lib()
    log(f"build: {len(kernels.cuda_sources())} CUDA sources, one nvcc each, built in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(2026)
    cases = {k.name: [] for k in kernels.KERNELS}

    def record(rows):
        for name, row in rows:
            cases[name].append(row)
            log(f"check {name} {json.dumps(row)}")

    for spec in (BN254_FR, BN254_FQ, BLS12_381_FQ, BLS12_377_FQ):
        record([("montmul", check_montmul(spec, 1 << 20, gen))])
    # every field instance at the flagship's shapes: points at 2^18 (G1)
    # and 2^16 (G2); the inversion tree and affine products over 8 x 2^15
    # points, tree level 1 over 8 x 2^20 / 2 slots, the level-0 queries over
    # 8 x 32 windows x 255 buckets; the key sort over 8 rows of 2^20 keys
    for fam in CURVE_FAMILIES:
        for curve, lg in ((curve_g1(fam), 18), (curve_g2(fam), 16)):
            record(check_points(curve, 1 << lg, gen))
            record(check_ring(curve, 1 << 18, gen))
            record(check_affine_adds(curve, 1 << 22, 8 * 32 * 255, gen))
            torch.cuda.empty_cache()
    record(check_sort(8, 1 << 20, gen))
    for name, rows in cases.items():
        bad = [r for r in rows if r["max_abs_err"] != 0]
        if bad:
            raise SystemExit(f"{name} disagrees with its plain version: {bad}")
    pip = check_pippenger(curve_g1(), 1 << 15, gen)
    log(f"pippenger {json.dumps(pip)}")
    if not pip["equal"]:
        raise SystemExit(f"msm_best disagrees with scalar_mul_w4 + sum: {pip}")

    from zksaas_tpu_torch import sha256_e2e

    # the main path over BN254, then its BLS12-381 configuration; the
    # counts are set to 0 just before each and read just after
    paths = {}
    for fam in ("bn254", "bls12_381"):
        kernels.reset_launches()
        res = sha256_e2e.main(device="cuda", curve=fam)
        paths[fam] = dict(res=res, launches={k.name: k.launches for k in kernels.KERNELS},
                          by_field={k.name: dict(k.by_field) for k in kernels.KERNELS})
        log(f"flagship {json.dumps(res)}")
        if not res["verified"]:
            raise SystemExit(f"{fam} flagship proof failed the pairing check")
        if res["detail"]["constraints"] != 51454 or res["detail"]["domain"] != 1 << 16:
            raise SystemExit(f"{fam} flagship ran at the wrong size: {res['detail']}")
        prove = res["detail"]["launches"]
        idle = [n for n, c in paths[fam]["launches"].items() if c == 0]
        idle += [n for n, c in prove.items() if c == 0]
        if idle:
            raise SystemExit(f"kernels never launched on the {fam} path: {idle}")
        fq = f"{fam}_fq"
        missed = [n for n, by in res["detail"]["launches_by_field"].items()
                  if n not in ("montmul", "sort_u32") and not by.get(fq)]
        if missed:
            raise SystemExit(f"the {fam} prove never launched the {fq} instance of {missed}")
        torch.cuda.empty_cache()

    out = []
    for k in kernels.KERNELS:
        rows = cases[k.name]
        head = rows[0]
        out.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": sum(p["launches"][k.name] for p in paths.values()),
            "launches_by_path": {fam: {"total": p["launches"][k.name],
                                       "by_field": p["by_field"][k.name]}
                                 for fam, p in paths.items()},
            "prove_launches": {fam: {"total": p["res"]["detail"]["launches"][k.name],
                                     "by_field": p["res"]["detail"]["launches_by_field"][k.name]}
                               for fam, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head.get("library_ms"),
            "case": head["case"],
            "cases": rows,
        })
    print(f"card: {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
