"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from zksaas_tpu_torch/csrc with nvcc;
3. runs each kernel on the card at the main path's shapes and holds it
   bit for bit against its plain PyTorch version on the same inputs
   (tolerance: exact equality), timing both, and torch.sort beside the
   key sort as its library yardstick: every field instance of every
   kernel, BN254 (16 16-bit limbs), BLS12-381 and BLS12-377 (24 limbs,
   Fq2 nr = -5 for BLS12-377), G1 and G2; the add, add-if and double also
   at 16 points, the batch of the prove's binary scalar muls, and the
   double at the window fold's 8 points x 128 doublings and 128 x 8, timed
   as device time in a CUDA graph beside the empty kernel's (the launch
   floor); the mixed add-if at the level-0 queries' 65,280 lanes on random
   accumulators and on the main path's, every one at infinity, both in a
   CUDA graph; ring_mul at 2^18, 2^17, 8,192 and 1,024 elements and at a
   ragged 3,001 and 2^17 + 1, ring_inv at 1,024, both in a CUDA graph and
   on 0, 1, the Montgomery one and p - 1 (in Fq2 beside 0) among random
   elements; the key sort also at 8 x 2^19 keys and on edge cases (one
   row of 256 keys, rows shorter than a tile, all keys equal, all with bit
   31 set, a constant high byte); field_rand on the key its plain
   version (fields/field.py::rand_plain) runs on the card: the 28 m + 34
   elements of a BLS12-381 proof (m = 2^18) in one call, timed, then 2^16
   and 2^18 elements of BN254 Fr and BLS12-381 Fr and 2^16 + 1 of
   BLS12-381 Fq.  Each check's inputs come from a generator seeded by its
   kernel, ring and shape;
4. runs the bucket-Pippenger MSM (curves/pippenger.py::msm_best) on the
   card for one party's 2^15 BN254 G1 points and holds its affine result
   against scalar_mul_w4 + sum on the same card;
5. drives the flagship, zksaas_tpu_torch.sha256_e2e (the 51,454-constraint
   SHA-256 circuit, m = 2^16, 8 parties, l = 2), first over BN254, then
   over BLS12-381, each with every launch count set to 0 just before and
   read just after, and asserts that the pairing check passes, that every
   kernel launched, in the whole run and in the timed prove, that the
   BLS12-381 prove went through the BLS12-381 instance of every point and
   ring kernel, that the prove launched ring_mul 128, ring_inv 5 and
   point_madd_if 5 times, and that the BN254 proof comes back equal from
   its arkworks bytes (utils/serial.py);
6. runs the libsnark extended witness (groth16/ext_wit.py::libsnark_h) of
   the SHA-256 circuit at the flagship's m = 2^16 over LocalNet(8) on the
   card and holds the unpacked h against the host's libsnark witness map
   (groth16/local.py::witness_map); runs the blinded distributed partial
   products (dist/dpp.py::d_pp with PpBlind) over 2^16 num/den pairs and
   holds the unpacked result against the host's running product; each
   with every launch count set to 0 just before and read just after;
7. proves the BN254 flagship again with the same CRS, dealer shares, r and
   s over the TCP star on 127.0.0.1: this process is the king (party 0)
   and spawns the 7 client parties, one process each on the same card
   (zksaas_tpu_torch/host_prove.py; plain TCP, as the card's machine has
   no `cryptography` for mTLS), one warm-up prove and one timed; the
   unpacked proof must equal the LocalNet flagship's, pass the pairing
   check, every client must exit 0, and the king's timed d_prove must
   launch every kernel; it logs the rounds, the bytes each round moved and
   the king's split of its round time;
8. proves the BN254 flagship over JournalNet(LocalNet(8)) (comm/journal.py):
   (a) recording every round, (b) replaying all of them over a net whose
   round raises, (c) with the last record deleted, resuming over a LocalNet
   that must run exactly one live round; each gives the flagship's proof;
   it logs the records' bytes and each step's seconds;
9. proves the BN254 flagship with the same CRS, dealer shares, r and s
   as 8 ranks of a torch.distributed gloo group on the same card
   (zksaas_tpu_torch/spmd_prove.py over comm/net.py::SpmdNet): this process
   is rank 0 and spawns ranks 1-7; one warm-up prove and one timed; the
   unpacked proof must equal the LocalNet flagship's and pass the pairing
   check, every rank must exit 0, rank 0's timed d_prove must launch every
   kernel, and every rank's counters must show both fft rounds as
   all_to_all, shift, all_to_all, deg_red as two all_to_alls, and the five
   msm rounds and the collection as all_gathers alone; it logs each
   round's bytes and seconds, the host staging seconds, the spawn and
   bring-up seconds, and the timed prove beside the LocalNet flagship's;
10. prints the kernels line and, last, the device line.

Exits non-zero, before printing any result, when no CUDA device is present
or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from zksaas_tpu_torch.kernel_ab import graph_ms, launch_floor_ms  # noqa: E402

# H100 SXM memory rate (NVIDIA data sheet).  The operations peak is set in
# main() from the card: SMs x 64 32-bit integer multiplies (or compares)
# per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x the card's max SM clock.
PEAK_BYTES = 3.35e12
PEAK_OPS = None
MULS_ADD, MULS_DBL_BRANCH, MULS_DOUBLE = 16, 15, 7
# Montgomery products per lane of the new point kernels' branches
MULS_AADD, MULS_MADD, MULS_MADD_NEG = 6, 11, 4
# The safegcd inverse (csrc/field.cuh::FqInverse): int32 operations of one
# branch-free divstep (libsecp256k1's modinv32 step), and 32-bit multiplies
# a batch of 30 spends per 30-bit limb on its matrix (4 wide products for
# f, g and 6 for d, e, two multiplies each)
OPS_DIVSTEP, MULS_BATCH_LIMB = 28, 20
# ring_mul widths of the main path: the affine conversion's 2^18-point
# products, the inversion tree's widest level and two of its narrow ones
# near the root (1,024); and a ragged width on each side of the kernel's
# choice of layout (csrc/kernels.cuh::launch_ring_mul)
RING_MUL_WIDTHS = (1 << 18, 1 << 17, 8192, 1024, 3001, (1 << 17) + 1)
# launches of ring_mul, ring_inv and point_madd_if in one flagship prove
# (four G1 MSMs and one G2 MSM; both curves run the same windows)
PROVE_RING_MUL, PROVE_RING_INV, PROVE_MADD_IF = 128, 5, 5
# the d_pp phase: num/den pairs, l = 2 to a packed chunk
DPP_PAIRS = 1 << 16
# Field.rand's elements in one BLS12-381 proof at m = 2^18 (28 m + 34), and
# the 32-bit additions, xors and rotates of a ChaCha20 block (20 rounds of
# 4 quarter rounds of 12, and the final 16 additions).  field_rand's bound
# by operations counts these and its products' multiplies against the
# SM's dispatch rate, 4 schedulers x 32 lanes a clock, twice PEAK_OPS: its
# additions can go to the multiply-add pipe beside the xors and rotates,
# so PEAK_OPS alone would not bound it from below
RAND_LANES = 28 * (1 << 18) + 34
OPS_CHACHA_BLOCK = 20 * 4 * 12 + 16
DISPATCH_PER_MUL = 2


def log(msg):
    print(msg, flush=True)


def seeded(*key):
    """A generator seeded by a check's kernel, ring and shape, so that its
    inputs do not depend on which checks ran before it."""
    return torch.Generator().manual_seed(zlib.crc32(repr(key).encode()))


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


def check_montmul(spec, n):
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.fields.field import field
    from zksaas_tpu_torch.fields.montmul import montmul, montmul_plain

    F = field(spec)
    gen = seeded("montmul", spec.name, n)
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


def check_field_rand(spec, n):
    """zk_field_rand (through Field.rand) against rand_plain on the card, on
    the key Field.rand draws from the same generator state."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.fields.field import field, rand_blocks, rand_plain

    F = field(spec)
    gen = seeded("field_rand", spec.name, n)
    state = gen.get_state()
    key = torch.randint(0, 1 << 32, (8,), generator=gen, dtype=torch.int64)
    gen.set_state(state)
    saved = kernels.save_launches()
    out = F.rand(gen, (n,), "cuda")
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: rand_plain(spec, key, (n,), "cuda"), 1)
    err = max_err([out], [rand_plain(spec, key, (n,), "cuda")])
    ms = cuda_ms(lambda: F.rand(gen, (n,), "cuda"), 20)
    kernels.restore_launches(saved)
    ops = rand_blocks(spec, n) * OPS_CHACHA_BLOCK + 2 * n * ops_per_mul(spec)
    bms, by = bound(n * spec.nlimbs * 4, ops / DISPATCH_PER_MUL)
    return dict(case=f"{spec.name} n={n}", field=spec.name, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by)


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


def check_points(curve, n, small=False):
    """The add, add-if and double(k) over n points with every special case;
    small: the main path's batch, timed as device time in a CUDA graph, the
    double at k = 1, and at the window fold's shapes: 8 points doubled 128
    times, 128 points 8 times."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    P, Q, cond, cases = test_points(curve, n, seeded("points", curve.name, n))
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
    tag = f"{curve.name} n={n}" if small else f"{curve.name} n=2^{n.bit_length() - 1}"
    timed = graph_ms if small else (lambda fn: cuda_ms(fn, 10))

    out = po.point_add(spec, nc, P, Q)
    ref = po.point_add_plain(spec, nc, P, Q)
    torch.cuda.synchronize()
    bms, by = bound(9 * nbytes_coord, add_muls * ring_muls * opm)
    rows.append(("point_add", dict(
        case=tag, field=spec.name, max_abs_err=max_err(out, ref),
        ms=timed(lambda: po.point_add(spec, nc, P, Q)),
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
        ms=timed(lambda: po.point_add_if(spec, nc, P, Q, cond)),
        plain_ms=cuda_ms(lambda: po.point_add_if_plain(spec, nc, P, Q, cond), 1),
        bound_ms=bms, bound_by=by)))

    doubles = [(P, tag, 1)] if small else [(P, tag, 1), (P, tag, 4)]
    if small:
        for m, k in ((8, 128), (128, 8)):
            doubles.append((test_points(curve, m, seeded("double", curve.name, m, k))[0],
                            f"{curve.name} n={m}", k))
    for D, dtag, k in doubles:
        m = D[0].shape[0]
        out = po.point_double(spec, nc, D, k)
        ref = po.point_double_plain(spec, nc, D, k)
        torch.cuda.synchronize()
        bms, by = bound(6 * m * coord, m * k * MULS_DOUBLE * ring_muls * opm)
        rows.append(("point_double", dict(
            case=f"{dtag} k={k}", field=spec.name, max_abs_err=max_err(out, ref),
            ms=timed(lambda: po.point_double(spec, nc, D, k)),
            plain_ms=cuda_ms(lambda: po.point_double_plain(spec, nc, D, k), 1),
            bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)  # comparison launches do not count
    return rows


def special_ring_elements(curve, n, gen):
    """n random ring elements, the first of them 0, the integer 1, the
    Montgomery one and p - 1 (in Fq2 each beside 0 on either side), and in
    Fq2 elements with one random coordinate and the other 0."""
    spec, nc = curve.spec, curve._ncoord
    a = curve.R.F.rand(gen, (n,) + curve.R.coord_shape[:-1], "cuda")
    limbs = lambda x: torch.tensor([(x >> (16 * i)) & 0xFFFF for i in range(spec.nlimbs)],
                                   dtype=torch.int32, device="cuda")
    vals = [limbs(v) for v in (0, 1, spec.r_mod_p, spec.p - 1)]
    if nc == 1:
        for i, v in enumerate(vals):
            a[i] = v
    else:
        zero = torch.zeros_like(vals[0])
        for i, v in enumerate(vals):
            a[2 * i] = torch.stack([v, zero])
            a[2 * i + 1] = torch.stack([zero, v])
        a[8:12, 0] = 0
        a[12:16, 1] = 0
    return a


def divsteps(p, x):
    """The half-delta divsteps that take g = x to 0 from f = p
    (csrc/field.cuh::FqInverse)."""
    zeta, f, g, n = -1, p, x, 0
    while g:
        if g & 1:
            zeta, f, g = (-zeta - 2, g, (g - f) >> 1) if zeta < 0 else (zeta - 1, f, (g + f) >> 1)
        else:
            zeta, g = zeta - 1, g >> 1
        n += 1
    return n


def inv_ops(curve, x):
    """int32 operations the safegcd inverse needs for these inputs: each
    element's own divsteps and their matrices (the element FqInverse
    inverts: x in Fq, its norm in Fq2), and the Montgomery products around
    them (one by R^3; in Fq2 four more for the norm and the result)."""
    spec, nc = curve.spec, curve._ncoord
    nlimbs, limbs30 = spec.nlimbs, (16 * spec.nlimbs + 29) // 30
    val = lambda row: sum(int(v) << (16 * i) for i, v in enumerate(row))
    rows = x.reshape(x.shape[0], nc, nlimbs).cpu().tolist()
    rinv = pow(1 << (16 * nlimbs), -1, spec.p)
    from zksaas_tpu_torch.fields.spec import fq2_nonresidue

    nr = fq2_nonresidue(spec)
    ops = 0
    for r in rows:
        y = val(r[0]) if nc == 1 else (val(r[0]) ** 2 - nr * val(r[1]) ** 2) * rinv % spec.p
        steps = divsteps(spec.p, y)
        ops += steps * OPS_DIVSTEP + -(-steps // 30) * MULS_BATCH_LIMB * limbs30
    return ops + x.shape[0] * (1 if nc == 1 else 5) * ops_per_mul(spec)


def check_ring(curve):
    """ring_mul at RING_MUL_WIDTHS and ring_inv at the inversion tree's
    root width 1,024 on special_ring_elements, both timed as CUDA-graph
    device time: a launch from Python (the wrapper's checks, the output's
    allocation, the ctypes call) takes longer than the kernel at 2^17."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    saved = kernels.save_launches()
    rows = []
    ring_muls = 1 if nc == 1 else 3
    opm = ops_per_mul(spec)
    coord = spec.nlimbs * nc * 4
    for n in RING_MUL_WIDTHS:
        gen = seeded("ring_mul", curve.name, n)
        a, b = (special_ring_elements(curve, n, gen) for _ in range(2))
        b = b.flip(0).contiguous()
        out, ref = po.ring_mul(spec, nc, a, b), po.ring_mul_plain(spec, nc, a, b)
        torch.cuda.synchronize()
        bms, by = bound(3 * n * coord, n * ring_muls * opm)
        rows.append(("ring_mul", dict(
            case=f"{curve.name} n={n}" if n & (n - 1) or n <= 8192
            else f"{curve.name} n=2^{n.bit_length() - 1}", field=spec.name,
            max_abs_err=max_err([out], [ref]),
            ms=graph_ms(lambda: po.ring_mul(spec, nc, a, b)),
            plain_ms=cuda_ms(lambda: po.ring_mul_plain(spec, nc, a, b), 1),
            bound_ms=bms, bound_by=by)))
    x = special_ring_elements(curve, 1024, seeded("ring_inv", curve.name, 1024))
    out, ref = po.ring_inv(spec, nc, x), po.ring_inv_plain(spec, nc, x)
    torch.cuda.synchronize()
    bms, by = bound(2 * 1024 * coord, inv_ops(curve, x))
    rows.append(("ring_inv", dict(
        case=f"{curve.name} n=1024", field=spec.name, max_abs_err=max_err([out], [ref]),
        ms=graph_ms(lambda: po.ring_inv(spec, nc, x)),
        plain_ms=cuda_ms(lambda: po.ring_inv_plain(spec, nc, x), 1),
        bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)
    return rows


def madd_inputs(curve, n, at_infinity=False):
    """point_madd_if's inputs: n Jacobian accumulators (random Z, some at
    infinity) and affine nodes equal to them, to their negatives, or other,
    under a random cond; at_infinity: the main path's, every accumulator at
    infinity (Pippenger's level-0 queries start from curve.infinity), the
    same nodes and cond.  Also the Montgomery products and the coordinates
    read that the inputs need: cond false reads P, P at infinity Z1 and Q,
    the rest P and Q."""
    gen = seeded("madd_if", curve.name, n)
    P, Q, kind = affine_pairs(curve, n, gen)
    pin = kind == 3
    inf = curve.infinity((n,), "cuda")
    A = tuple(torch.where(_v(pin, c), o, c).contiguous()
              for c, o in zip(rescale(curve, P, gen), inf))
    N = tuple(c.contiguous() for c in Q[:2])
    cond = (torch.rand(n, generator=gen) < 0.5).to("cuda")
    if at_infinity:
        A, pin = tuple(c.contiguous() for c in inf), torch.ones_like(pin)
    on = cond & ~pin
    samex, samey = (same_coord(P[i], Q[i]) for i in range(2))
    muls = (int((on & ~(samex & ~samey)).sum()) * MULS_MADD
            + int((on & samex & ~samey).sum()) * MULS_MADD_NEG)
    reads = 3 * (n - int(cond.sum())) + 3 * int((cond & pin).sum()) + 5 * int(on.sum())
    return A, N, cond, muls, reads


def check_affine_adds(curve, n_aadd, n_madd):
    """point_aadd over n_aadd affine pairs with P == Q, P == -Q and infinity
    flags mixed in; point_madd_if over madd_inputs' n_madd lanes, random
    and with every accumulator at infinity, and over a ragged 3,001, as
    CUDA-graph device time."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves import point_ops as po

    spec, nc = curve.spec, curve._ncoord
    coord = spec.nlimbs * nc * 4
    ring_muls = 1 if nc == 1 else 3
    opm = ops_per_mul(spec)
    saved = kernels.save_launches()
    rows = []

    P, Q, kind = affine_pairs(curve, n_aadd, seeded("aadd", curve.name, n_aadd))
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

    # and a ragged width: the kernel hands a block's rows to its groups in
    # an order of their own, rows past the end last
    for n, at_inf in ((n_madd, False), (n_madd, True), (3001, False)):
        A, N, cond, muls, reads = madd_inputs(curve, n, at_inf)
        out = po.point_madd_if(spec, nc, A, N, cond)
        ref = po.point_madd_if_plain(spec, nc, A, N, cond)
        torch.cuda.synchronize()
        bms, by = bound((reads + 3 * n) * coord + n, muls * ring_muls * opm)
        rows.append(("point_madd_if", dict(
            case=f"{curve.name} n={n}" + (", every P at infinity" if at_inf else ""),
            field=spec.name, max_abs_err=max_err(out, ref),
            ms=graph_ms(lambda: po.point_madd_if(spec, nc, A, N, cond), 50),
            plain_ms=cuda_ms(lambda: po.point_madd_if_plain(spec, nc, A, N, cond), 1),
            bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)
    return rows


def sort_edge_cases(gen):
    """Key rows that take the sort's other branches: one row of 256 keys,
    rows shorter than a tile, and rows of several tiles with all keys equal,
    all with bit 31 set, or one high byte (a digit pass that copies)."""
    rand = lambda r, n: torch.randint(-(1 << 31), 1 << 31, (r, n), generator=gen,
                                      dtype=torch.int64).int()
    high = (rand(4, 1 << 16) & 0xFFFFFF) | (0x5A << 24)
    return {
        "one row of 256": rand(1, 256),
        "8 rows of 2048": rand(8, 2048),
        "all equal": torch.full((4, 1 << 16), -12345, dtype=torch.int32),
        "bit 31 set": rand(4, 1 << 16) | -(1 << 31),
        "constant high byte": high.int(),
    }


def check_sort(rows_, n, edge=False):
    """sort_u32 over rows_ rows of n random keys, half with bit 31 set, and
    torch.sort of the same keys (widened to int64, as the plain version
    does) as the library yardstick; edge: also the edge cases, bit for bit.
    The bound is the bytes: each key read and written once."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.fields.sortperm import sort_u32, sort_u32_plain

    gen = seeded("sort_u32", rows_, n)
    keys = torch.randint(-(1 << 31), 1 << 31, (rows_, n), generator=gen,
                         dtype=torch.int64).int().to("cuda")
    saved = kernels.save_launches()
    out, ref = sort_u32(keys), sort_u32_plain(keys)
    torch.cuda.synchronize()
    wide = keys.long() & 0xFFFFFFFF
    bms, by = bound(2 * 4 * keys.numel(), 0)
    row = dict(case=f"{rows_} rows x 2^{n.bit_length() - 1} keys", max_abs_err=max_err([out], [ref]),
               ms=cuda_ms(lambda: sort_u32(keys), 10),
               plain_ms=cuda_ms(lambda: sort_u32_plain(keys), 3),
               library_ms=cuda_ms(lambda: torch.sort(wide, dim=-1), 10),
               bound_ms=bms, bound_by=by)
    rows = [("sort_u32", row)]
    for name, k in (sort_edge_cases(gen).items() if edge else ()):
        k = k.to("cuda")
        err = max_err([sort_u32(k)], [sort_u32_plain(k)])
        bms, by = bound(2 * 4 * k.numel(), 0)
        w = k.long() & 0xFFFFFFFF
        rows.append(("sort_u32", dict(
            case=f"{name}: {k.shape[0]} rows x {k.shape[1]} keys", max_abs_err=err,
            ms=cuda_ms(lambda: sort_u32(k), 5), plain_ms=cuda_ms(lambda: sort_u32_plain(k), 3),
            library_ms=cuda_ms(lambda: torch.sort(w, dim=-1), 5), bound_ms=bms, bound_by=by)))
    kernels.restore_launches(saved)
    return rows


def check_pippenger(curve, m):
    """msm_best on the card for one party's m points (random Z, some at
    infinity, some zero scalars) against scalar_mul_w4 + sum on the card,
    as decoded affine points, with both wall times."""
    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.curves.pippenger import msm_best

    saved = kernels.save_launches()
    gen = seeded("pippenger", curve.name, m)
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


def counted(fn):
    """fn() with every launch count set to 0 just before it and read just
    after: its result, seconds, and the counts by kernel and by field."""
    from zksaas_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, dict(launches={k.name: k.launches for k in kernels.KERNELS},
                           by_field={k.name: dict(k.by_field) for k in kernels.KERNELS})


def run_libsnark_h():
    """libsnark_h of the SHA-256 circuit (BN254, m = 2^16, n = 8, l = 2) over
    LocalNet on the card, from the dealer's packed QAP and 7 masks; the
    unpacked h must be the host's libsnark witness map, m - 1
    coefficients, then a zero.  Returns its row, whether it agreed, and the
    launch counts of the libsnark_h call alone (not of the dealer's)."""
    from zksaas_tpu_torch.circom.sha256 import sha256_two_inputs
    from zksaas_tpu_torch.comm.net import LocalNet
    from zksaas_tpu_torch.fields.spec import BN254_FR
    from zksaas_tpu_torch.groth16 import libsnark_h, libsnark_masks
    from zksaas_tpu_torch.groth16.local import witness_map
    from zksaas_tpu_torch.groth16.qap import qap_pack
    from zksaas_tpu_torch.pss.pss import pss
    from zksaas_tpu_torch.utils.rng import generator, split

    r1cs, z, _ = sha256_two_inputs(1, 2, BN254_FR)
    pp = pss(BN254_FR, 2)
    ks = split(generator(11), 3)
    q = qap_pack(pp, r1cs, z, ks[0], "cuda")
    m = q.dom.n
    masks = libsnark_masks(pp, m, ks[1], "cuda")
    net = LocalNet(pp.n)
    h, dev_s, counts = counted(lambda: libsnark_h(pp, q, masks, net, ks[2]))
    got = list(pp.F.decode(pp.unpack(h.transpose(0, 1)).reshape(-1, pp.F.k)))
    t0 = time.perf_counter()
    want = witness_map(r1cs, z, "libsnark")
    host_s = time.perf_counter() - t0
    equal = got[: m - 1] == want and got[m - 1] == 0
    return dict(case=f"sha256 bn254 m=2^{m.bit_length() - 1}, {pp.n} parties, l={pp.l}",
                equal=equal, rounds=net.rounds, libsnark_h_s=dev_s,
                host_witness_map_s=host_s), equal, counts


def run_d_pp():
    """d_pp with PpBlind over DPP_PAIRS random nonzero num/den pairs (BN254
    Fr, 8 parties, l = 2) over LocalNet on the card; the unpacked result
    must be the host's running product of num_i den_i^-1 mod p.  Returns as
    run_libsnark_h does, the counts of the d_pp call alone."""
    import random

    from zksaas_tpu_torch.comm.net import LocalNet
    from zksaas_tpu_torch.dist import PpBlind, d_pp
    from zksaas_tpu_torch.dist.deg_red import DegRedMask
    from zksaas_tpu_torch.fields.spec import BN254_FR
    from zksaas_tpu_torch.pss.pss import pss
    from zksaas_tpu_torch.utils.rng import generator, split

    pp, p = pss(BN254_FR, 2), BN254_FR.p
    F, nch = pp.F, DPP_PAIRS // 2
    rng = random.Random(12)
    nums = [rng.randrange(1, p) for _ in range(DPP_PAIRS)]
    dens = [rng.randrange(1, p) for _ in range(DPP_PAIRS)]
    ks = split(generator(13), 5)
    shares = [pp.pack(F.encode(v, "cuda").reshape(nch, pp.l, F.k),
                      pp.rand_pads(k, (nch,), "cuda")).transpose(0, 1).contiguous()
              for v, k in ((nums, ks[0]), (dens, ks[1]))]
    mask = DegRedMask.sample(pp, nch, ks[2], "cuda")
    blind = PpBlind.sample(pp, nch, ks[3], "cuda")
    net = LocalNet(pp.n)
    out, dev_s, counts = counted(lambda: d_pp(pp, *shares, mask, net, ks[4], blind=blind))
    got = list(F.decode(pp.unpack(out.transpose(0, 1)).reshape(-1, F.k)))
    t0 = time.perf_counter()
    want, acc = [], 1
    for x, y in zip(nums, dens):
        acc = acc * x * pow(y, -1, p) % p
        want.append(acc)
    host_s = time.perf_counter() - t0
    equal = got == want
    return dict(case=f"bn254 fr {DPP_PAIRS} pairs, {nch} chunks, {pp.n} parties, PpBlind",
                equal=equal, rounds=net.rounds, d_pp_s=dev_s, host_product_s=host_s), equal, counts


def unpack_proof(pp, g1, g2, pi):
    """Proof shares with a leading party axis -> the affine (a, b, c)."""
    a = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, pi[0])))[0]
    b = g2.decode(tuple(c[:1] for c in pp.unpack2_g(g2, pi[1])))[0]
    c = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, pi[2])))[0]
    return a, b, c


def run_host_star(dealt, want):
    """The BN254 flagship's keys, shares, r and s over the TCP star: this
    process the king, 7 spawned client processes on the same card.  Returns
    its row, whether the proof equals `want` (the LocalNet flagship's
    affine a, b, c) and passes the pairing check, and the launch counts of
    the king process over the whole call."""
    from zksaas_tpu_torch import host_prove
    from zksaas_tpu_torch.groth16.local import Proof, verify
    from zksaas_tpu_torch.utils.rng import generator

    args, r1cs = dealt["args"], dealt["r1cs"]
    res, secs, counts = counted(lambda: host_prove.prove_king(
        *args, generator(10), timeout=900.0, warmup=True))
    proof = unpack_proof(*args[:3], res["shares"])
    verified = verify(dealt["vk"], dealt["z"][1 : r1cs.num_instance], Proof(*proof))
    equal = proof == want
    rounds = [dict(r, kind=k) for r, k in zip(res["rounds"], host_prove.ROUND_KINDS)]
    row = dict(case=f"sha256 bn254 m=2^16, {args[0].n} processes over TCP 127.0.0.1",
               equal=equal, verified=verified, exitcodes=res["exitcodes"], stats=res["stats"],
               rounds=rounds, king_split_s=res["king_split"], times_s=res["times"],
               prove_phases_s=res["prove_phases"], prove_launches=res["launches"], call_s=secs)
    idle = [k for k, n in res["launches"].items() if n == 0]
    ok = equal and verified and not idle and all(c == 0 for c in res["exitcodes"])
    return row, ok, counts


def spmd_rounds(log):
    """SpmdNet's collective log -> one entry a protocol round (its kind from
    host_prove.ROUND_KINDS, its ops in order, bytes, seconds)."""
    from zksaas_tpu_torch.host_prove import ROUND_KINDS

    rounds = []
    for e in log:
        if not rounds or rounds[-1]["round"] != e["round"]:
            kind = ROUND_KINDS[e["round"] - 1] if e["round"] <= len(ROUND_KINDS) else "extra"
            rounds.append(dict(round=e["round"], kind=kind, net_kind=e["kind"], ops=[],
                               bytes_out=0, bytes_in=0, s=0.0, stage_s=0.0))
        r = rounds[-1]
        r["ops"].append(e["op"])
        for k in ("bytes_out", "bytes_in", "s", "stage_s"):
            r[k] += e[k]
    return rounds


def spmd_path_checks(res):
    """What the spmd path must show: both fft rounds and deg_red as
    all_to_all pairs (the fft's with the boundary shift between them), the
    five msm rounds and the collection as all_gathers alone, on every rank."""
    from zksaas_tpu_torch.host_prove import ROUND_KINDS

    rounds = spmd_rounds(res["rounds"])
    want = [("fft", ["all_to_all", "shift", "all_to_all"])] * 2 + [("deg_red", ["all_to_all"] * 2)]
    checks = [("9 rounds", [r["kind"] for r in rounds] == list(ROUND_KINDS))]
    for r, (kind, ops) in zip(rounds, want):
        checks.append((f"round {r['round']} sharded {kind}", r["net_kind"] == kind and r["ops"] == ops))
    for r in rounds[3:]:
        checks.append((f"round {r['round']} {r['kind']} all_gathers",
                       r["net_kind"] == "gather" and set(r["ops"]) == {"all_gather"}))
    per_rank = [(st["rounds"], st["all_to_all"], st["shift"]) for st in res["stats"]]
    checks.append(("every rank: 9 rounds, 6 all_to_all, 2 shifts",
                   per_rank == [(9, 6, 2)] * len(res["stats"])))
    return rounds, checks


def run_spmd(dealt, want):
    """The BN254 flagship's keys, shares, r and s as 8 ranks over gloo on
    this card: this process rank 0, 7 spawned.  Returns as run_host_star
    does."""
    from zksaas_tpu_torch import spmd_prove
    from zksaas_tpu_torch.groth16.local import Proof, verify

    args, r1cs = dealt["args"], dealt["r1cs"]
    res, secs, counts = counted(lambda: spmd_prove.prove_spmd(
        *args, 10, "gloo", timeout=900.0, warmup=True))
    proof = unpack_proof(*args[:3], res["shares"])
    verified = verify(dealt["vk"], dealt["z"][1 : r1cs.num_instance], Proof(*proof))
    rounds, checks = spmd_path_checks(res)
    checks = [("equal", proof == want), ("verified", verified),
              ("every rank exits 0", res["exitcodes"] == [0] * (args[0].n - 1)),
              ("every kernel in rank 0's timed prove",
               all(n > 0 for n in res["launches"].values()))] + checks
    row = dict(case=f"sha256 bn254 m=2^16, {args[0].n} ranks, gloo on one card",
               checks=dict((k, bool(v)) for k, v in checks), exitcodes=res["exitcodes"],
               stats=res["stats"], rounds=rounds, times_s=res["times"],
               rank_times_s=res["rank_times"], prove_phases_s=res["prove_phases"],
               prove_launches=res["launches"], call_s=secs)
    return row, all(v for _, v in checks), counts


class _NoNet:
    """A net whose round raises: a replay that reaches it failed."""

    def __init__(self, n):
        self.n_parties = n

    def round(self, x, king_fn, channel=0):
        raise RuntimeError("the journal's replay reached the network")


def run_journal(dealt, want):
    """The BN254 flagship over JournalNet(LocalNet(8)) in a temporary
    directory: (a) record, (b) replay every round over _NoNet, (c) resume
    after deleting the last record over a LocalNet that runs one round.
    Returns as run_host_star does, the counts of the three proves."""
    import shutil
    import tempfile

    from zksaas_tpu_torch import kernels
    from zksaas_tpu_torch.comm import JournalNet, LocalNet
    from zksaas_tpu_torch.groth16.prove import d_prove
    from zksaas_tpu_torch.utils.rng import generator

    args = dealt["args"]
    pp = args[0]
    d = tempfile.mkdtemp(prefix="zksaas_journal_")
    steps, checks = {}, []
    try:
        kernels.reset_launches()
        for step, inner in (("record", LocalNet(pp.n)), ("replay", _NoNet(pp.n)),
                            ("resume", LocalNet(pp.n))):
            if step == "resume":
                os.unlink(os.path.join(d, f"round_{total - 1:04d}.ckpt"))
            net = JournalNet(inner, d)
            t0 = time.perf_counter()
            pi = d_prove(*args, net, generator(10))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if step == "record":
                total = net.rounds
                files = sorted(os.listdir(d))
                steps["record_bytes"] = sum(os.path.getsize(os.path.join(d, f)) for f in files)
                steps["records"] = len(files)
            steps[f"{step}_s"] = secs
            steps[f"{step}_replayed"] = net.replayed
            same = unpack_proof(*args[:3], pi) == want
            checks.append((step, same))
        checks.append(("replayed == rounds", steps["replay_replayed"] == total))
        checks.append(("resume replayed rounds - 1", steps["resume_replayed"] == total - 1))
        checks.append(("resume ran 1 live round", inner.rounds == 1))
        counts = dict(launches={k.name: k.launches for k in kernels.KERNELS},
                      by_field={k.name: dict(k.by_field) for k in kernels.KERNELS})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    row = dict(case=f"sha256 bn254 m=2^16, JournalNet(LocalNet({pp.n}))", rounds=total,
               checks=dict((k, bool(v)) for k, v in checks), **steps)
    return row, all(v for _, v in checks), counts


def serial_roundtrip(proof):
    """The flagship's BN254 proof (sha256_e2e's detail.proof: affine points
    as tuples of ints) to arkworks bytes and back: the hex and whether it
    came back equal."""
    from zksaas_tpu_torch.groth16.local import Proof
    from zksaas_tpu_torch.utils.serial import proof_from_bytes, proof_to_bytes

    pi = Proof(**proof)
    blob = proof_to_bytes(pi)
    back = proof_from_bytes(blob)
    return blob.hex(), (back.a, back.b, back.c) == (pi.a, pi.b, pi.c)


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
    t_start = time.perf_counter()
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
    from zksaas_tpu_torch.fields.spec import (BLS12_377_FQ, BLS12_381_FQ, BLS12_381_FR,
                                              BN254_FQ, BN254_FR)

    t0 = time.perf_counter()
    kernels.cuda_lib()
    log(f"build: {len(kernels.cuda_sources())} CUDA sources, one nvcc each, built in "
        f"{time.perf_counter() - t0:.1f} s")

    cases = {k.name: [] for k in kernels.KERNELS}

    def record(rows):
        for name, row in rows:
            cases[name].append(row)
            log(f"check {name} {json.dumps(row)}")

    for spec in (BN254_FR, BN254_FQ, BLS12_381_FQ, BLS12_377_FQ):
        record([("montmul", check_montmul(spec, 1 << 20))])
    for spec, n in ((BLS12_381_FR, RAND_LANES), (BN254_FR, 1 << 16), (BN254_FR, 1 << 18),
                    (BLS12_381_FR, 1 << 16), (BLS12_381_FR, 1 << 18),
                    (BLS12_381_FQ, (1 << 16) + 1)):
        record([("field_rand", check_field_rand(spec, n))])
    torch.cuda.empty_cache()
    # every field instance at the flagship's shapes: points at 2^18 (G1)
    # and 2^16 (G2), and at the binary scalar muls' 16; the inversion tree
    # and affine products over 8 x 2^15 points, tree level 1 over 8 x 2^20 / 2
    # slots, the level-0 queries over 8 x 32 windows x 255 buckets; the key
    # sort over 8 rows of 2^20 and of 2^19 keys
    floor = launch_floor_ms()
    log(f"launch floor: empty kernel {floor:.6f} ms a launch (CUDA graph)")
    for fam in CURVE_FAMILIES:
        for curve, lg in ((curve_g1(fam), 18), (curve_g2(fam), 16)):
            record(check_points(curve, 1 << lg))
            record(check_points(curve, 16, small=True))
            record(check_ring(curve))
            record(check_affine_adds(curve, 1 << 22, 8 * 32 * 255))
            torch.cuda.empty_cache()
    record(check_sort(8, 1 << 20, edge=True))
    record(check_sort(8, 1 << 19))
    for name, rows in cases.items():
        bad = [r for r in rows if r["max_abs_err"] != 0]
        if bad:
            raise SystemExit(f"{name} disagrees with its plain version: {bad}")
    pip = check_pippenger(curve_g1(), 1 << 15)
    log(f"pippenger {json.dumps(pip)}")
    if not pip["equal"]:
        raise SystemExit(f"msm_best disagrees with scalar_mul_w4 + sum: {pip}")

    from zksaas_tpu_torch import sha256_e2e

    # the main path over BN254, then its BLS12-381 configuration; the
    # counts are set to 0 just before each and read just after
    paths = {}
    dealt = {}  # the BN254 flagship's dealer state, for the host_star and journal paths
    for fam in ("bn254", "bls12_381"):
        kernels.reset_launches()
        res = sha256_e2e.main(device="cuda", curve=fam, dealt=dealt if fam == "bn254" else None)
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
                  if n not in ("montmul", "sort_u32", "field_rand") and not by.get(fq)]
        if missed:
            raise SystemExit(f"the {fam} prove never launched the {fq} instance of {missed}")
        want = dict(ring_mul=PROVE_RING_MUL, ring_inv=PROVE_RING_INV,
                    point_madd_if=PROVE_MADD_IF)
        if any(prove[k] != n for k, n in want.items()):
            raise SystemExit(f"the {fam} prove launched {[(k, prove[k]) for k in want]}, "
                             f"not {list(want.items())}")
        if fam == "bn254":
            blob, same = serial_roundtrip(res["detail"]["proof"])
            log(f"serial bn254 proof {blob}")
            if not same:
                raise SystemExit("the BN254 proof did not survive its arkworks bytes")
        torch.cuda.empty_cache()

    # this slice's protocol paths, after the flagships, which earlier
    # versions of this script timed with nothing of these run before them;
    # each reads the counts of its own call, set to 0 after the dealer's
    # set-up (which runs montmul too): both go through montmul alone
    phases = {}
    for name, run in (("libsnark_h", run_libsnark_h), ("d_pp", run_d_pp)):
        row, ok, phases[name] = run()
        launches = phases[name]["launches"]
        log(f"{name} {json.dumps(dict(row, launches=launches))}")
        if not ok:
            raise SystemExit(f"{name} disagrees with the host: {row}")
        if not launches["montmul"]:
            raise SystemExit(f"{name} never launched montmul")
        torch.cuda.empty_cache()

    # the deployment's transport, the round journal and the SPMD path, on
    # the BN254 flagship's dealer state; each must give the LocalNet
    # flagship's proof
    p = paths["bn254"]["res"]["detail"]["proof"]
    want = (p["a"], p["b"], p["c"])
    for name, run in (("host_star", run_host_star), ("journal", run_journal),
                      ("spmd", run_spmd)):
        row, ok, phases[name] = run(dealt, want)
        row["localnet_prove_s"] = paths["bn254"]["res"]["value"]
        log(f"{name} {json.dumps(dict(row, launches=phases[name]['launches']))}")
        if not ok:
            raise SystemExit(f"the {name} path failed: {row}")
        idle = [k for k, n in phases[name]["launches"].items() if n == 0]
        if idle:
            raise SystemExit(f"kernels never launched on the {name} path: {idle}")
        torch.cuda.empty_cache()

    out = []
    for k in kernels.KERNELS:
        rows = cases[k.name]
        head = rows[0]
        out.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": sum(p["launches"][k.name] for p in (*paths.values(), *phases.values())),
            "launches_by_path": {name: {"total": p["launches"][k.name],
                                        "by_field": p["by_field"][k.name]}
                                 for name, p in (*paths.items(), *phases.items())},
            "prove_launches": {fam: {"total": p["res"]["detail"]["launches"][k.name],
                                     "by_field": p["res"]["detail"]["launches_by_field"][k.name]}
                               for fam, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head.get("library_ms"),
            "case": head["case"],
            "launch_floor_ms": floor,
            "cases": rows,
        })
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
