"""The CUDA kernels' arithmetic, checked on the CPU.

csrc/field.cuh holds the field and point code every kernel runs, as
__host__ __device__ functions.  Here plain g++ builds it (csrc/host_core.cpp,
no torch headers) into a ctypes library under the port's git-ignored build
directory, once per test run, and its montmul, add, add_if, double(k),
ring product and inverse, affine+affine add, mixed add-if and the radix
sort's passes are compared with the plain PyTorch versions on a few hundred
elements, special cases included; the sort also with the JAX package's
sort_u32 (its jnp.sort branch on the CPU).  Tolerance: exact equality.  The
plain versions are held against the JAX package in test_torch_field.py /
test_torch_curve.py.
"""

import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksaas_tpu.curves.fused import _kring
from zksaas_tpu.fields import BLS12_377_FQ as J_377
from zksaas_tpu.fields import BLS12_381_FQ as J_381
from zksaas_tpu.fields import BN254_FQ as J_BN
from zksaas_tpu.fields.sortperm import sort_u32 as j_sort_u32
from zksaas_tpu_torch import kernels
from zksaas_tpu_torch.curves import point_ops
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.fields.field import field
from zksaas_tpu_torch.fields.montmul import montmul_plain
from zksaas_tpu_torch.fields.sortperm import sort_u32_plain
from zksaas_tpu_torch.fields.spec import FIELDS, BN254_FQ, BN254_FR, fq2_nonresidue

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)

J_FQ = {"bls12_381": J_381, "bls12_377": J_377, "bn254": J_BN}


@pytest.fixture(scope="module")
def core():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return kernels.host_core()


def _ptr(t):
    return t.data_ptr()


def _points(C, n, seed):
    """n Jacobian points with random Z; P == Q, P == -Q and infinity on
    either or both sides among them."""
    rng = random.Random(seed)
    pool = [C.ref.rand(rng) for _ in range(8)]
    P = [pool[rng.randrange(8)] for _ in range(n)]
    Q = [pool[rng.randrange(8)] for _ in range(n)]
    for i in range(0, n, 10):
        Q[i] = P[i]
        Q[i + 1] = C.ref.neg(P[i + 1])
        P[i + 2] = None
        Q[i + 3] = None
        P[i + 4] = Q[i + 4] = None

    def jac(pts, s):
        X, Y, Z = (c.clone() for c in C.encode(pts, device="cpu"))
        gen = torch.Generator().manual_seed(s)
        lam = C.R.F.rand(gen, (n,) + C.R.coord_shape[:-1], device="cpu")
        lam2 = C.R.square(lam)
        fin = ~C.is_inf((X, Y, Z))
        sel = lambda new, old: C.R.select(fin, new, old)
        return (sel(C.R.mul(X, lam2), X), sel(C.R.mul(Y, C.R.mul(lam2, lam)), Y),
                sel(C.R.mul(Z, lam), Z))

    return jac(P, seed + 1), jac(Q, seed + 2)


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ], ids=lambda s: s.name)
def test_core_montmul_matches_plain(core, spec):
    F = field(spec)
    gen = torch.Generator().manual_seed(11)
    a, b = F.rand(gen, (300,), device="cpu"), F.rand(gen, (300,), device="cpu")
    a[0] = 0
    b[1] = F.const(1, device="cpu")
    out = torch.empty_like(a)
    nl, _, prm = kernels.field_args(spec)
    core.zkc_montmul(nl, _ptr(a), _ptr(b), _ptr(out), 300, prm)
    assert torch.equal(out, montmul_plain(spec, a.long(), b.long()).int())


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fr", "bls12_381_fq"])
def test_core_field_rand_matches_plain(core, name):
    """zk_field_rand's core (an element a lane, from the one or two ChaCha20
    blocks its words lie in) against Field.rand's plain version on the same
    key: shape (), and an odd count of 37, which at K = 24 ends in the
    middle of a block."""
    spec = FIELDS[name]
    F = field(spec)
    nl, _, prm = kernels.field_args(spec)
    for seed, shape in ((31, ()), (32, (37,))):
        gen = torch.Generator().manual_seed(seed)
        key = torch.randint(0, 1 << 32, (8,), generator=gen, dtype=torch.int64)
        want = F.rand(torch.Generator().manual_seed(seed), shape, device="cpu")
        out = torch.empty_like(want)
        words = key.numpy().astype(np.uint32)
        assert core.zkc_field_rand(nl, words.ctypes.data, _ptr(out), out.numel() // F.k,
                                   prm) == 0
        assert torch.equal(out, want)


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
@pytest.mark.parametrize("with_cond", [False, True], ids=["add", "add_if"])
def test_core_add_matches_plain(core, ncoord, with_cond):
    C = curve_g1() if ncoord == 1 else curve_g2()
    n = 200
    P, Q = _points(C, n, seed=20 + ncoord)
    rng = np.random.default_rng(3)
    cond = torch.from_numpy(rng.random(n) < 0.5) if with_cond else torch.ones(n, dtype=torch.bool)
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    nl, nr, prm = kernels.field_args(C.spec)
    core.zkc_point_add_if(nl, nr, ncoord, *map(_ptr, (*P, *Q)), _ptr(cond), *map(_ptr, out), n,
                          prm)
    if with_cond:
        ref = point_ops.point_add_if_plain(C.spec, ncoord, P, Q, cond)
    else:
        ref = point_ops.point_add_plain(C.spec, ncoord, P, Q)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_core_double_matches_plain(core, ncoord, k):
    C = curve_g1() if ncoord == 1 else curve_g2()
    n = 100
    P, _ = _points(C, n, seed=40 + ncoord)
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    nl, nr, prm = kernels.field_args(C.spec)
    core.zkc_point_double(nl, nr, ncoord, *map(_ptr, P), *map(_ptr, out), n, k, prm)
    for o, r in zip(out, point_ops.point_double_plain(C.spec, ncoord, P, k)):
        assert torch.equal(o, r)


def _int(limbs):
    return sum(int(v) << (16 * i) for i, v in enumerate(limbs))


def _limbs(spec, x):
    return torch.tensor([(x >> (16 * i)) & 0xFFFF for i in range(spec.nlimbs)], dtype=torch.int32)


def _special(C, ncoord, seed):
    """Ring elements that stress the inverse and the product: 0, the
    integer 1, the Montgomery one, p - 1, and in Fq2 each of them beside 0
    and beside a random coordinate, then random elements (40 in all)."""
    spec = C.spec
    a = C.R.F.rand(torch.Generator().manual_seed(seed), (40,) + C.R.coord_shape[:-1], "cpu")
    vals = [_limbs(spec, v) for v in (0, 1, spec.r_mod_p, spec.p - 1)]
    if ncoord == 1:
        for i, v in enumerate(vals):
            a[i] = v
    else:
        for i, v in enumerate(vals):
            a[3 * i] = torch.stack([v, torch.zeros_like(v)])
            a[3 * i + 1] = torch.stack([torch.zeros_like(v), v])
            a[3 * i + 2, 1] = v
    return a


def _divstep_batches(p, x):
    """Batches of 30 half-delta divsteps that take (p, x) to g = 0."""
    zeta, f, g, n = -1, p, x, 0
    while g:
        for _ in range(30):
            if g & 1:
                zeta, f, g = (-zeta - 2, g, (g - f) >> 1) if zeta < 0 else (zeta - 1, f, (g + f) >> 1)
            else:
                zeta, g = zeta - 1, g >> 1
        n += 1
    return n


def ring_core_case(core, C, ncoord, op, kind):
    """The g++ ring_mul / ring_inv (csrc/field.cuh: cc_mont, FqInverse) on
    the _special inputs or (kind "warp64") on 64 random ones run as one
    emulated warp, == ring_mul_plain / ring_inv_plain and the JAX kernel
    core (fused.py::_kring: its product, and its product of each nonzero
    input with its inverse is the ring's one; 0 maps to 0).  warp64 also
    checks that its lanes needed different numbers of divstep batches, so
    the lanes done first went on stepping until the last was done."""
    spec = C.spec
    R = _kring(J_FQ[spec.name[:-3]], ncoord)
    if kind == "special":
        a = _special(C, ncoord, 90 + ncoord)
    else:  # 0 and the integer 1 (c0 of an Fq2 element) finish their divsteps first
        a = C.R.F.rand(torch.Generator().manual_seed(95 + ncoord), (64,) + C.R.coord_shape[:-1],
                       "cpu")
        a[0] = 0
        a[1] = 0
        a[1].view(-1)[0] = 1
    n = a.shape[0]
    nl, nr, prm = kernels.field_args(spec)
    out = torch.empty_like(a)
    elem = lambda x: _elem(ncoord, x)
    if op == "mul":
        b = a.flip(0).contiguous()
        assert core.zkc_ring_mul(nl, nr, ncoord, _ptr(a), _ptr(b), _ptr(out), n, prm) == 0
        assert torch.equal(out, point_ops.ring_mul_plain(spec, ncoord, a, b))
        np.testing.assert_array_equal(out.numpy(), _unelem(ncoord, R.mm(elem(a), elem(b))))
        return
    assert core.zkc_ring_inv(nl, nr, ncoord, _ptr(a), _ptr(out), n, prm) == 0
    assert torch.equal(out, point_ops.ring_inv_plain(spec, ncoord, a))
    zero = (a == 0).flatten(1).all(1)
    assert not out[zero].any()
    nz = ~zero
    one = C.R.ones((int(nz.sum()),), "cpu")
    np.testing.assert_array_equal(_unelem(ncoord, R.mm(elem(a[nz]), elem(out[nz]))), one.numpy())
    if kind == "warp64":
        rinv = pow(1 << (16 * spec.nlimbs), -1, spec.p)
        c = a.reshape(n, ncoord, -1)
        norm = [(_int(x[0]) ** 2 - fq2_nonresidue(spec) * _int(x[-1]) ** 2 if ncoord == 2
                 else _int(x[0])) * (rinv if ncoord == 2 else 1) % spec.p for x in c]
        batches = [_divstep_batches(spec.p, x) for x in norm]
        assert min(batches) < max(batches), batches


def _elem(ncoord, x):
    """(n, *coord) int32 limbs -> the JAX kernel core's element (lists of
    (n,) uint32 limb arrays)."""
    a = x.numpy().astype(np.uint32)
    if ncoord == 1:
        return [a[:, k] for k in range(a.shape[-1])]
    return tuple([a[:, c, k] for k in range(a.shape[-1])] for c in range(2))


def _unelem(ncoord, e):
    if ncoord == 1:
        return np.stack(e, axis=-1).astype(np.int32)
    return np.stack([np.stack(c, axis=-1) for c in e], axis=-2).astype(np.int32)


@pytest.mark.parametrize("op", ["mul", "inv"])
@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_core_ring_matches_plain(core, ncoord, op):
    """The g++ ring_mul / ring_inv: ring_core_case on the special inputs
    and, for the inverse, on 64 lanes as one emulated warp; then == the
    plain versions on random inputs."""
    C = curve_g1() if ncoord == 1 else curve_g2()
    ring_core_case(core, C, ncoord, op, "special")
    if op == "inv":
        ring_core_case(core, C, ncoord, op, "warp64")
    n = 64 if op == "mul" else 6
    gen = torch.Generator().manual_seed(50 + ncoord)
    a, b = (C.R.F.rand(gen, (n,) + C.R.coord_shape[:-1], device="cpu") for _ in range(2))
    a[0] = 0
    out = torch.empty_like(a)
    nl, nr, prm = kernels.field_args(C.spec)
    if op == "mul":
        core.zkc_ring_mul(nl, nr, ncoord, _ptr(a), _ptr(b), _ptr(out), n, prm)
        ref = point_ops.ring_mul_plain(C.spec, ncoord, a, b)
    else:
        core.zkc_ring_inv(nl, nr, ncoord, _ptr(a), _ptr(out), n, prm)
        ref = point_ops.ring_inv_plain(C.spec, ncoord, a)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_core_aadd_matches_plain(core, ncoord):
    """Affine P, Q (the Z == 1 points of _points' mix): P == Q, P == -Q,
    and infinity flags on either or both sides."""
    C = curve_g1() if ncoord == 1 else curve_g2()
    n = 100
    P, Q = _points(C, n, seed=60 + ncoord)
    P, Q = C.to_affine(P)[:2], C.to_affine(Q)[:2]
    rng = np.random.default_rng(4)
    inf1 = torch.from_numpy(rng.random(n) < 0.2)
    inf2 = torch.from_numpy(rng.random(n) < 0.2)
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    nl, nr, prm = kernels.field_args(C.spec)
    core.zkc_point_aadd(nl, nr, ncoord, *map(_ptr, (*P, *Q, inf1, inf2, *out)), n, prm)
    for o, r in zip(out, point_ops.point_aadd_plain(C.spec, ncoord, P, Q, inf1, inf2)):
        assert torch.equal(o, r)


def madd_core_inputs(C, n, seed, kind):
    """Jacobian accumulators P, affine nodes Q never at infinity and a cond
    for the mixed add-if: "mix", _points' pairs (P == Q with another Z,
    P == -Q, P at infinity) under a random cond; "p_inf", every P at
    infinity under a random cond, as Pippenger's level-0 queries give them;
    "special", every fourth lane P == Q, the next P == -Q, the next cond
    false, the last a random pair."""
    P, Q = _points(C, n, seed)
    fin = ~C.is_inf(Q)
    Qa = C.to_affine(Q)[:2]  # the node is never at infinity: fold it into cond
    cond = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.7) & fin
    if kind == "p_inf":
        P = tuple(c.contiguous() for c in C.infinity((n,), "cpu"))
    elif kind == "special":
        rng = random.Random(seed)
        pool = [C.ref.rand(rng) for _ in range(8)]
        Qp = [pool[rng.randrange(8)] for _ in range(n)]
        Pp = [q if i % 4 == 0 else C.ref.neg(q) if i % 4 == 1 else pool[rng.randrange(8)]
              for i, q in enumerate(Qp)]
        X, Y, Z = C.encode(Pp, device="cpu")  # Z = 1: give each point a random Z
        z = C.R.F.rand(torch.Generator().manual_seed(seed + 3), (n,) + C.R.coord_shape[:-1],
                       device="cpu")
        z2 = C.R.square(z)
        P = (C.R.mul(X, z2), C.R.mul(Y, C.R.mul(z2, z)), C.R.mul(Z, z))
        Qa = C.encode(Qp, device="cpu")[:2]
        cond = torch.tensor([i % 4 != 2 for i in range(n)])
    return P, Qa, cond


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_core_madd_if_matches_plain(core, ncoord):
    """The grouped mixed add-if, lanes looped serially, == the plain
    version on each of madd_core_inputs' kinds."""
    C = curve_g1() if ncoord == 1 else curve_g2()
    n = 100
    nl, nr, prm = kernels.field_args(C.spec)
    for kind in ("mix", "p_inf", "special"):
        P, Qa, cond = madd_core_inputs(C, n, 70 + ncoord, kind)
        out = tuple(torch.empty_like(P[0]) for _ in range(3))
        assert core.zkc_point_madd_if(nl, nr, ncoord, *map(_ptr, (*P, *Qa, cond, *out)), n,
                                      prm) == 0
        for o, r in zip(out, point_ops.point_madd_if_plain(C.spec, ncoord, P, Qa, cond)):
            assert torch.equal(o, r), kind


def test_core_sort_matches_plain(core):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 1 << 32, size=(3, 1024), dtype=np.uint64).astype(np.uint32)
    keys[:, ::3] |= np.uint32(1 << 31)
    keys[2, 500:520] = keys[2, 7]
    t = torch.from_numpy(keys.view(np.int32).copy())
    out = t.clone()
    core.zkc_sort_u32(_ptr(out), out.numel(), 1024)
    assert torch.equal(out, sort_u32_plain(t))


def _sort_keys(case):
    """uint32 key rows for one case: 4 x 4,096 (one tile a row) unless the
    case is about the shape."""
    rng = np.random.default_rng(sum(map(ord, case)))
    draw = lambda shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    if case == "one_row_256":
        return draw((1, 256))
    if case == "rows_below_a_tile":
        return draw((4, 1024))
    if case == "multi_tile_rows":  # 4 tiles a row: random, one key, one high byte
        keys = draw((3, 16384))
        keys[1] = keys[1, 5]
        keys[2] = (keys[2] & np.uint32(0xFFFFFF)) | np.uint32(0xA5 << 24)
        return keys
    keys = draw((4, 4096))
    if case == "all_equal":
        keys[:] = keys[0, 0]
    elif case == "bit31_set":
        keys |= np.uint32(1 << 31)
    elif case == "high_byte_constant":
        keys = (keys & np.uint32(0xFFFFFF)) | np.uint32(0x5A << 24)
    return keys


@pytest.mark.parametrize("case", ["random", "one_row_256", "rows_below_a_tile", "all_equal",
                                  "bit31_set", "high_byte_constant", "multi_tile_rows"])
def test_core_radix_sort_matches_plain_and_jax(core, case):
    """The radix sort's passes (tiles, counts, scan, stable scatter, the
    copy of a row whose keys share a digit), run serially, == sort_u32_plain
    == the JAX sort_u32 row by row."""
    keys = _sort_keys(case)
    t = torch.from_numpy(keys.view(np.int32).copy())
    out = t.clone()
    assert core.zkc_sort_u32(_ptr(out), out.numel(), keys.shape[1]) == 0
    assert torch.equal(out, sort_u32_plain(t))
    want = np.stack([np.asarray(j_sort_u32(jnp.asarray(r))) for r in keys])
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)


def test_field_params_are_the_32bit_montgomery_constants():
    prm = kernels.field_params(BN254_FQ)
    p = sum(int(v) << (32 * i) for i, v in enumerate(prm[:8]))
    one = sum(int(v) << (32 * i) for i, v in enumerate(prm[8:16]))
    assert p == BN254_FQ.p and one == (1 << 256) % p
    assert (int(prm[16]) * p) % (1 << 32) == (1 << 32) - 1  # n0 = -p^-1 mod 2^32
