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

from zksaas_tpu.fields.sortperm import sort_u32 as j_sort_u32
from zksaas_tpu_torch import kernels
from zksaas_tpu_torch.curves import point_ops
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.fields.field import field
from zksaas_tpu_torch.fields.montmul import montmul_plain
from zksaas_tpu_torch.fields.sortperm import sort_u32_plain
from zksaas_tpu_torch.fields.spec import BN254_FQ, BN254_FR

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)


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


@pytest.mark.parametrize("op", ["mul", "inv"])
@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_core_ring_matches_plain(core, ncoord, op):
    C = curve_g1() if ncoord == 1 else curve_g2()
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


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_core_madd_if_matches_plain(core, ncoord):
    C = curve_g1() if ncoord == 1 else curve_g2()
    n = 100
    P, Q = _points(C, n, seed=70 + ncoord)
    fin = ~C.is_inf(Q)
    Qa = C.to_affine(Q)[:2]  # the node is never at infinity: fold it into cond
    cond = torch.from_numpy(np.random.default_rng(5).random(n) < 0.7) & fin
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    nl, nr, prm = kernels.field_args(C.spec)
    core.zkc_point_madd_if(nl, nr, ncoord, *map(_ptr, (*P, *Qa, cond, *out)), n, prm)
    for o, r in zip(out, point_ops.point_madd_if_plain(C.spec, ncoord, P, Qa, cond)):
        assert torch.equal(o, r)


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
