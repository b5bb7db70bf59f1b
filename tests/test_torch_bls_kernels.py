"""The BLS12-381 and BLS12-377 instances of the kernels, checked on the CPU.

Kernels 1-8 over the 24-limb BLS12 base fields (BLS12-377's Fq2 with the
non-residue -5) have two CPU twins: their plain PyTorch versions (what the
wrappers run for CPU tensors) and the kernels' own field.cuh arithmetic built
with g++ (kernels.host_core()).  Here:

* the plain versions are held against the JAX package's kernel cores
  evaluated on numpy through fields/_xp, as tests/test_fused.py does:
  zksaas_tpu/fields/kernel_lib.py::kernel_field (montmul),
  zksaas_tpu/curves/fused.py::_kring (ring product; the ring inverse, whose
  product with its input must be the ring's one), _add_core, _double_core,
  _aadd_core and _madd_core, in G1 and G2 with P == Q, P == -Q and points at
  infinity among the lanes;
* the g++ build of the 12-limb cores is held against the plain versions.

No JAX curve graph is compiled.  Inputs come from seeded generators.
Tolerance: exact equality.
"""

import random
import shutil

import numpy as np
import pytest
import torch

from zksaas_tpu.curves.fused import _aadd_core, _add_core, _double_core, _kring, _madd_core
from zksaas_tpu.fields import BLS12_377_FQ as J_377
from zksaas_tpu.fields import BLS12_381_FQ as J_381
from zksaas_tpu.fields import BN254_FQ as J_BN
from zksaas_tpu.fields.kernel_lib import kernel_field
from zksaas_tpu_torch import convert, kernels
from zksaas_tpu_torch.curves import point_ops as po
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.fields.field import field
from zksaas_tpu_torch.fields.montmul import montmul_plain
from zksaas_tpu_torch.fields.spec import BLS12_377_FQ, BLS12_381_FQ

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)

J_FQ = {"bls12_381": J_381, "bls12_377": J_377, "bn254": J_BN}
CASES = [(fam, nc) for fam in ("bls12_381", "bls12_377") for nc in (1, 2)]
IDS = [f"{fam}-g{nc}" for fam, nc in CASES]


def _curve(fam, ncoord):
    return curve_g1(fam) if ncoord == 1 else curve_g2(fam)


def _np_elem(ncoord, coord):
    a = convert.to_numpy(coord)
    if ncoord == 1:
        return [a[:, k] for k in range(a.shape[-1])]
    return ([a[:, 0, k] for k in range(a.shape[-1])], [a[:, 1, k] for k in range(a.shape[-1])])


def _back(ncoord, elem):
    if ncoord == 1:
        return np.stack(elem, axis=-1)
    return np.stack([np.stack(c, axis=-1) for c in elem], axis=-2)


def _assert_core_eq(ncoord, got, core_out):
    for g, r in zip(got, core_out):
        np.testing.assert_array_equal(convert.to_numpy(g), _back(ncoord, r))


def _jac(C, pts, seed):
    """Jacobian encodings of affine points (None = infinity) with random Z."""
    X, Y, Z = C.encode(pts, device="cpu")
    lam = C.R.F.rand(torch.Generator().manual_seed(seed), (len(pts),) + C.R.coord_shape[:-1],
                     device="cpu")
    lam2 = C.R.square(lam)
    fin = ~C.is_inf((X, Y, Z))
    sel = lambda new, old: C.R.select(fin, new, old)
    return (sel(C.R.mul(X, lam2), X), sel(C.R.mul(Y, C.R.mul(lam2, lam)), Y),
            sel(C.R.mul(Z, lam), Z))


def _pairs(C, n, seed):
    """Affine P, Q: Q == P, Q == -P, P, Q or both at infinity in every
    5-lane group's lanes 0..4, other points elsewhere."""
    rng = random.Random(seed)
    pool = [C.ref.rand(rng) for _ in range(5)]
    P = [pool[i % 5] for i in range(n)]
    Q = [pool[(3 * i + 1) % 5] for i in range(n)]
    for i in range(0, n - 4, 8):
        Q[i] = P[i]
        Q[i + 1] = C.ref.neg(P[i + 1])
        P[i + 2] = None
        Q[i + 3] = None
        P[i + 4] = Q[i + 4] = None
    return P, Q


@pytest.mark.parametrize("spec", [BLS12_381_FQ, BLS12_377_FQ], ids=lambda s: s.name)
def test_montmul_plain_matches_jax_kernel_field(spec):
    """Both plain paths: the limb-major REDC (>= 256 elements) and the
    separated reduction of small batches."""
    F = field(spec)
    a, b = F.rand(torch.Generator().manual_seed(3), (2, 300), "cpu").long()
    a[0] = 0
    b[1] = F.const(1, device="cpu")
    f = kernel_field(J_FQ[spec.name[:-3]])
    want = np.stack(f.mm(*(_np_elem(1, x.int()) for x in (a, b))), axis=-1)
    np.testing.assert_array_equal(montmul_plain(spec, a, b).numpy(), want)
    np.testing.assert_array_equal(montmul_plain(spec, a[:40], b[:40]).numpy(), want[:40])


@pytest.mark.parametrize("fam,ncoord", CASES, ids=IDS)
def test_ring_mul_and_inv_match_jax_core(fam, ncoord):
    """ring_mul == _kring(...).mm; ring_inv(x) x == one by _kring(...).mm
    (the inverse is unique, so it is x^(p-2) as the TPU's Fermat gives it),
    and 0 maps to 0."""
    C = _curve(fam, ncoord)
    gen = torch.Generator().manual_seed(7 + ncoord)
    a, b = (C.R.F.rand(gen, (9,) + C.R.coord_shape[:-1], "cpu") for _ in range(2))
    a[0] = 0
    R = _kring(J_FQ[fam], ncoord)
    _assert_core_eq(ncoord, [po.ring_mul(C.spec, ncoord, a, b)],
                    [R.mm(_np_elem(ncoord, a), _np_elem(ncoord, b))])
    inv = po.ring_inv(C.spec, ncoord, a)
    assert not inv[0].any()
    prod = _back(ncoord, R.mm(_np_elem(ncoord, a[1:]), _np_elem(ncoord, inv[1:])))
    np.testing.assert_array_equal(prod, convert.to_numpy(C.R.ones((8,), "cpu")))


@pytest.mark.parametrize("fam,ncoord", CASES, ids=IDS)
def test_add_add_if_double_match_jax_core(fam, ncoord):
    C = _curve(fam, ncoord)
    P, Q = _pairs(C, 8, seed=10 + ncoord)
    P, Q = _jac(C, P, 11), _jac(C, Q, 12)
    R = _kring(J_FQ[fam], ncoord)
    add = _add_core(R, *(_np_elem(ncoord, c) for c in (*P, *Q)))
    _assert_core_eq(ncoord, C.add(P, Q), add)
    cond = torch.tensor([True, False, True, True, False, True, False, True])
    c = cond.numpy().reshape((-1,) + (1,) * ncoord)
    for g, a, p in zip(C.add_if(cond, P, Q), add, P):
        np.testing.assert_array_equal(convert.to_numpy(g),
                                      np.where(c, _back(ncoord, a), convert.to_numpy(p)))
    dbl = tuple(_np_elem(ncoord, x) for x in P)
    for _ in range(2):
        dbl = _double_core(R, *dbl)
    _assert_core_eq(ncoord, C.double(P, k=2), dbl)


@pytest.mark.parametrize("fam,ncoord", CASES, ids=IDS)
def test_aadd_and_madd_if_match_jax_core(fam, ncoord):
    """point_aadd on affine pairs with infinity flags; point_madd_if of a
    Jacobian accumulator and an affine node never at infinity (its flag
    folded into cond)."""
    C = _curve(fam, ncoord)
    R = _kring(J_FQ[fam], ncoord)
    P, Q = _pairs(C, 8, seed=20 + ncoord)
    infP = torch.tensor([p is None for p in P])
    infQ = torch.tensor([q is None for q in Q])
    Pa, Qa = C.encode(P, device="cpu")[:2], C.encode(Q, device="cpu")[:2]
    want = _aadd_core(R, *(_np_elem(ncoord, c) for c in (*Pa, *Qa)), infP.numpy(), infQ.numpy())
    _assert_core_eq(ncoord, po.point_aadd(C.spec, ncoord, Pa, Qa, infP, infQ), want)

    A = _jac(C, P, 21)
    cond = torch.tensor([True, True, True, False, False, True, False, True]) & ~infQ
    core = _madd_core(R, *(_np_elem(ncoord, c) for c in (*A, *Qa)))
    c = cond.numpy().reshape((-1,) + (1,) * ncoord)
    got = po.point_madd_if(C.spec, ncoord, A, Qa, cond)
    for g, o, a in zip(got, core, A):
        np.testing.assert_array_equal(convert.to_numpy(g),
                                      np.where(c, _back(ncoord, o), convert.to_numpy(a)))


@pytest.fixture(scope="module")
def core():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return kernels.host_core()


def _ptr(t):
    return t.data_ptr()


@pytest.mark.parametrize("fam,ncoord", CASES, ids=IDS)
def test_host_core_matches_plain(core, fam, ncoord):
    """The 12-limb field.cuh cores built with g++ (montmul, add_if, double,
    ring_mul, ring_inv, aadd, madd_if) == the plain versions, 40 lanes with
    every special case of the adds."""
    C = _curve(fam, ncoord)
    spec, n = C.spec, 40
    nl, nr, prm = kernels.field_args(spec)
    assert nl == 12 and nr == (-5 if fam == "bls12_377" else -1)
    Pa, Qa = _pairs(C, n, seed=30 + ncoord)
    P, Q = _jac(C, Pa, 31), _jac(C, Qa, 32)
    out = lambda: tuple(torch.empty_like(P[0]) for _ in range(3))
    cond = torch.from_numpy(np.random.default_rng(33).random(n) < 0.6)

    if ncoord == 1:
        o = torch.empty_like(P[0])
        assert core.zkc_montmul(nl, *map(_ptr, (P[0], Q[0], o)), n, prm) == 0
        assert torch.equal(o, montmul_plain(spec, P[0].long(), Q[0].long()).int())

    o = out()
    assert core.zkc_point_add_if(nl, nr, ncoord, *map(_ptr, (*P, *Q, cond, *o)), n, prm) == 0
    for x, y in zip(o, po.point_add_if_plain(spec, ncoord, P, Q, cond)):
        assert torch.equal(x, y)

    o = out()
    assert core.zkc_point_double(nl, nr, ncoord, *map(_ptr, (*P, *o)), n, 3, prm) == 0
    for x, y in zip(o, po.point_double_plain(spec, ncoord, P, 3)):
        assert torch.equal(x, y)

    a = P[2].clone()  # some zeros (the points at infinity)
    o = torch.empty_like(a)
    assert core.zkc_ring_mul(nl, nr, ncoord, *map(_ptr, (a, Q[0], o)), n, prm) == 0
    assert torch.equal(o, po.ring_mul_plain(spec, ncoord, a, Q[0]))
    assert core.zkc_ring_inv(nl, nr, ncoord, *map(_ptr, (a[:6], o)), 6, prm) == 0
    assert torch.equal(o[:6], po.ring_inv_plain(spec, ncoord, a[:6]))

    infP = torch.tensor([p is None for p in Pa])
    infQ = torch.tensor([q is None for q in Qa])
    A2, B2 = C.encode(Pa, device="cpu")[:2], C.encode(Qa, device="cpu")[:2]
    o = out()
    assert core.zkc_point_aadd(nl, nr, ncoord, *map(_ptr, (*A2, *B2, infP, infQ, *o)), n,
                               prm) == 0
    for x, y in zip(o, po.point_aadd_plain(spec, ncoord, A2, B2, infP, infQ)):
        assert torch.equal(x, y)

    o = out()
    cq = cond & ~infQ
    assert core.zkc_point_madd_if(nl, nr, ncoord, *map(_ptr, (*P, *B2, cq, *o)), n, prm) == 0
    for x, y in zip(o, po.point_madd_if_plain(spec, ncoord, P, B2, cq)):
        assert torch.equal(x, y)


ALL = [(fam, nc) for fam in ("bn254", "bls12_381", "bls12_377") for nc in (1, 2)]


@pytest.mark.parametrize("fam,ncoord", ALL, ids=[f"{f}-g{nc}" for f, nc in ALL])
def test_host_core_grouped_add_matches_plain_and_jax_core(core, fam, ncoord):
    """The grouped add's lane program (csrc/add_group.cuh: carry-chain Fq,
    the lanes looped serially) as the add (no cond) and the add-if, on one
    batch that mixes P == Q, P == -Q and points at infinity on either or both
    sides: == fused.py::_add_core through fields/_xp, and the add-if ==
    point_add_if_plain."""
    C = _curve(fam, ncoord)
    spec, n = C.spec, 16
    nl, nr, prm = kernels.field_args(spec)
    Pa, Qa = _pairs(C, n, seed=40 + ncoord)
    P, Q = _jac(C, Pa, 41), _jac(C, Qa, 42)
    want = _add_core(_kring(J_FQ[fam], ncoord), *(_np_elem(ncoord, c) for c in (*P, *Q)))
    o = tuple(torch.empty_like(P[0]) for _ in range(3))
    assert core.zkc_point_add_if(nl, nr, ncoord, *map(_ptr, (*P, *Q)), None, *map(_ptr, o), n,
                                 prm) == 0
    _assert_core_eq(ncoord, o, want)
    cond = torch.from_numpy(np.random.default_rng(43).random(n) < 0.6)
    assert core.zkc_point_add_if(nl, nr, ncoord, *map(_ptr, (*P, *Q, cond, *o)), n, prm) == 0
    c = cond.numpy().reshape((-1,) + (1,) * ncoord)
    for g, a, p, r in zip(o, want, P, po.point_add_if_plain(spec, ncoord, P, Q, cond)):
        np.testing.assert_array_equal(convert.to_numpy(g),
                                      np.where(c, _back(ncoord, a), convert.to_numpy(p)))
        assert torch.equal(g, r)


OPS = [(op, fam, nc) for op in ("double", "aadd") for fam, nc in ALL]


@pytest.mark.parametrize("op,fam,ncoord", OPS, ids=[f"{o}-{f}-g{nc}" for o, f, nc in OPS])
def test_host_core_grouped_double_and_aadd_match_plain_and_jax_core(core, op, fam, ncoord):
    """The grouped k-fold double and affine+affine add (csrc/add_group.cuh:
    carry-chain Fq, the lanes looped serially) at 16 lanes: the double of
    Jacobian points with random Z, two of them at infinity, at k = 1 and 3
    == fused.py::_double_core applied k times and point_double_plain; the
    aadd of affine pairs mixing P == Q, P == -Q and infinity flags on either
    or both sides == fused.py::_aadd_core and point_aadd_plain."""
    C = _curve(fam, ncoord)
    spec, n = C.spec, 16
    nl, nr, prm = kernels.field_args(spec)
    R = _kring(J_FQ[fam], ncoord)
    Pa, Qa = _pairs(C, n, seed=50 + ncoord)
    o = tuple(torch.empty(n, *C.R.coord_shape, dtype=torch.int32) for _ in range(3))
    if op == "double":
        P = _jac(C, Pa, 51)
        for k in (1, 3):
            assert core.zkc_point_double(nl, nr, ncoord, *map(_ptr, (*P, *o)), n, k, prm) == 0
            want = tuple(_np_elem(ncoord, c) for c in P)
            for _ in range(k):
                want = _double_core(R, *want)
            _assert_core_eq(ncoord, o, want)
            for g, r in zip(o, po.point_double_plain(spec, ncoord, P, k)):
                assert torch.equal(g, r)
    else:
        infP = torch.tensor([p is None for p in Pa])
        infQ = torch.tensor([q is None for q in Qa])
        A, B = C.encode(Pa, device="cpu")[:2], C.encode(Qa, device="cpu")[:2]
        assert core.zkc_point_aadd(nl, nr, ncoord, *map(_ptr, (*A, *B, infP, infQ, *o)), n,
                                   prm) == 0
        want = _aadd_core(R, *(_np_elem(ncoord, c) for c in (*A, *B)), infP.numpy(),
                          infQ.numpy())
        _assert_core_eq(ncoord, o, want)
        for g, r in zip(o, po.point_aadd_plain(spec, ncoord, A, B, infP, infQ)):
            assert torch.equal(g, r)


def test_host_core_refuses_what_was_not_built(core):
    """An (nl, nr) with no instance returns NOT_BUILT and touches nothing."""
    x = torch.zeros(2, 2, 16, dtype=torch.int32)
    prm = kernels.field_params(BLS12_377_FQ).ctypes.data
    assert core.zkc_ring_mul(8, -5, 2, *map(_ptr, (x, x, x)), 2, prm) == kernels.NOT_BUILT
    assert core.zkc_montmul(10, *map(_ptr, (x, x, x)), 2, prm) == kernels.NOT_BUILT
