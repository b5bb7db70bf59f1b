"""The port's point operations against the JAX package.

Kernels 2-4 (add, add_if, double(k)) on CPU tensors, i.e. their plain
versions, are held against the JAX package's kernel cores
zksaas_tpu/curves/fused.py::_add_core / _double_core evaluated on numpy
through fields/_xp (as tests/test_fused.py does), over G1 and G2, with the
complete add's special cases.  The scalar multiplications, fixed-base mul,
sum and to_affine are held against the host big-int oracle
zksaas_tpu/curves/ref.py.  Inputs come from seeded generators.  Tolerance:
exact equality (Jacobian limbs for the point kernels, affine points for
the rest).
"""

import random

import numpy as np
import pytest
import torch

from zksaas_tpu.curves import ref as jref
from zksaas_tpu.curves.fused import _add_core, _double_core, _kring
from zksaas_tpu.fields import BN254_FQ as J_FQ
from zksaas_tpu_torch import convert
from zksaas_tpu_torch.curves import point_ops
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.curves.fixed_base import fixed_base_mul

torch.set_num_threads(1)

JREF = {1: jref.BN254_G1, 2: jref.BN254_G2}


def _curve(ncoord):
    return curve_g1() if ncoord == 1 else curve_g2()


def _jac_points(C, pts, seed):
    """Encode affine points (None = infinity) with a random Z != 1."""
    X, Y, Z = C.encode(pts, device="cpu")
    lam = C.R.F.rand(torch.Generator().manual_seed(seed), (len(pts),) + C.R.coord_shape[:-1],
                     device="cpu")
    lam2 = C.R.square(lam)
    fin = ~C.is_inf((X, Y, Z))
    sel = lambda new, old: C.R.select(fin, new, old)
    return (sel(C.R.mul(X, lam2), X), sel(C.R.mul(Y, C.R.mul(lam2, lam)), Y),
            sel(C.R.mul(Z, lam), Z))


def _special_batch(C, n, seed):
    """P, Q with P == Q, P == -Q, P = inf, Q = inf and both inf at 0..4."""
    rng = random.Random(seed)
    pool = [C.ref.rand(rng) for _ in range(5)]
    P = [pool[i % 5] for i in range(n)]
    Q = [pool[(3 * i + 1) % 5] for i in range(n)]
    Q[0] = P[0]
    Q[1] = C.ref.neg(P[1])
    P[2] = None
    Q[3] = None
    P[4] = Q[4] = None
    return _jac_points(C, P, seed + 1), _jac_points(C, Q, seed + 2)


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


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_add_matches_jax_core(ncoord):
    C = _curve(ncoord)
    P, Q = _special_batch(C, 8, seed=ncoord)
    R = _kring(J_FQ, ncoord)
    ref = _add_core(R, *(_np_elem(ncoord, c) for c in (*P, *Q)))
    _assert_core_eq(ncoord, C.add(P, Q), ref)


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_add_if_matches_jax_core(ncoord):
    C = _curve(ncoord)
    P, Q = _special_batch(C, 8, seed=10 + ncoord)
    cond = torch.tensor([True, False, True, True, False, True, False, True])
    R = _kring(J_FQ, ncoord)
    add = _add_core(R, *(_np_elem(ncoord, c) for c in (*P, *Q)))
    got = C.add_if(cond, P, Q)
    c = cond.numpy()
    for g, a, p in zip(got, add, P):
        want = np.where(c.reshape((-1,) + (1,) * ncoord), _back(ncoord, a), convert.to_numpy(p))
        np.testing.assert_array_equal(convert.to_numpy(g), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_double_matches_jax_core(ncoord, k):
    C = _curve(ncoord)
    P, _ = _special_batch(C, 6, seed=20 + ncoord)
    R = _kring(J_FQ, ncoord)
    ref = tuple(_np_elem(ncoord, c) for c in P)
    for _ in range(k):
        ref = _double_core(R, *ref)
    _assert_core_eq(ncoord, C.double(P, k=k), ref)


def _scalars(C, n, seed):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % C.order for _ in range(n)]
    return ks, C.fr.encode(ks, device="cpu")


@pytest.mark.parametrize("method", ["scalar_mul", "scalar_mul_w4"])
@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_scalar_mul_matches_host_oracle(ncoord, method):
    C = _curve(ncoord)
    G = JREF[ncoord]
    rng = random.Random(30 + ncoord)
    pts = [G.rand(rng), G.rand(rng), None]
    ks, s = _scalars(C, 3, seed=31)
    ks[1] = 0
    s[1] = 0
    got = C.decode(getattr(C, method)(_jac_points(C, pts, 32), s))
    assert got == [G.mul(p, k) for p, k in zip(pts, ks)]


def test_scalar_mul_int_matches_host_oracle():
    C, G = curve_g1(), JREF[1]
    rng = random.Random(35)
    pts = [G.rand(rng), None]
    k = rng.randrange(C.order)
    assert C.decode(C.scalar_mul_int(_jac_points(C, pts, 36), k)) == [G.mul(p, k) for p in pts]


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_fixed_base_mul_matches_host_oracle(ncoord):
    C = _curve(ncoord)
    G = JREF[ncoord]
    ks, s = _scalars(C, 4, seed=40)
    ks[2] = 0
    s[2] = 0
    assert C.decode(fixed_base_mul(C, s.reshape(2, 2, -1))) == [G.mul(G.gen, k) for k in ks]


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_sum_and_to_affine_match_host_oracle(ncoord):
    C = _curve(ncoord)
    G = JREF[ncoord]
    rng = random.Random(50 + ncoord)
    pts = [G.rand(rng) for _ in range(5)] + [None]
    P = tuple(c.reshape((2, 3) + C.R.coord_shape) for c in _jac_points(C, pts, 51))
    total = C.sum(P, axis=1)
    want = [None, None]
    for i, p in enumerate(pts):
        want[i // 3] = G.add(want[i // 3], p)
    assert C.decode(total) == want
    X, Y, Z = C.to_affine(P)
    assert C.decode((X, Y, Z)) == pts
    assert torch.equal(Z.reshape(-1, *C.R.coord_shape)[-1], C.R.zeros((), "cpu"))


def test_point_wrappers_reject_bad_operands():
    C = curve_g1()
    P = C.infinity((4,), "cpu")
    P = tuple(c.contiguous() for c in P)
    with pytest.raises(ValueError):
        point_ops.point_add(C.spec, 1, P, tuple(c[:2] for c in P))
    with pytest.raises(ValueError):
        point_ops.point_add_if(C.spec, 1, P, P, torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        point_ops.point_double(C.spec, 2, P)
    with pytest.raises(ValueError):
        point_ops.point_double(C.spec, 1, P, k=0)
