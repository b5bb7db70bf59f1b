"""The port's bucket-Pippenger MSM and its five kernels' plain versions.

* ring_mul, ring_inv, point_aadd and point_madd_if on CPU tensors (their
  plain versions) are held bit for bit against the JAX package's kernel
  cores (zksaas_tpu/curves/fused.py::_kring(...).mm, _aadd_core,
  _madd_core, and a Fermat loop of the JAX kernel_field) evaluated on numpy
  through fields/_xp, as tests/test_fused.py does, in G1 and G2 with every
  special case of the adds.
* sort_u32's plain version is held against jnp.sort on keys with bit 31 set.
* msm_best is held, as affine points, against the JAX package's host oracle
  zksaas_tpu/curves/ref.py at m = 256 in G1 (through JCurve.msm) and G2,
  and at a non-power-of-two m whose point axis is cut into chunks, where
  the port's scalar_mul_w4 + sum (JCurve.msm below 256) is held too.
* d_msm at 256 chunks per party over 8 parties (the Pippenger branch)
  unpacks, on the host, to the host-oracle MSM.

The JAX msm_pippenger itself is not run: XLA:CPU takes far too long to
compile it (tests/test_curve.py).  Inputs come from seeded generators.
Tolerance: exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksaas_tpu.curves import ref as jref
from zksaas_tpu.curves.fused import _aadd_core, _kring, _madd_core
from zksaas_tpu.fields import BN254_FQ as J_FQ
from zksaas_tpu.fields.kernel_lib import kernel_field
from zksaas_tpu_torch import convert
from zksaas_tpu_torch.comm.net import LocalNet
from zksaas_tpu_torch.curves import pippenger
from zksaas_tpu_torch.curves import point_ops as po
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.curves.fixed_base import fixed_base_mul
from zksaas_tpu_torch.dist.dmsm import MsmMask, d_msm
from zksaas_tpu_torch.fields.sortperm import sort_u32, sort_u32_plain
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator, split

torch.set_num_threads(1)

JREF = {1: jref.BN254_G1, 2: jref.BN254_G2}


def _curve(ncoord):
    return curve_g1() if ncoord == 1 else curve_g2()


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


def _rescaled(C, pts, seed):
    """Jacobian encodings of affine points (None = infinity) with random Z."""
    X, Y, Z = C.encode(pts, device="cpu")
    lam = C.R.F.rand(torch.Generator().manual_seed(seed), (len(pts),) + C.R.coord_shape[:-1],
                     device="cpu")
    lam2 = C.R.square(lam)
    fin = ~C.is_inf((X, Y, Z))
    sel = lambda new, old: C.R.select(fin, new, old)
    return (sel(C.R.mul(X, lam2), X), sel(C.R.mul(Y, C.R.mul(lam2, lam)), Y),
            sel(C.R.mul(Z, lam), Z))


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_ring_mul_matches_jax_core(ncoord):
    C = _curve(ncoord)
    gen = torch.Generator().manual_seed(ncoord)
    a, b = (C.R.F.rand(gen, (9,) + C.R.coord_shape[:-1], "cpu") for _ in range(2))
    a[0] = 0
    want = _kring(J_FQ, ncoord).mm(_np_elem(ncoord, a), _np_elem(ncoord, b))
    _assert_core_eq(ncoord, [po.ring_mul(C.spec, ncoord, a, b)], [want])


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_ring_inv_matches_jax_fermat(ncoord):
    """ring_inv == x^(p-2) by the JAX kernel_field's square-and-multiply
    (Fq2 through the norm, as fused.py::_finv_call), and == the host
    inverse; 0 maps to 0."""
    C = _curve(ncoord)
    a = C.R.F.rand(torch.Generator().manual_seed(5 + ncoord), (3,) + C.R.coord_shape[:-1], "cpu")
    a[0] = 0
    f = kernel_field(J_FQ)

    def fermat(x):
        acc = x
        for bit in bin(J_FQ.p - 2)[3:]:
            acc = f.sqr(acc)
            if bit == "1":
                acc = f.mm(acc, x)
        return acc

    x = _np_elem(ncoord, a)
    if ncoord == 1:
        want = fermat(x)
    else:
        ninv = fermat(f.add(f.sqr(x[0]), f.sqr(x[1])))
        want = (f.mm(x[0], ninv), f.neg(f.mm(x[1], ninv)))
    got = po.ring_inv(C.spec, ncoord, a)
    _assert_core_eq(ncoord, [got], [want])
    K = JREF[ncoord].K
    vals = C.R.decode(a).reshape(3, -1)
    inv = C.R.decode(got).reshape(3, -1)
    for v, w in zip(vals[1:], inv[1:]):
        v, w = (int(v[0]), int(w[0])) if ncoord == 1 else (tuple(v), tuple(w))
        assert K.mul(v, w) == (1 if ncoord == 1 else (1, 0))


def _affine_cases(C, n, seed):
    """Affine P, Q (x, y) with flags: P == Q, P == -Q, P, Q or both at
    infinity in lanes 0..4."""
    rng = random.Random(seed)
    pool = [C.ref.rand(rng) for _ in range(5)]
    P = [pool[i % 5] for i in range(n)]
    Q = [pool[(2 * i + 1) % 5] for i in range(n)]
    Q[0] = P[0]
    Q[1] = C.ref.neg(P[1])
    infP = torch.zeros(n, dtype=torch.bool)
    infQ = torch.zeros(n, dtype=torch.bool)
    infP[2] = infQ[3] = True
    infP[4] = infQ[4] = True
    return C.encode(P, device="cpu")[:2], C.encode(Q, device="cpu")[:2], infP, infQ


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_point_aadd_matches_jax_core(ncoord):
    C = _curve(ncoord)
    P, Q, infP, infQ = _affine_cases(C, 8, seed=20 + ncoord)
    want = _aadd_core(_kring(J_FQ, ncoord), *(_np_elem(ncoord, c) for c in (*P, *Q)),
                      infP.numpy(), infQ.numpy())
    _assert_core_eq(ncoord, po.point_aadd(C.spec, ncoord, P, Q, infP, infQ), want)


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_point_madd_if_matches_jax_core(ncoord):
    """Jacobian acc (random Z) + affine node: acc == node as points,
    acc == -node, acc at infinity, with cond 0 and 1 on each."""
    C = _curve(ncoord)
    rng = random.Random(30 + ncoord)
    pool = [C.ref.rand(rng) for _ in range(5)]
    acc = [pool[i % 5] for i in range(10)]
    node = [pool[(3 * i + 2) % 5] for i in range(10)]
    for i in (0, 5):
        node[i] = acc[i]
        node[i + 1] = C.ref.neg(acc[i + 1])
        acc[i + 2] = None
    A = _rescaled(C, acc, 31)
    N = C.encode(node, device="cpu")[:2]
    cond = torch.tensor([i < 5 for i in range(10)]) ^ torch.tensor([i % 4 == 3 for i in range(10)])
    core = _madd_core(_kring(J_FQ, ncoord), *(_np_elem(ncoord, c) for c in (*A, *N)))
    c = cond.numpy().reshape((-1,) + (1,) * ncoord)
    want = [np.where(c, _back(ncoord, o), convert.to_numpy(a)) for o, a in zip(core, A)]
    got = po.point_madd_if(C.spec, ncoord, A, N, cond)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_numpy(g), w)


def test_sort_u32_plain_matches_jnp_sort():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 32, size=(3, 512), dtype=np.uint64).astype(np.uint32)
    keys[:, :40] |= np.uint32(1 << 31)
    keys[1, 100:110] = keys[1, 0]  # repeats
    got = sort_u32(torch.from_numpy(keys.view(np.int32)))
    want = np.asarray(jnp.sort(jnp.asarray(keys), axis=-1))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(sort_u32_plain(torch.from_numpy(keys.view(np.int32))), got)
    with pytest.raises(ValueError):
        sort_u32(torch.zeros(3, 6, dtype=torch.int32))


def _msm_case(C, G, m, seed):
    """m points d_i G with known discrete logs d_i (made by host adds), and
    scalars: duplicate points with equal scalars, P and -P with equal
    scalars, points at infinity, zero scalars.  Returns (P, s, want)."""
    rng = random.Random(seed)
    a, b = rng.randrange(1, G.order), rng.randrange(1, G.order)
    B = G.mul(G.gen, b)
    pts, dl = [G.mul(G.gen, a)], [a]
    for _ in range(m - 1):
        pts.append(G.add(pts[-1], B))
        dl.append((dl[-1] + b) % G.order)
    ks = [rng.randrange(G.order) for _ in range(m)]
    for i in range(0, m - 8, 37):
        pts[i + 1], dl[i + 1], ks[i + 1] = pts[i], dl[i], ks[i]
        pts[i + 3], dl[i + 3], ks[i + 3] = G.neg(pts[i + 2]), -dl[i + 2], ks[i + 2]
        pts[i + 4], dl[i + 4] = None, 0
        ks[i + 5] = 0
    want = G.mul(G.gen, sum(d * k for d, k in zip(dl, ks)) % G.order)
    return _rescaled(C, pts, seed), C.fr.encode(ks, device="cpu"), want


@pytest.mark.parametrize("ncoord", [1, 2], ids=["g1", "g2"])
def test_msm_best_matches_host_oracle(ncoord):
    """m = 256, in G1 through JCurve.msm's m >= 256 dispatch."""
    C, G = _curve(ncoord), JREF[ncoord]
    P, s, want = _msm_case(C, G, 256, seed=40 + ncoord)
    got = C.msm(P, s) if ncoord == 1 else pippenger.msm_best(C, P, s)
    assert C.decode(got) == [want]


def test_msm_best_pads_and_chunks(monkeypatch):
    """A non-power-of-two m (24, padded to 32 with infinity and zero
    scalars) whose point axis is cut into two chunks of 16, against the
    host oracle and JCurve.msm's branch below 256, scalar_mul_w4 + sum."""
    C, G = curve_g1(), JREF[1]
    P, s, want = _msm_case(C, G, 24, seed=60)
    assert C.decode(C.msm(P, s)) == [want]
    monkeypatch.setattr(pippenger, "MAX_SLOT_BYTES", 32 * 16 * 3 * C.spec.nlimbs * 4)
    assert C.decode(pippenger.msm_best(C, P, s)) == [want]


def test_d_msm_pippenger_matches_host_msm():
    """dmsm_test.rs with 256 chunks per party (m = 512, l = 2, n = 8), so
    each party's local MSM takes the Pippenger branch, all 8 in one batch.
    The bases repeat 16 packed chunks (fixed-base muls of 16 x 8 shares)."""
    pp = pss(BN254_FR, 2)
    C, F = curve_g1(), pp.F
    m, distinct = 512, 16
    rng = np.random.default_rng(70)
    dl = [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(distinct * pp.l)]
    scal = [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(m)]
    k = split(generator(71), 2)
    nch = m // pp.l
    base_sh = pp.det_pack(F.encode(dl, "cpu").reshape(distinct, pp.l, F.k))  # (16, n, K)
    tile = torch.arange(nch) % distinct
    bases = tuple(c.transpose(0, 1)[:, tile] for c in fixed_base_mul(C, base_sh))  # (n, nch)
    fsh = pp.pack(F.encode(scal, "cpu").reshape(nch, pp.l, F.k), pp.rand_pads(k[0], (nch,), "cpu"))
    out = d_msm(pp, C, bases, fsh.transpose(0, 1), MsmMask.sample(pp, C, k[1], "cpu"),
                LocalNet(pp.n))
    shares = C.decode(out)  # unpack2 on the host: the port's matrix, oracle points
    got = [None] * pp.l
    for i, row in enumerate(pp.M_unpack2):
        for coef, sh in zip(row, shares):
            got[i] = C.ref.add(got[i], C.ref.mul(sh, coef))
    total = sum(dl[i % (distinct * pp.l)] * scal[i] for i in range(m)) % C.order
    assert got == [C.ref.mul(C.ref.gen, total)] * pp.l
