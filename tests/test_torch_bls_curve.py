"""BLS12-381 and BLS12-377 above the kernels, on the CPU.

* curve_g1 / curve_g2 of both BLS12 curves: msm_best (bucket Pippenger) at
  256 points, with duplicate points, P and -P, points at infinity and zero
  scalars, and the binary scalar_mul, held as affine points against the JAX
  package's host oracle zksaas_tpu/curves/ref.py;
* the SHA-256 circuit over BLS12-381 Fr is satisfied and gives hashlib's
  digest;
* the JAX package's BLS12-381 Fr dealer outputs (qap_pack, circom_masks)
  carried through convert.py drive the port's extended-witness round, whose
  unpacked h equals the JAX host oracle's witness_map.

No JAX curve graph is compiled (the JAX side is host big-int code and the
Fr field graphs of qap_pack and circom_masks).  Tolerance: exact equality.
"""

import hashlib
import random

import jax
import numpy as np
import pytest
import torch

from zksaas_tpu.circom import ConstraintBuilder as JConstraintBuilder
from zksaas_tpu.curves import ref as jref
from zksaas_tpu.fields import BLS12_381_FR as J_FR
from zksaas_tpu.groth16 import local as jlocal
from zksaas_tpu.groth16.ext_wit import circom_masks as j_circom_masks
from zksaas_tpu.groth16.qap import qap_pack as j_qap_pack
from zksaas_tpu.pss import pss as jpss
from zksaas_tpu_torch import convert
from zksaas_tpu_torch.circom.sha256 import sha256_two_inputs
from zksaas_tpu_torch.comm.net import LocalNet
from zksaas_tpu_torch.curves import pippenger
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.fields.spec import BLS12_381_FR
from zksaas_tpu_torch.groth16.ext_wit import circom_h
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _oracle(fam, ncoord):
    return jref.CURVES[f"{fam}_g{ncoord}"]


def _curve(fam, ncoord):
    return curve_g1(fam) if ncoord == 1 else curve_g2(fam)


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


@pytest.mark.parametrize("fam,ncoord", [("bls12_381", 1), ("bls12_377", 2)],
                         ids=["bls12_381-g1", "bls12_377-g2"])
def test_msm_best_matches_host_oracle(fam, ncoord):
    """256 points d_i G with known discrete logs (host adds); duplicates with
    equal scalars, P and -P with equal scalars, infinity, zero scalars.  G1
    through JCurve.msm's m >= 256 dispatch; G2 over BLS12-377's nr = -5."""
    C, G = _curve(fam, ncoord), _oracle(fam, ncoord)
    rng = random.Random(40 + ncoord)
    a, b = rng.randrange(1, G.order), rng.randrange(1, G.order)
    B = G.mul(G.gen, b)
    pts, dl = [G.mul(G.gen, a)], [a]
    for _ in range(255):
        pts.append(G.add(pts[-1], B))
        dl.append((dl[-1] + b) % G.order)
    ks = [rng.randrange(G.order) for _ in range(256)]
    for i in range(0, 248, 37):
        pts[i + 1], dl[i + 1], ks[i + 1] = pts[i], dl[i], ks[i]
        pts[i + 3], dl[i + 3], ks[i + 3] = G.neg(pts[i + 2]), -dl[i + 2], ks[i + 2]
        pts[i + 4], dl[i + 4] = None, 0
        ks[i + 5] = 0
    want = G.mul(G.gen, sum(d * k for d, k in zip(dl, ks)) % G.order)
    P, s = _jac(C, pts, 41), C.fr.encode(ks, device="cpu")
    got = C.msm(P, s) if ncoord == 1 else pippenger.msm_best(C, P, s)
    assert C.decode(got) == [want]


@pytest.mark.parametrize("fam,ncoord", [("bls12_381", 2), ("bls12_377", 1)],
                         ids=["bls12_381-g2", "bls12_377-g1"])
def test_scalar_mul_matches_host_oracle(fam, ncoord):
    """Binary scalar_mul over 24 points: random scalars, 0, 1, r - 1, and a
    point at infinity; the two groups msm_best's cases leave out."""
    C, G = _curve(fam, ncoord), _oracle(fam, ncoord)
    rng = random.Random(50 + ncoord)
    pts = [G.rand(rng) for _ in range(24)]
    pts[5] = None
    ks = [rng.randrange(G.order) for _ in range(24)]
    ks[:3] = [0, 1, G.order - 1]
    got = C.decode(C.scalar_mul(_jac(C, pts, 51), C.fr.encode(ks, device="cpu")))
    assert got == [G.mul(p, k) if p is not None else None for p, k in zip(pts, ks)]


def test_sha256_circuit_over_bls12_381_fr():
    a, b = 1, 2
    r1cs, z, digest = sha256_two_inputs(a, b, BLS12_381_FR)
    assert r1cs.spec is BLS12_381_FR
    assert digest == hashlib.sha256(a.to_bytes(27, "big") + b.to_bytes(27, "big")).digest()
    assert r1cs.num_constraints == 51454
    assert r1cs.is_satisfied(z)
    d = int.from_bytes(digest, "big")
    assert z[1 : r1cs.num_instance] == [d >> 128, d & ((1 << 128) - 1)]


def _small_circuit(builder_cls, spec):
    """examples/e2e_small.py:63-71: x -> x^(2^10), one public output."""
    cb = builder_cls(spec)
    x = cb.witness(3)
    val = 3
    for _ in range(10):
        x = cb.mul(x, x)
        val = val * val % spec.p
    out = cb.pub_input(val)
    cb.constrain([(1, x)], [(1, 0)], [(1, out)])
    return cb.finalize()


def test_jax_bls12_381_dealer_outputs_through_convert():
    """A JAX BLS12-381 Fr qap_pack share and circom_masks, converted with the
    spec, drive the port's circom_h; the unpacked h equals witness_map.  A
    share of the wrong width is refused."""
    jr1cs, jz = _small_circuit(JConstraintBuilder, J_FR)
    jpp, pp = jpss(J_FR, 2), pss(BLS12_381_FR, 2)
    ks = jax.random.split(jax.random.PRNGKey(8), 2)
    jq = j_qap_pack(jpp, jr1cs, jz, ks[0])
    jfft, jdeg = j_circom_masks(jpp, jq.dom.n, ks[1])
    q = convert.qap_from(jq, BLS12_381_FR)
    fft = [convert.fft_mask_from(m, BLS12_381_FR) for m in jfft]
    deg = convert.degred_mask_from(jdeg, BLS12_381_FR)
    net = LocalNet(pp.n)
    h_share = circom_h(pp, q, fft, deg, net, generator(6))
    h = pp.unpack(h_share.transpose(0, 1)).reshape(-1, pp.F.k)
    assert list(pp.F.decode(h)) == jlocal.witness_map(jr1cs, jz, "circom")
    assert net.rounds == 3
    g1_limbs = np.zeros((8, 2, 24), dtype=np.uint32)
    assert convert.points_to_torch((g1_limbs,) * 3, nlimbs=24)[0].shape == (8, 2, 24)
    with pytest.raises(ValueError):
        convert.msm_mask_from(type("M", (), {"in_mask": (g1_limbs[..., :16],) * 3,
                                             "out_mask": (g1_limbs,) * 3}), BLS12_381_FR)
