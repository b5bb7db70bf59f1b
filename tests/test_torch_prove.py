"""The port's slice as a whole: dealer, d_prove over LocalNet(8), dealer
unpack, pairing check, on the CPU.

The JAX function for the whole slice is the JAX package's host Groth16
prover zksaas_tpu/groth16/local.py::local_prove: for the same CRS, witness,
r and s, the unpacked distributed proof equals it whatever the masks and
pads (the JAX d_prove itself only runs as the slow subprocess test
tests/test_e2e_prove.py).  The circuit is examples/e2e_small.py's.  A second
case feeds the JAX dealer's packed QAP and masks through convert.py into the
port's extended-witness round, and carries the port's CRS and masks through
the JAX package's dataclasses and back.  (The JAX dealer's CRS needs its
curve graphs, whose XLA:CPU compile takes minutes, so it is not made here.)
Tolerance: exact equality of affine points and field values.
"""

import random

import jax
import numpy as np
import pytest
import torch

from zksaas_tpu.circom import ConstraintBuilder as JConstraintBuilder
from zksaas_tpu.curves import curve_g1 as j_curve_g1
from zksaas_tpu.curves import curve_g2 as j_curve_g2
from zksaas_tpu.dist.deg_red import DegRedMask as JDegRedMask
from zksaas_tpu.dist.dfft import FftMask as JFftMask
from zksaas_tpu.dist.dmsm import MsmMask as JMsmMask
from zksaas_tpu.fields import BN254_FR as J_FR
from zksaas_tpu.groth16 import local as jlocal
from zksaas_tpu.groth16.ext_wit import circom_masks as j_circom_masks
from zksaas_tpu.groth16.prove import ProveMasks as JProveMasks
from zksaas_tpu.groth16.proving_key import PackedProvingKeyShare as JPackedProvingKeyShare
from zksaas_tpu.groth16.qap import qap_pack as j_qap_pack
from zksaas_tpu.pss import pss as jpss
from zksaas_tpu_torch import convert
from zksaas_tpu_torch.circom.r1cs import ConstraintBuilder
from zksaas_tpu_torch.comm.net import LocalNet
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.groth16.ext_wit import circom_h
from zksaas_tpu_torch.groth16.local import Proof, verify
from zksaas_tpu_torch.groth16.prove import (
    ProveMasks,
    d_prove,
    pack_scalar_repeated,
    pack_witness,
)
from zksaas_tpu_torch.groth16.qap import qap_pack
from zksaas_tpu_torch.groth16.setup_device import (
    pack_proving_key_device,
    setup_scalars,
    vk_from_scalars,
)
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator, split

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)
DEV = "cpu"


def _circuit(builder_cls, spec):
    """examples/e2e_small.py:63-71: x -> x^(2^10), one public output."""
    cb = builder_cls(spec)
    x = cb.witness(3)
    val = 3
    for _ in range(10):
        x = cb.mul(x, x)
        val = val * val % cb.spec.p
    out = cb.pub_input(val)
    cb.constrain([(1, x)], [(1, 0)], [(1, out)])
    return cb.finalize()


@pytest.fixture(scope="module")
def case():
    """The JAX package's host oracle: keys, r, s and the local proof."""
    jr1cs, jz = _circuit(JConstraintBuilder, J_FR)
    rng = random.Random(123)
    keys = jlocal.setup(jr1cs, rng, reduction="circom")
    r, s = rng.randrange(J_FR.p), rng.randrange(J_FR.p)
    expected = jlocal.local_prove(keys, jr1cs, jz, r, s)
    r1cs, z = _circuit(ConstraintBuilder, BN254_FR)
    ss = setup_scalars(r1cs, random.Random(123), reduction="circom")
    return dict(jr1cs=jr1cs, jz=jz, keys=keys, r=r, s=s, expected=expected,
                r1cs=r1cs, z=z, ss=ss, vk=vk_from_scalars(ss))


def test_distributed_prove_equals_local_prove(case):
    r1cs, z, ss, vk = case["r1cs"], case["z"], case["ss"], case["vk"]
    assert vk.delta_g1 == case["keys"].delta_g1  # same CRS from the same seed
    pp = pss(BN254_FR, 2)
    g1, g2 = curve_g1(), curve_g2()
    crs = pack_proving_key_device(ss, vk, pp, g1, g2, device=DEV)
    ks = split(generator(777), 7)
    qap_share = qap_pack(pp, r1cs, z, ks[0], DEV)
    a_share = pack_witness(pp, z[1:], ks[1], DEV)
    ax_share = pack_witness(pp, z[r1cs.num_instance :], ks[2], DEV)
    r_share = pack_scalar_repeated(pp, case["r"], ks[3], DEV)
    s_share = pack_scalar_repeated(pp, case["s"], ks[4], DEV)
    masks = ProveMasks.sample(pp, g1, g2, qap_share.dom.n, ks[5], DEV)
    net = LocalNet(pp.n)
    times = {}
    pi_a, pi_b2, pi_c = d_prove(pp, g1, g2, crs, qap_share, a_share, ax_share, r_share,
                                s_share, masks, net, ks[6], times)
    assert set(times) == {"prove.ext_wit", "prove.A", "prove.B_g1", "prove.B_g2", "prove.C"}
    # dealer: unpack2 (pi_a and pi_c batched as one G1 point mat-vec)
    ac = pp.unpack2_g(g1, tuple(torch.stack([a, c]) for a, c in zip(pi_a, pi_c)))
    a, c = (g1.decode(tuple(x[i, :1] for x in ac))[0] for i in range(2))
    b = g2.decode(tuple(x[:1] for x in pp.unpack2_g(g2, pi_b2)))[0]
    want = case["expected"]
    assert (a, b, c) == (want.a, want.b, want.c)
    assert verify(vk, z[1 : r1cs.num_instance], Proof(a=a, b=b, c=c))
    assert jlocal.verify(case["keys"], case["jz"][1 : r1cs.num_instance],
                         jlocal.Proof(a=a, b=b, c=c))


def test_jax_dealer_outputs_through_convert(case):
    """The JAX dealer's packed QAP and circom_h masks, converted, drive the
    port's extended-witness round; its unpacked h equals the JAX oracle's
    witness_map.  CRS and ProveMasks survive the trip through the JAX
    dataclasses bit for bit."""
    jpp, pp = jpss(J_FR, 2), pss(BN254_FR, 2)
    jr1cs, jz = case["jr1cs"], case["jz"]
    ks = jax.random.split(jax.random.PRNGKey(5), 2)
    jq = j_qap_pack(jpp, jr1cs, jz, ks[0])
    jfft, jdeg = j_circom_masks(jpp, jq.dom.n, ks[1])
    jmasks = JProveMasks(jfft, jdeg, [JMsmMask.zero(jpp, j_curve_g1())] * 4,
                         JMsmMask.zero(jpp, j_curve_g2()))
    masks = convert.prove_masks_from(jmasks, BN254_FR, DEV)
    np.testing.assert_array_equal(convert.to_numpy(masks.fft_masks[4].out_mask),
                                  np.asarray(jfft[4].out_mask))
    back = convert.prove_masks_to_numpy(masks)
    assert isinstance(JFftMask(**back["fft_masks"][0]), JFftMask)
    assert isinstance(JDegRedMask(**back["degred_mask"]), JDegRedMask)
    np.testing.assert_array_equal(back["g2_msm_mask"]["in_mask"][2],
                                  np.asarray(jmasks.g2_msm_mask.in_mask[2]))

    q = convert.qap_from(jq, BN254_FR, DEV)
    net = LocalNet(pp.n)
    h_share = circom_h(pp, q, masks.fft_masks, masks.degred_mask, net, generator(6))
    h = pp.unpack(h_share.transpose(0, 1)).reshape(-1, pp.F.k)
    assert list(pp.F.decode(h)) == jlocal.witness_map(jr1cs, jz, "circom")
    assert net.rounds == 3

    ss, vk = case["ss"], case["vk"]
    crs = pack_proving_key_device(ss, vk, pp, curve_g1(), curve_g2(), device=DEV)
    jcrs = JPackedProvingKeyShare(**convert.crs_to_numpy(crs))
    crs2 = convert.crs_from(jcrs, BN254_FR, DEV)
    for name in ("s", "u", "w", "h", "v"):
        for x, y in zip(getattr(crs, name), getattr(crs2, name)):
            assert torch.equal(x, y)
    assert crs2.beta_g2 == vk.beta_g2
