"""The port's slice over BLS12-381 as a whole, on the CPU: dealer, d_prove
over LocalNet(8), dealer unpack, pairing check.

The JAX function for the whole slice is the JAX package's host Groth16
prover zksaas_tpu/groth16/local.py::local_prove over BLS12-381 Fr: for the
same CRS (the same setup seed), witness, r and s, the unpacked distributed
proof equals it whatever the masks and pads, and passes the JAX package's
BLS12-381 pairing check.  The circuit is examples/e2e_small.py's, built over
BLS12-381 Fr as that example does with its curve knob.  Everything on the
port's side runs through the 24-limb plain versions of the point kernels,
BLS12-381 G2 included.  Tolerance: exact equality of affine points.
"""

import random

import torch

from zksaas_tpu.circom import ConstraintBuilder as JConstraintBuilder
from zksaas_tpu.fields import BLS12_381_FR as J_FR
from zksaas_tpu.groth16 import local as jlocal
from zksaas_tpu_torch.circom.r1cs import ConstraintBuilder
from zksaas_tpu_torch.comm.net import LocalNet
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.fields.spec import BLS12_381_FR
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

torch.set_num_threads(1)
DEV = "cpu"


def _circuit(builder_cls, spec):
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


def test_bls12_381_distributed_prove_equals_local_prove():
    jr1cs, jz = _circuit(JConstraintBuilder, J_FR)
    rng = random.Random(381)
    keys = jlocal.setup(jr1cs, rng, reduction="circom")
    r, s = rng.randrange(J_FR.p), rng.randrange(J_FR.p)
    want = jlocal.local_prove(keys, jr1cs, jz, r, s)

    r1cs, z = _circuit(ConstraintBuilder, BLS12_381_FR)
    ss = setup_scalars(r1cs, random.Random(381), reduction="circom")
    vk = vk_from_scalars(ss)
    assert vk.delta_g2 == keys.delta_g2  # the same CRS from the same seed
    pp = pss(BLS12_381_FR, 2)
    g1, g2 = curve_g1("bls12_381"), curve_g2("bls12_381")
    assert (g1.spec.nlimbs, g2.R.coord_shape) == (24, (2, 24))
    crs = pack_proving_key_device(ss, vk, pp, g1, g2, device=DEV)
    ks = split(generator(381), 7)
    qap_share = qap_pack(pp, r1cs, z, ks[0], DEV)
    a_share = pack_witness(pp, z[1:], ks[1], DEV)
    ax_share = pack_witness(pp, z[r1cs.num_instance :], ks[2], DEV)
    r_share = pack_scalar_repeated(pp, r, ks[3], DEV)
    s_share = pack_scalar_repeated(pp, s, ks[4], DEV)
    masks = ProveMasks.sample(pp, g1, g2, qap_share.dom.n, ks[5], DEV)
    net = LocalNet(pp.n)
    pi_a, pi_b2, pi_c = d_prove(pp, g1, g2, crs, qap_share, a_share, ax_share, r_share,
                                s_share, masks, net, ks[6])
    assert net.rounds == 8
    ac = pp.unpack2_g(g1, tuple(torch.stack([a, c]) for a, c in zip(pi_a, pi_c)))
    a, c = (g1.decode(tuple(x[i, :1] for x in ac))[0] for i in range(2))
    b = g2.decode(tuple(x[:1] for x in pp.unpack2_g(g2, pi_b2)))[0]
    assert (a, b, c) == (want.a, want.b, want.c)
    assert jlocal.verify(keys, jz[1 : jr1cs.num_instance], jlocal.Proof(a=a, b=b, c=c))
