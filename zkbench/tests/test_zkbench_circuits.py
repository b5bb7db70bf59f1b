"""The benchmark's inputs: the SHA-256 batch circuit and the CRS scalars."""

import hashlib
import random

from zkbench import crs
from zkbench.circuits import sha256_batch, square_chain
from zkbench.reference.fields import BLS12_381_FR, BN254_FR


def test_sha256_batch_one_instance_is_the_port_circuit():
    """k = 1 is the port's 51,454-constraint flagship circuit and witness."""
    from zksaas_tpu_torch.circom.sha256 import sha256_two_inputs
    from zksaas_tpu_torch.fields.spec import BN254_FR as PORT_FR

    a, b = 1, 2
    c = sha256_batch.synthesize({"instances": 1}, [(a, b)], BN254_FR.p)
    r1cs, z, _ = sha256_two_inputs(a, b, PORT_FR)
    assert c.num_constraints == 51454 and c.num_instance == r1cs.num_instance == 3
    assert (c.a, c.b, c.c, c.z) == (r1cs.a, r1cs.b, r1cs.c, z)


def test_sha256_batch_four_digests_equal_hashlib():
    """k = 4 over BLS12-381: every instance's public outputs are hashlib's
    digest of its inputs, and the circuit has four times the constraints."""
    params = {"instances": 4}
    inputs = sha256_batch.draw_inputs(params, random.Random(2**33 + 5))
    assert len(set(inputs)) == 4
    c = sha256_batch.synthesize(params, inputs, BLS12_381_FR.p)
    assert c.num_constraints == 4 * 51454 and c.num_instance == 9
    assert crs.domain_size(c.num_constraints + c.num_instance) == 2**18
    for i, (a, b) in enumerate(inputs):
        d = hashlib.sha256(a.to_bytes(27, "big") + b.to_bytes(27, "big")).digest()
        assert (c.public[2 * i] << 128) + c.public[2 * i + 1] == int.from_bytes(d, "big")
    assert c.public == sha256_batch.statement(params, inputs, BLS12_381_FR.p)


def test_crs_scalars_equal_the_port_setup_and_survive_the_cache(tmp_path):
    """The frozen setup_scalars gives the port's values, and the cache
    gives them back."""
    from zksaas_tpu_torch.circom.r1cs import R1CS
    from zksaas_tpu_torch.fields.spec import BN254_FR as PORT_FR
    from zksaas_tpu_torch.groth16.setup_device import setup_scalars

    params = {"squarings": 10}
    c = square_chain.synthesize(params, square_chain.draw_inputs(params, random.Random(1)),
                                BN254_FR.p)
    ours = crs.derive(BN254_FR, c, 123)
    port = setup_scalars(R1CS(PORT_FR, c.num_instance, c.num_witness, c.a, c.b, c.c),
                         random.Random(123))
    for name in ("alpha", "beta", "gamma", "delta", "m", "a_t", "b_t", "h_scalars",
                 "l_scalars", "gamma_abc"):
        assert getattr(ours, name) == getattr(port, name), name
    config = {"circuit": params | {"kind": "square_chain"}, "curve": "bn254",
              "reduction": "circom", "crs_seed": 123}
    made = crs.load_or_derive(BN254_FR, c, config, str(tmp_path))
    again = crs.load_or_derive(BN254_FR, c, config, str(tmp_path))
    assert made == ours == again
    assert len(list(tmp_path.iterdir())) == 1
