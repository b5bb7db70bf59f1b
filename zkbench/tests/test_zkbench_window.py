"""The window's proofs on the CPU at a tiny circuit: each draws fresh r, s
and masks, and the reference accepts what the program proves and refuses
it with one coordinate changed."""

import random

import pytest

from conftest import TINY_CONFIG
from zkbench import crs as crs_mod
from zkbench import harness
from zkbench.circuits import square_chain
from zkbench.reference.fields import BN254_FR
from zkbench.reference.groth16 import Statement, groups, verify


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    import torch

    torch.set_num_threads(1)
    params = TINY_CONFIG["circuit"]
    inputs = square_chain.draw_inputs(params, random.Random(2**40 + 1))
    circuit = square_chain.synthesize(params, inputs, BN254_FR.p)
    crs = crs_mod.load_or_derive(BN254_FR, circuit, TINY_CONFIG,
                                 str(tmp_path_factory.mktemp("cache")))
    st = harness.set_up(TINY_CONFIG, circuit, crs, "cpu", random.Random(5))
    prng = random.Random(2**40 + 2)
    proofs = [harness.one_proof(st, prng, harness._no_annotation) for _ in range(3)]
    statement = Statement.make("bn254", crs, circuit.z,
                               square_chain.statement(params, inputs, BN254_FR.p))
    return st, statement, proofs


def test_no_two_proofs_share_r_s_or_masks(proved):
    st, statement, proofs = proved
    rs = [p["r"] for p in proofs] + [p["s"] for p in proofs]
    assert len(set(rs)) == len(rs)
    fps = [tuple(p["fingerprint"].tolist()) for p in proofs]
    assert len(set(fps)) == len(fps)
    assert harness.check(st, statement, proofs) == {"proofs_wrong": 0, "masks_reused": 0}
    assert set(proofs[0]["phases"]) == {"prove.ext_wit", "prove.A", "prove.B_g1", "prove.B_g2",
                                        "prove.C"}


def test_a_proof_that_repeats_one_block_of_another_counts_as_reusing(proved):
    """Each fingerprint is one block of one mask unit: six FFT masks' and the
    degree-reduction mask's in and out shares (8 blocks a party each) and
    five MSM masks' in and out points (one a party)."""
    import torch

    _, _, proofs = proved
    prints = torch.stack([p["fingerprint"] for p in proofs])
    assert prints.shape == (3, 14 * 8 * 8 + 10 * 8)
    assert harness.reused_masks(prints) == 0
    one = prints.clone()
    one[2, 500] = one[0, 500]
    assert harness.reused_masks(one) == 2
    one[1, -1] = one[2, -1]
    assert harness.reused_masks(one) == 3


def test_reference_accepts_the_program_proof_and_refuses_a_changed_one(proved):
    st, statement, proofs = proved
    p = proofs[-1]
    ua, ub, uc = p["unpacked"]
    got = (st.g1.decode(ua)[0], st.g2.decode(ub)[0], st.g1.decode(uc)[0])
    assert got == statement.expected_proof(p["r"], p["s"])
    assert verify("bn254", statement.crs, statement.public, got)
    G1, _ = groups("bn254")
    x, y = got[2]
    changed = (got[0], got[1], (x, (y + 1) % G1.K.p))
    assert changed != statement.expected_proof(p["r"], p["s"])
    assert not verify("bn254", statement.crs, statement.public, changed)
