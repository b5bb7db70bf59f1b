"""Flagship: the full distributed Groth16 prove of the SHA-256 fixture.

Port of examples/sha256_e2e.py (the analog of groth16/examples/sha256.rs).
Dealer: build the 51,454-constraint SHA-256 circuit, derive the CRS
scalars and the verifying key on the host, generate and det-pack the CRS
on the device (fixed-base muls), pack the QAP, witness and masks.
Parties: the full d_prove protocol (3 d_ifft + 3 d_fft batched into one
round each, deg_red, 5 d_msm) with all 8 parties simulated on one device
over LocalNet.  Verification: unpack2 of the proof shares on the device,
then the curve's pairing check on the host (pure Python, its own phase).

Usage: python -m zksaas_tpu_torch.sha256_e2e [a] [b] [--curve bn254|bls12_381|bls12_377]
The curve (BN254 by default) sets the circuit's scalar field and the
groups.  Runs on the CUDA device (there is no CPU fallback) and prints one
JSON line with the curve, the timed prove's latency, the phase times,
each kernel's launches during that prove, in all and per field, and the
unpacked proof (affine a, b, c as integers).

With ZKSAAS_JOURNAL=<dir> set, the net is a JournalNet over that directory
(comm/journal.py) and the one timed prove runs with no warm-up: every round
is recorded, and a second run with the same directory resumes, replaying
the recorded rounds from disk (its latency is then the resume's cost, not
a fresh prove's); `detail` gives `replayed` beside `rounds`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import torch

from . import kernels
from .circom.sha256 import sha256_two_inputs
from .comm import JournalNet, LocalNet
from .curves.curve import CURVE_FAMILIES, curve_g1, curve_g2
from .device import resolve_device
from .fields.spec import FIELDS
from .groth16.local import Proof, verify
from .groth16.prove import ProveMasks, d_prove, pack_scalar_repeated, pack_witness
from .groth16.qap import qap_pack
from .groth16.setup_device import pack_proving_key_device, setup_scalars, vk_from_scalars
from .pss.pss import pss
from .utils.rng import generator, split
from .utils.trace import span


def setup(a_in: int, b_in: int, dev, times: dict, curve: str = "bn254"):
    """Everything before the prove: the circuit over the curve's scalar
    field, the CRS scalars and vk on the host, the CRS shares on the
    device, and the dealer's packed QAP, witness, r/s and masks.  Returns
    (r1cs, z, vk, args), where d_prove(*args, rng) runs the distributed
    prove."""
    g1, g2 = curve_g1(curve), curve_g2(curve)
    with span("circuit", times):
        r1cs, z, _digest = sha256_two_inputs(a_in, b_in, FIELDS[f"{curve}_fr"])
    rng = random.Random(2024)
    with span("setup_scalars", times):
        ss = setup_scalars(r1cs, rng, reduction="circom")
        vk = vk_from_scalars(ss)
    pp = pss(r1cs.spec, 2)
    with span("device_crs", times):
        crs = pack_proving_key_device(ss, vk, pp, g1, g2, dev)
    ks = split(generator(9), 7)
    with span("dealer", times):
        qap_share = qap_pack(pp, r1cs, z, ks[0], dev)
        a_share = pack_witness(pp, z[1:], ks[1], dev)
        ax_share = pack_witness(pp, z[r1cs.num_instance :], ks[2], dev)
        r = rng.randrange(r1cs.spec.p)
        s = rng.randrange(r1cs.spec.p)
        r_share = pack_scalar_repeated(pp, r, ks[3], dev)
        s_share = pack_scalar_repeated(pp, s, ks[4], dev)
        masks = ProveMasks.sample(pp, g1, g2, ss.m, ks[5], dev)
    args = (pp, g1, g2, crs, qap_share, a_share, ax_share, r_share, s_share, masks,
            LocalNet(pp.n))
    return r1cs, z, vk, args


def main(a_in: int = 1, b_in: int = 2, device="cuda", curve: str = "bn254",
         dealt: dict | None = None) -> dict:
    """The flagship's JSON result.  `dealt`, when given, receives the
    dealer's state (r1cs, z, vk and d_prove's arguments up to the net,
    `args`), so a caller can prove the same keys over another net."""
    dev = resolve_device(device)
    times: dict = {}
    t_all = time.perf_counter()
    r1cs, z, vk, args = setup(a_in, b_in, dev, times, curve)
    pp, g1, g2, qap_share, net = args[0], args[1], args[2], args[4], args[-1]
    if dealt is not None:
        dealt.update(r1cs=r1cs, z=z, vk=vk, args=args[:-1])
    journal = os.environ.get("ZKSAAS_JOURNAL")
    if journal:
        net = JournalNet(net, journal)
        args = args[:-1] + (net,)
    else:
        with span("prove_warmup", times):  # first calls build tables and caches
            d_prove(*args, generator(10))
    before = kernels.save_launches()
    rounds_before = net.rounds
    prove_phases: dict = {}
    with span("prove", times):
        pi = d_prove(*args, generator(10), times=prove_phases)
    launches = {k.name: k.launches - b[0] for k, b in zip(kernels.KERNELS, before)}
    by_field = {k.name: {f: n - b[1].get(f, 0) for f, n in k.by_field.items()
                         if n - b[1].get(f, 0)}
                for k, b in zip(kernels.KERNELS, before)}
    with span("unpack2", times):
        a = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, pi[0])))[0]
        b = g2.decode(tuple(c[:1] for c in pp.unpack2_g(g2, pi[1])))[0]
        c = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, pi[2])))[0]
    with span("verify", times):  # the pairing check, pure Python on the host
        ok = verify(vk, z[1 : r1cs.num_instance], Proof(a=a, b=b, c=c))
    return {
        "metric": "sha256_distributed_prove_latency_s",
        "value": times["prove"],
        "unit": "s",
        "verified": bool(ok),
        "detail": {
            "curve": curve,
            "constraints": r1cs.num_constraints,
            "domain": qap_share.dom.n,
            "parties": pp.n,
            "phases_s": times,
            "prove_phases_s": prove_phases,
            "launches": launches,
            "launches_by_field": by_field,
            "rounds": net.rounds - rounds_before,
            **({"replayed": net.replayed} if journal else {}),
            "total_wall_s": time.perf_counter() - t_all,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "proof": {"a": a, "b": b, "c": c},
        },
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", nargs="?", type=int, default=1)
    ap.add_argument("b", nargs="?", type=int, default=2)
    ap.add_argument("--curve", default="bn254", choices=CURVE_FAMILIES)
    opt = ap.parse_args()
    res = main(opt.a, opt.b, curve=opt.curve)
    print(json.dumps(res))
    if not res["verified"]:
        sys.exit("distributed SHA-256 proof failed verification")
