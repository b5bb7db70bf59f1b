"""QAP construction + packed sharing (reference groth16/src/qap.rs).

Port of zksaas_tpu/groth16/qap.py.  qap_evals (groth16/local.py) mirrors
qap() at qap.rs:42-89; qap_pack mirrors QAP::pss (qap.rs:91-135):
bit-reverse-rearrange each vector, then stride-interleaved chunks packed so
the first d_ifft of the extended witness needs no permutation round.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circom.r1cs import R1CS
from ..device import resolve_device
from ..ntt.domain import Radix2Domain, domain
from ..pss.pss import PackedSharingParams
from ..utils.pack import rearrange_perm, stride_chunks
from ..utils.rng import split
from .local import qap_evals


@dataclass
class PackedQAPShare:
    """Party-major packed QAP shares: a, b, c are (n, m/l, K)."""

    num_inputs: int
    num_constraints: int
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    dom: Radix2Domain

    def party(self, i):
        return PackedQAPShare(self.num_inputs, self.num_constraints, self.a[i], self.b[i],
                              self.c[i], self.dom)


def qap_pack(pp: PackedSharingParams, r1cs: R1CS, z: list[int], rng, device="cuda"):
    """Dealer-side packing of the QAP vectors (qap.rs:91-135)."""
    dev = resolve_device(device)
    a, b, c, m = qap_evals(r1cs, z)
    F = pp.F
    perm = torch.from_numpy(rearrange_perm(m)).to(dev)
    out = []
    for vec, g in zip((a, b, c), split(rng, 3)):
        x = F.encode(vec, dev).index_select(0, perm)
        chunks = stride_chunks(x, pp.l)  # (m/l, l, K)
        shares = pp.pack(chunks, pp.rand_pads(g, (m // pp.l,), dev))
        out.append(shares.transpose(0, 1).contiguous())  # (n, m/l, K)
    return PackedQAPShare(
        num_inputs=r1cs.num_instance,
        num_constraints=r1cs.num_constraints,
        a=out[0],
        b=out[1],
        c=out[2],
        dom=domain(pp.spec, m),
    )
