"""Extended-witness (h) computation, circom variant (groth16/src/ext_wit.rs).

Port of zksaas_tpu/groth16/ext_wit.py::circom_h (ext_wit.rs:104-181):
iffts scaled by the doubled-domain root of unity, ffts, pointwise ab - c,
one deg_red.  6 FftMasks + 1 DegRedMask.  a/b/c are stacked on a batch
axis and run as one d_ifft and one d_fft: one protocol round each, moving
all three channels' bytes, with 3x-wider kernels.  libsnark_h is a later
slice.
"""

from __future__ import annotations

import torch

from ..dist.deg_red import DegRedMask, deg_red
from ..dist.dfft import FftMask, d_fft, d_ifft
from ..ntt.domain import domain
from ..pss.pss import PackedSharingParams
from ..utils.rng import split
from .qap import PackedQAPShare


def _stack_abc(qap_share: PackedQAPShare):
    """(..., nch, K) x3 -> (..., 3, nch, K): the batch axis sits just before
    the chunk axis, so it rides through the party-axis handling unchanged."""
    return torch.stack([qap_share.a, qap_share.b, qap_share.c], dim=-3)


def _stack_masks(masks) -> FftMask:
    return FftMask(
        in_mask=torch.stack([m.in_mask for m in masks], dim=-3),
        out_mask=torch.stack([m.out_mask for m in masks], dim=-3),
    )


def circom_h(pp: PackedSharingParams, qap_share: PackedQAPShare, fft_masks,
             degred_mask: DegRedMask, net, rng):
    F = pp.F
    dom = qap_share.dom
    root2m = pp.spec.root_of_unity(2 * dom.n)
    ks = split(rng, 3)
    abc = _stack_abc(qap_share)
    abc = d_ifft(pp, abc, _stack_masks(fft_masks[0:3]), True, dom, root2m, net, ks[0], 0)
    abc = d_fft(pp, abc, _stack_masks(fft_masks[3:6]), False, dom, net, ks[1], 0)
    a, b, c = abc.unbind(-3)
    h_eval = F.sub(F.mul(a, b), c)
    return deg_red(pp, h_eval, degred_mask, net, ks[2], 0)


def circom_masks(pp: PackedSharingParams, m: int, rng, device="cuda"):
    """The 6 FftMasks + DegRedMask for circom_h (sha256.rs:226-282)."""
    dom = domain(pp.spec, m)
    root2m = pp.spec.root_of_unity(2 * m)
    ks = split(rng, 7)
    fft_masks = [
        FftMask.sample(True, root2m, dom.group_gen_inv, m, pp, ks[i], device) for i in range(3)
    ] + [FftMask.sample(False, 1, dom.group_gen, m, pp, ks[3 + i], device) for i in range(3)]
    degred_mask = DegRedMask.sample(pp, m // pp.l, ks[6], device)
    return fft_masks, degred_mask
