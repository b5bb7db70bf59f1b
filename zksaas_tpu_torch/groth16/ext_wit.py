"""Extended-witness (h) computation (groth16/src/ext_wit.rs).

Port of zksaas_tpu/groth16/ext_wit.py, both variants:

* libsnark_h (ext_wit.rs:14-102): 3 coset d_iffts || 3 coset d_ffts,
  pointwise (ab - c) Z^-1, then a coset d_ifft back to coefficients.
  7 FftMasks.
* circom_h (ext_wit.rs:104-181): iffts scaled by the doubled-domain root
  of unity, ffts, pointwise ab - c, one deg_red.  6 FftMasks + 1
  DegRedMask.  d_prove runs this one.

a/b/c are stacked on a batch axis and run as one d_ifft and one d_fft: one
protocol round each, moving all three channels' bytes, with 3x-wider
kernels.
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


def libsnark_h(pp: PackedSharingParams, qap_share: PackedQAPShare, fft_masks, net, rng):
    """fft_masks: the 7 FftMasks of libsnark_masks.  Returns packed shares
    of h's m coefficients (the last one 0: (ab - c) / Z has degree m - 2)."""
    F = pp.F
    dom = qap_share.dom
    g = pp.spec.generator  # the coset offset
    g_inv = pow(g, -1, pp.spec.p)
    ks = split(rng, 3)
    abc = _stack_abc(qap_share)
    abc = d_ifft(pp, abc, _stack_masks(fft_masks[0:3]), True, dom, g, net, ks[0], 0)
    abc = d_fft(pp, abc, _stack_masks(fft_masks[3:6]), True, dom, net, ks[1], 0)
    z_inv = pow(dom.evaluate_vanishing_polynomial(g), -1, pp.spec.p)
    a, b, c = abc.unbind(-3)
    h_eval = F.muli(F.sub(F.mul(a, b), c), z_inv)
    # the coset ifft back to coefficients
    return d_ifft(pp, h_eval, fft_masks[6], False, dom, g_inv, net, ks[2], 0)


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


def libsnark_masks(pp: PackedSharingParams, m: int, rng, device="cuda"):
    """The 7 FftMasks for libsnark_h (ext_wit.rs:20)."""
    dom = domain(pp.spec, m)
    coset = dom.get_coset(pp.spec.generator)
    ks = split(rng, 7)
    masks = [FftMask.sample(True, coset.offset, dom.group_gen_inv, m, pp, ks[i], device)
             for i in range(3)]
    masks += [FftMask.sample(True, 1, coset.group_gen, m, pp, ks[3 + i], device)
              for i in range(3)]
    masks.append(FftMask.sample(False, coset.offset_inv, dom.group_gen_inv, m, pp, ks[6], device))
    return masks
