"""Distributed MSM (dist-primitives/src/dmsm/mod.rs).

Port of zksaas_tpu/dist/dmsm.py.  Each party MSMs its packed base/scalar
shares locally (the hot loop, dmsm/mod.rs:73), masks, and sends one group
element to the king; the king unpacks (dropout-aware), sums the l
unpacked secrets, and re-broadcasts the total as a repeated packed sharing
(dmsm/mod.rs:59-102).

The local stage dispatches on the chunk count alone, as the JAX package
does on the TPU (dmsm.py:26-36): bucket Pippenger (curves/pippenger.py::
msm_best, all parties in one batch) for 256 chunks or more, the windowed
scalar_mul_w4 + sum below that.  The CPU tests run the same branches as
the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.curve import JCurve
from ..curves.fixed_base import fixed_base_mul
from ..curves.pippenger import msm_best
from ..pss.pss import PackedSharingParams
from ..utils.rng import split
from ..utils.trace import span


@span("zk.dmsm.local")
def d_msm_local(curve: JCurve, bases_share, scalars_share, mask):
    """Per-party local stage: the MSM hot loop plus the input mask."""
    if scalars_share.shape[-2] >= 256:
        c_share = msm_best(curve, bases_share, scalars_share)
    else:
        c_share = curve.sum(curve.scalar_mul_w4(bases_share, scalars_share), axis=-1)
    return curve.add(c_share, mask.in_mask)


@span("zk.dmsm.reduce")
def d_msm_reduce(pp: PackedSharingParams, curve: JCurve, c_share, mask, net, channel=0):
    """Communication stage: gather to the king, unpack + sum, re-broadcast
    as a repeated packed sharing, unmask (dmsm/mod.rs:75-101)."""

    def king_fn(shares, parties):
        secrets = pp.unpack_missing_shares_g(curve, shares, parties)  # (l,)
        total = curve.sum(secrets, axis=0)
        return tuple(c.unsqueeze(0).expand((pp.n,) + c.shape) for c in total)

    result = net.round(c_share, king_fn, channel)
    return curve.add(result, mask.out_mask)


def d_msm(pp, curve: JCurve, bases_share, scalars_share, mask, net, channel=0):
    """bases_share: points with trailing chunk axis (..., m/l); scalars_share:
    (..., m/l, K).  Returns one point per party (a packed sharing of the
    MSM value, repeated l times)."""
    c_share = d_msm_local(curve, bases_share, scalars_share, mask)
    return d_msm_reduce(pp, curve, c_share, mask, net, channel)


@dataclass
class MsmMask:
    """One random group-element mask per party (dmsm/mod.rs:10-57).

    in_mask / out_mask: point tuples with leading party axis n; the out
    masks sum-correct so that unpack2(results) - masks telescopes: the out
    value is -(sum of the in-mask secrets) (dmsm/mod.rs:32-38)."""

    in_mask: tuple
    out_mask: tuple

    @staticmethod
    def sample(pp: PackedSharingParams, curve: JCurve, rng, device="cuda"):
        """The dealer draws the masks' discrete logs, so packing commutes
        with exponentiation: pack the scalars (a field mat-vec) and make
        each share with one fixed-base mul.  The shares are the same group
        elements pack_g of gen-multiples would give (zksaas_tpu's
        dmsm.py:77-94), at 64 point adds each instead of two point
        mat-vecs."""
        F = pp.F
        k_s, k_in, k_out = split(rng, 3)
        scal = F.rand(k_s, (pp.l,), device)  # dlogs of the l mask values
        in_sh = pp.pack(scal, F.rand(k_in, (pp.t,), device))  # (n, K)
        total = F.neg(F.sum(scal, axis=0))
        out_sh = pp.pack(total.expand(pp.l, F.k), F.rand(k_out, (pp.t,), device))
        return MsmMask(
            in_mask=fixed_base_mul(curve, in_sh), out_mask=fixed_base_mul(curve, out_sh)
        )

    def party(self, i):
        return MsmMask(in_mask=tuple(c[i] for c in self.in_mask),
                       out_mask=tuple(c[i] for c in self.out_mask))
