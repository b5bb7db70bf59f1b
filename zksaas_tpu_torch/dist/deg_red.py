"""Degree reduction (dist-primitives/src/utils/deg_red.rs).

Port of zksaas_tpu/dist/deg_red.py.  After share-local multiplication the
sharing degree doubles; the king unpacks (degree-2(t+l-1)-aware) and
re-packs fresh degree-(t+l-1) shares: one gather and one scatter
(deg_red.rs:80-126).  Parties blind with in_mask before sending and
un-blind with out_mask (= -mask, re-packed) afterwards.  Under SpmdNet the
king's work is split over the ranks instead (`_deg_red_sharded`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..comm.net import SpmdNet
from ..pss.pss import PackedSharingParams
from ..utils.rng import split
from ..utils.trace import span


def _deg_red_sharded(pp: PackedSharingParams, xm, rng, net: SpmdNet):
    """The sharded king of the SPMD path: the chunk axis is split over the
    ranks, each unpacks and re-packs an equal block of the sharings, and two
    all_to_alls move 1/n of the all_gather's bytes.  Bit-equal to the king
    path: the same unpack2 matrix, and the king's pads (every rank draws
    them all from a generator seeded alike, and takes its block)."""
    F = pp.F
    n = pp.n
    num = xm.shape[-2]
    C = num // n
    net.begin_round("deg_red")
    # my shares of chunk block e -> rank e
    recv = net.all_to_all(xm.reshape(n, C, F.k), 0, 0)
    sh = recv.transpose(0, 1)  # (C, n, K): all parties' shares of my chunks
    secrets = pp.unpack2(sh)  # (C, l, K)
    pads = pp.rand_pads(rng, (num,), xm.device)
    out = pp.pack(secrets, pads[net.rank * C : (net.rank + 1) * C])  # (C, n, K)
    back = net.all_to_all(out, 1, 0)  # (n C, 1, K): my share of every chunk
    return back.reshape(num, F.k)


@span("zk.deg_red")
def deg_red(pp: PackedSharingParams, x_share, mask, net, rng, channel=0):
    """x_share: (..., num, K) packed-share values (num sharings per party);
    returns re-packed degree-(t+l-1) shares."""
    F = pp.F
    xm = F.add(x_share, mask.in_mask)
    if isinstance(net, SpmdNet) and xm.shape[-2] % pp.n == 0 and x_share.ndim == 2:
        return F.add(_deg_red_sharded(pp, xm, rng, net), mask.out_mask)

    def king_fn(shares, parties):
        sh = shares.transpose(0, 1)  # (num, n_present, K)
        secrets = pp.unpack_missing_shares(sh, parties)  # (num, l, K)
        out = pp.pack(secrets, pp.rand_pads(rng, (sh.shape[0],), sh.device))
        return out.transpose(0, 1)  # (n, num, K)

    out_share = net.round(xm, king_fn, channel)
    return F.add(out_share, mask.out_mask)


@dataclass
class DegRedMask:
    """in_mask/out_mask: (n, num, K), leading party axis (deg_red.rs:14-77)."""

    in_mask: torch.Tensor
    out_mask: torch.Tensor

    @staticmethod
    def sample(pp: PackedSharingParams, num: int, rng, device="cuda"):
        F = pp.F
        k_vals, k_in, k_out = split(rng, 3)
        vals = F.rand(k_vals, (num, pp.l), device)
        in_shares = pp.pack(vals, pp.rand_pads(k_in, (num,), device))
        out_shares = pp.pack(F.neg(vals), pp.rand_pads(k_out, (num,), device))
        return DegRedMask(
            in_mask=in_shares.transpose(0, 1).contiguous(),
            out_mask=out_shares.transpose(0, 1).contiguous(),
        )

    def party(self, i):
        return DegRedMask(in_mask=self.in_mask[i], out_mask=self.out_mask[i])
