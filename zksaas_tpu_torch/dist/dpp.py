"""Distributed partial products (dist-primitives/src/dpp/mod.rs), king path.

Port of zksaas_tpu/dist/dpp.py.  Given packed shares of numerators and
denominators, computes shares of the running products num_1/den_1,
(num_1 num_2)/(den_1 den_2), ...: the permutation argument's building
block.  One king round (unpack, batch-invert the denominators,
prefix-multiply, repack; dpp/mod.rs:15-87), then a deg_red.  The king's
sequential prefix loop (dpp/mod.rs:62-65) is the log-depth Field._scan
here, as the JAX package runs an associative_scan.

Blinding: the reference ships a dummy s = 1 (dpp/mod.rs:24-26), and one
scalar cannot blind a ratio (it cancels).  PpBlind telescopes a random
vector r_1..r_m (r_0 = 1): parties blind num_i by r_{i-1} and den_i by r_i,
so the king sees y_i = r_{i-1} x_i / r_i and prefix products
z_i = (x_1...x_i) / r_i, each uniformly random, and the parties recover
the true products as z_i r_i (deg_red then drops the doubled degree).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..pss.pss import PackedSharingParams
from ..utils.rng import split
from .deg_red import deg_red


@dataclass
class PpBlind:
    """Packed shares of the telescoping blinding vector, leading party
    axis: `num` holds shares of (r_0 = 1, r_1, ..., r_{m-1}), which
    multiply the numerators; `den` holds shares of (r_1, ..., r_m), which
    multiply the denominators and unblind the king's output (z_i r_i)."""

    num: torch.Tensor  # (n, nchunks, K) shares of r_{i-1}
    den: torch.Tensor  # (n, nchunks, K) shares of r_i

    @staticmethod
    def sample(pp: PackedSharingParams, nchunks: int, rng, device="cuda"):
        F = pp.F
        m = nchunks * pp.l
        k_r, k_a, k_b = split(rng, 3)
        r = F.rand(k_r, (m,), device)  # nonzero with probability 1 - m/p
        prev = torch.cat([F.ones((1,), r.device), r[:-1]], dim=0)
        a = pp.pack(prev.reshape(nchunks, pp.l, F.k), pp.rand_pads(k_a, (nchunks,), r.device))
        b = pp.pack(r.reshape(nchunks, pp.l, F.k), pp.rand_pads(k_b, (nchunks,), r.device))
        return PpBlind(num=a.transpose(0, 1).contiguous(), den=b.transpose(0, 1).contiguous())

    def party(self, i):
        return PpBlind(num=self.num[i], den=self.den[i])


def d_pp(pp: PackedSharingParams, num_share, den_share, degred_mask, net, rng, channel=0,
         blind: PpBlind | None = None):
    """num_share, den_share: (n, num, K) packed shares.  Returns packed
    shares (n, num, K) of the partial products of num_i / den_i.  With
    `blind` the king sees only uniformly random values (module docstring);
    the blinded inputs are degree-doubled share products, which the king's
    unpack2 reconstruction takes."""
    F = pp.F
    rng, rng_dr = split(rng, 2)
    if blind is not None:
        num_share = F.mul(num_share, blind.num)
        den_share = F.mul(den_share, blind.den)
    numden = torch.cat([num_share, den_share], dim=-2)

    def king_fn(shares, parties):
        sh = shares.transpose(0, 1)  # (2 num, n_present, K)
        secrets = pp.unpack_missing_shares(sh, parties)  # (2 num, l, K)
        flat = secrets.reshape(-1, F.k)  # 2 num l values, chunk-major
        half = flat.shape[0] // 2
        ratios = F.mul(flat[:half], F.batch_inv(flat[half:], axis=0))
        chunks = F._scan(ratios).reshape(-1, pp.l, F.k)
        out = pp.pack(chunks, pp.rand_pads(rng, (chunks.shape[0],), chunks.device))
        return out.transpose(0, 1)  # (n, num, K)

    out = net.round(numden, king_fn, channel)
    if blind is not None:
        out = F.mul(out, blind.den)
    return deg_red(pp, out, degred_mask, net, rng_dr, channel)
