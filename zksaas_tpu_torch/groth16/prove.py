"""Distributed Groth16 proof-element builders and the per-party prove
driver (reference groth16/src/prove.rs and the dsha256 protocol,
groth16/examples/sha256.rs:32-129).

Port of zksaas_tpu/groth16/prove.py.  Shares of r/s and of the witness
combine with clear CRS elements through linear point ops.  prove_c's three
independent scalar muls run as one batched scalar_mul, which is the
PyTorch form of what XLA overlapped in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..curves.curve import JCurve
from ..device import resolve_device
from ..dist.dmsm import MsmMask, d_msm
from ..pss.pss import PackedSharingParams
from ..utils.rng import split
from ..utils.trace import span
from .ext_wit import circom_h, circom_masks
from .proving_key import PackedProvingKeyShare
from .qap import PackedQAPShare


def _bcast_clear(curve: JCurve, pt, shape, device):
    """Replicated clear CRS point -> point batch of `shape`."""
    P = curve.encode([pt], device=device)
    return tuple(c[0].expand(tuple(shape) + c.shape[1:]) for c in P)


def prove_a(pp, curve, crs: PackedProvingKeyShare, a_share, r_share, msm_mask, net, channel=0):
    """A = L * N^r * AG1 * prod(S_i^a_i)   (prove.rs:11-59).

    a_share: (..., nch, K) packed witness scalars; r_share: (..., K)."""
    bshape, dev = r_share.shape[:-1], r_share.device
    N = _bcast_clear(curve, crs.delta_g1, bshape, dev)
    L = _bcast_clear(curve, crs.a_query0, bshape, dev)
    AG1 = _bcast_clear(curve, crs.alpha_g1, bshape, dev)
    v1 = curve.add(L, curve.scalar_mul(N, r_share))
    prod = d_msm(pp, curve, crs.s, a_share, msm_mask, net, channel)
    return curve.add(curve.add(v1, prod), AG1)


def prove_b_g1(pp, curve, crs, a_share, s_share, msm_mask, net, channel=0):
    """B in G1 (prove.rs:63-113)."""
    bshape, dev = s_share.shape[:-1], s_share.device
    K = _bcast_clear(curve, crs.delta_g1, bshape, dev)
    Z = _bcast_clear(curve, crs.b_g1_query0, bshape, dev)
    BG1 = _bcast_clear(curve, crs.beta_g1, bshape, dev)
    v1 = curve.add(Z, curve.scalar_mul(K, s_share))
    prod = d_msm(pp, curve, crs.h, a_share, msm_mask, net, channel)
    return curve.add(curve.add(v1, prod), BG1)


def prove_b_g2(pp, curve2, crs, a_share, s_share, msm_mask, net, channel=0):
    """B in G2 (prove.rs:117-161)."""
    bshape, dev = s_share.shape[:-1], s_share.device
    K = _bcast_clear(curve2, crs.delta_g2, bshape, dev)
    Z = _bcast_clear(curve2, crs.b_g2_query0, bshape, dev)
    BG2 = _bcast_clear(curve2, crs.beta_g2, bshape, dev)
    v1 = curve2.add(Z, curve2.scalar_mul(K, s_share))
    prod = d_msm(pp, curve2, crs.v, a_share, msm_mask, net, channel)
    return curve2.add(curve2.add(v1, prod), BG2)


def prove_c(pp, curve, crs, A, B1, r_share, s_share, ax_share, h_share, msm_masks, net):
    """C = W^ax * U^h * A^s * B1^r * delta^(-rs)   (prove.rs:165-238).

    The products with r/s shares double the sharing degree; the dealer
    unpacks the final proof with unpack2 (sha256.rs:375-377)."""
    F = pp.F
    w = d_msm(pp, curve, crs.w, ax_share, msm_masks[0], net, 0)
    u = d_msm(pp, curve, crs.u, h_share, msm_masks[1], net, 1)
    bshape, dev = r_share.shape[:-1], r_share.device
    M = _bcast_clear(curve, crs.delta_g1, bshape, dev)
    rs = F.mul(r_share, s_share)
    # [delta * rs, A * s, B1 * r] as one batched scalar mul
    pts = tuple(torch.stack(torch.broadcast_tensors(m, a, b)) for m, a, b in zip(M, A, B1))
    prods = curve.scalar_mul(pts, torch.stack([rs, s_share, r_share]))
    r_s_delta, s_g_a, r_g1_b = (tuple(c[i] for c in prods) for i in range(3))
    C = curve.add(s_g_a, r_g1_b)
    C = curve.add(C, curve.neg(r_s_delta))
    C = curve.add(C, w)
    return curve.add(C, u)


@dataclass
class ProveMasks:
    """All masks one distributed prove consumes (dealer-sampled;
    sha256.rs:226-291)."""

    fft_masks: list
    degred_mask: object
    g1_msm_masks: list  # 4
    g2_msm_mask: object

    @staticmethod
    def sample(pp: PackedSharingParams, g1: JCurve, g2: JCurve, m: int, rng, device="cuda"):
        dev = resolve_device(device)
        ks = split(rng, 6)
        with span("zk.masks"):
            fft_masks, degred_mask = circom_masks(pp, m, ks[0], dev)
            g1_msm = [MsmMask.sample(pp, g1, ks[1 + i], dev) for i in range(4)]
            g2_msm = MsmMask.sample(pp, g2, ks[5], dev)
        return ProveMasks(fft_masks, degred_mask, g1_msm, g2_msm)

    def party(self, i):
        return ProveMasks(
            fft_masks=[m.party(i) for m in self.fft_masks],
            degred_mask=self.degred_mask.party(i),
            g1_msm_masks=[m.party(i) for m in self.g1_msm_masks],
            g2_msm_mask=self.g2_msm_mask.party(i),
        )


def d_prove(pp, g1, g2, crs, qap_share, a_share, ax_share, r_share, s_share,
            masks: ProveMasks, net, rng, times: dict | None = None):
    """The full per-party prove protocol (dsha256, sha256.rs:32-129):
    ext_wit -> A -> B(G1) -> B(G2) -> C.  Returns packed shares of
    (pi_a, pi_b_g2, pi_c); the dealer unpack2s them.  `times`, when given,
    collects each phase's device-synchronised seconds."""
    (k_h,) = split(rng, 1)
    with span("prove.ext_wit", times):
        h_share = circom_h(pp, qap_share, masks.fft_masks, masks.degred_mask, net, k_h)
    with span("prove.A", times):
        pi_a = prove_a(pp, g1, crs, a_share, r_share, masks.g1_msm_masks[0], net, 0)
    with span("prove.B_g1", times):
        pi_b1 = prove_b_g1(pp, g1, crs, a_share, s_share, masks.g1_msm_masks[1], net, 0)
    with span("prove.B_g2", times):
        pi_b2 = prove_b_g2(pp, g2, crs, a_share, s_share, masks.g2_msm_mask, net, 0)
    with span("prove.C", times):
        pi_c = prove_c(pp, g1, crs, pi_a, pi_b1, r_share, s_share, ax_share, h_share,
                       masks.g1_msm_masks[2:4], net)
    return pi_a, pi_b2, pi_c


def pack_witness(pp: PackedSharingParams, values: list[int], rng, device="cuda"):
    """pack_from_witness analog (sha256.rs:131-156): chunk by l with zero
    tail padding, pack, return party-major (n, nch, K)."""
    F = pp.F
    dev = resolve_device(device)
    l = pp.l
    nch = -(-len(values) // l)
    padded = list(values) + [0] * (nch * l - len(values))
    chunks = F.encode(np.asarray(padded, dtype=object).reshape(nch, l), dev)
    shares = pp.pack(chunks, pp.rand_pads(rng, (nch,), dev))
    return shares.transpose(0, 1).contiguous()


def pack_scalar_repeated(pp: PackedSharingParams, x: int, rng, device="cuda"):
    """Packed sharing of one scalar repeated l times (the r/s sharing;
    sha256.rs:203-204 packs vec![r; n]).  Returns (n, K)."""
    F = pp.F
    dev = resolve_device(device)
    sec = F.encode([[x] * pp.l], dev)
    return pp.pack(sec, pp.rand_pads(rng, (1,), dev))[0]
