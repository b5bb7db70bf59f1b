"""Packed proving-key (CRS) shares (reference groth16/src/proving_key.rs).

Port of zksaas_tpu/groth16/proving_key.py.  The big query vectors are
chunk-wise det_pack'ed point sharings (deterministic: the CRS is public,
proving_key.rs:72-86); the small elements stay in the clear as host
affine points (proving_key.rs:106-120).  Short tail chunks are padded with
the point at infinity.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..curves.curve import JCurve
from ..device import resolve_device
from ..pss.pss import PackedSharingParams
from .local import Groth16Keys


def _pack_query(pp: PackedSharingParams, curve: JCurve, pts: list, device):
    """points -> det-packed party-major shares (n, nchunks)."""
    l = pp.l
    nch = -(-len(pts) // l)
    padded = list(pts) + [None] * (nch * l - len(pts))
    P = curve.encode(padded, shape=(nch, l), device=device)
    shares = pp.det_pack_g(curve, P)  # (nch, n)
    return tuple(c.transpose(0, 1).contiguous() for c in shares)  # (n, nch)


# the shared query vectors, point tuples with a leading party axis
SHARED = ("s", "u", "w", "h", "v")


@dataclass
class PackedProvingKeyShare:
    """Party-major packed CRS (leading axis n on every shared tensor).

    Field names follow the reference (proving_key.rs:18-37):
      s = a_query[1:], u = h_query, w = l_query, h = b_g1_query[1:],
      v = b_g2_query[1:] (G2)."""

    s: tuple
    u: tuple
    w: tuple
    h: tuple
    v: tuple
    # replicated clear elements (host affine points)
    a_query0: tuple
    b_g1_query0: tuple
    b_g2_query0: tuple
    delta_g1: tuple
    delta_g2: tuple
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple

    def party(self, i):
        """Party i's shares; the clear elements are shared by all."""
        return dataclasses.replace(
            self, **{k: tuple(c[i] for c in getattr(self, k)) for k in SHARED})


def pack_proving_key(keys: Groth16Keys, pp: PackedSharingParams, g1: JCurve, g2: JCurve,
                     device="cuda") -> PackedProvingKeyShare:
    """pack_from_arkworks_proving_key analog (proving_key.rs:47-123)."""
    dev = resolve_device(device)
    return PackedProvingKeyShare(
        s=_pack_query(pp, g1, keys.a_query[1:], dev),
        u=_pack_query(pp, g1, keys.h_query, dev),
        w=_pack_query(pp, g1, keys.l_query, dev),
        h=_pack_query(pp, g1, keys.b_g1_query[1:], dev),
        v=_pack_query(pp, g2, keys.b_g2_query[1:], dev),
        a_query0=keys.a_query[0],
        b_g1_query0=keys.b_g1_query[0],
        b_g2_query0=keys.b_g2_query[0],
        delta_g1=keys.delta_g1,
        delta_g2=keys.delta_g2,
        alpha_g1=keys.alpha_g1,
        beta_g1=keys.beta_g1,
        beta_g2=keys.beta_g2,
    )
