"""Packed secret sharing on tensors.

Port of zksaas_tpu/pss/pss.py (reference PackedSharingParams,
secret-sharing/src/pss.rs:19-221): share domain of size n = 4l, secret
domains the cosets of F::GENERATOR of sizes l+t and 2(l+t).  Every
pack/unpack is the composite linear map of its ifft/fft chain, computed
once on the host as an integer matrix and applied as a batched small
mat-vec in field arithmetic (kernel 1 on the card), or in group arithmetic
through JCurve.matvec for point shares.

  pack       (pss.rs:90-122)  l secrets + t fresh random pads
  det_pack   (pss.rs:69-87)   zero pads (public CRS packing)
  unpack     (pss.rs:125-138) degree t+l-1 shares
  unpack2    (pss.rs:141-166) degree 2(t+l-1) shares
  lagrange_unpack (pss.rs:170-205) any >= 2(t+l-1)+1 shares
  unpack_missing_shares (pss.rs:210-221) full -> unpack2, partial -> lagrange
"""

from __future__ import annotations

import functools

import torch

from ..fields.field import Field, field
from ..fields.spec import FieldSpec
from ..ntt.domain import domain
from ..ntt.ref import fft_ref, ifft_ref
from ..utils.trace import span


def _matrix_from_map(fn, nin: int, nout: int, p: int) -> list[list[int]]:
    """Columns = images of unit vectors under the linear map `fn`."""
    M = [[0] * nin for _ in range(nout)]
    for j in range(nin):
        e = [0] * nin
        e[j] = 1
        col = fn(e)
        for i in range(nout):
            M[i][j] = col[i] % p
    return M


class PackedSharingParams:
    """(t, l, n=4l) packed Shamir sharing over `spec` (t = l)."""

    def __init__(self, spec: FieldSpec, l: int):
        self.spec = spec
        self.F: Field = field(spec)
        self.l = l
        self.t = l
        self.n = 4 * l
        g = spec.generator
        self.share = domain(spec, self.n)
        self.secret2 = domain(spec, 2 * (self.l + self.t), offset=g)

        p = spec.p
        l2 = self.l + self.t

        def pack_map(v):  # (l+t,) secrets+pads -> (n,) shares
            coeffs = ifft_ref(spec, v, offset=g)
            return fft_ref(spec, coeffs + [0] * (self.n - l2))

        def unpack_map(v):  # (n,) shares -> (l,) secrets
            coeffs = ifft_ref(spec, v)[:l2]
            return fft_ref(spec, coeffs, offset=g)[: self.l]

        def unpack2_map(v):  # (n,) degree-doubled shares -> (l,) secrets
            evals = fft_ref(spec, ifft_ref(spec, v), offset=g)
            return evals[0 : 2 * self.l : 2]

        self.M_pack = _matrix_from_map(pack_map, l2, self.n, p)
        self.M_det_pack = [row[: self.l] for row in self.M_pack]
        self.M_unpack = _matrix_from_map(unpack_map, self.n, self.l, p)
        self.M_unpack2 = _matrix_from_map(unpack2_map, self.n, self.l, p)

    @functools.cache
    def _enc(self, name: str, device):
        return self.F.encode(getattr(self, name), device)

    @functools.cache
    def lagrange_matrix(self, parties: tuple) -> tuple:
        """l x len(parties) reconstruction matrix for a surviving subset
        (pss.rs:170-205): interpolate on the survivors' share-domain points,
        evaluate at secret2[0], secret2[2], ..."""
        if len(parties) <= 2 * (self.t + self.l - 1):
            raise ValueError("not enough shares to reconstruct")
        p = self.spec.p
        els = self.share.elements()
        xs = [els[int(i)] for i in parties]
        k = len(xs)
        targets = [self.secret2.element(2 * j) for j in range(self.l)]
        rows = [[0] * k for _ in range(self.l)]
        for i in range(k):
            den = 1
            for m2 in range(k):
                if m2 != i:
                    den = (den * (xs[i] - xs[m2])) % p
            dinv = pow(den, -1, p)
            for j, tgt in enumerate(targets):
                num = 1
                for m2 in range(k):
                    if m2 != i:
                        num = (num * (tgt - xs[m2])) % p
                rows[j][i] = (num * dinv) % p
        return tuple(tuple(r) for r in rows)

    # ------------------------------------------------------------------
    # field-coefficient ops: x has shape (..., c, K)
    # ------------------------------------------------------------------

    def _matvec(self, M_enc, x):
        F = self.F
        prod = F.mul(M_enc, x.unsqueeze(-3))  # (..., r, c, K)
        return F.sum(prod, axis=-1)  # tree-sum the c axis (last batch dim)

    def pack(self, secrets, rand):
        """secrets (..., l, K) + rand (..., t, K) -> shares (..., n, K)."""
        v = torch.cat([secrets, rand], dim=-2)
        return self._matvec(self._enc("M_pack", v.device), v)

    def det_pack(self, secrets):
        return self._matvec(self._enc("M_det_pack", secrets.device), secrets)

    def unpack(self, shares):
        """shares (..., n, K) -> secrets (..., l, K)."""
        return self._matvec(self._enc("M_unpack", shares.device), shares)

    def unpack2(self, shares):
        return self._matvec(self._enc("M_unpack2", shares.device), shares)

    def lagrange_unpack(self, shares, parties: tuple):
        """shares (..., len(parties), K) -> secrets (..., l, K)."""
        M = self.F.encode(self.lagrange_matrix(tuple(parties)), shares.device)
        return self._matvec(M, shares)

    def unpack_missing_shares(self, shares, parties: tuple):
        """pss.rs:210-221 dispatch on the surviving-party tuple."""
        if len(parties) == self.n:
            return self.unpack2(shares)
        return self.lagrange_unpack(shares, tuple(parties))

    # ------------------------------------------------------------------
    # group-coefficient ops: P = (X, Y, Z) with last batch axis = c
    # ------------------------------------------------------------------

    def pack_g(self, curve, secrets, rand):
        """secrets: points (..., l); rand: points (..., t) -> (..., n)."""
        ax = -len(curve.R.coord_shape) - 1
        joined = tuple(torch.cat([s, r], dim=ax) for s, r in zip(secrets, rand))
        return curve.matvec(self.M_pack, joined)

    def det_pack_g(self, curve, secrets):
        return curve.matvec(self.M_det_pack, secrets)

    def unpack_g(self, curve, shares):
        return curve.matvec(self.M_unpack, shares)

    @span("zk.unpack2")
    def unpack2_g(self, curve, shares):
        return curve.matvec(self.M_unpack2, shares)

    def lagrange_unpack_g(self, curve, shares, parties: tuple):
        return curve.matvec(self.lagrange_matrix(tuple(parties)), shares)

    def unpack_missing_shares_g(self, curve, shares, parties: tuple):
        if len(parties) == self.n:
            return self.unpack2_g(curve, shares)
        return self.lagrange_unpack_g(curve, shares, tuple(parties))

    # ------------------------------------------------------------------

    def rand_pads(self, gen, shape=(), device="cuda"):
        """Fresh random padding values (..., t, K) for pack()."""
        return self.F.rand(gen, tuple(shape) + (self.t,), device)

    def __hash__(self):
        return hash((self.spec.name, self.l))

    def __eq__(self, other):
        return isinstance(other, PackedSharingParams) and (self.spec.name, self.l) == (
            other.spec.name,
            other.l,
        )


@functools.cache
def pss(spec: FieldSpec, l: int) -> PackedSharingParams:
    return PackedSharingParams(spec, l)
