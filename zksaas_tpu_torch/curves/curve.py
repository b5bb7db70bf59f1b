"""Batched short-Weierstrass point arithmetic on PyTorch tensors.

Port of zksaas_tpu/curves/jcurve.py.  Points are (X, Y, Z) tuples of
Jacobian coordinates over Fq (G1: (..., K) tensors) or Fq2 (G2:
(..., 2, K)); infinity is (1, 1, 0) with the 1s in Montgomery form.  All
ops are elementwise over the leading batch dims.

`add`, `add_if` and `double` are kernels 2-4 (curves/point_ops.py), which
run the CUDA kernels for CUDA tensors and their plain versions for CPU
tensors.  The scalar multiplications are host loops over those kernels;
`msm` takes the bucket Pippenger of curves/pippenger.py for m >= 256.
The curves are the a = 0 curves BN254, BLS12-381 and BLS12-377
(`curve_g1`, `curve_g2`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.field import Field, field
from ..fields.spec import FIELDS, LIMB_BITS, fq2_nonresidue
from . import ref as _ref
from .point_ops import point_add, point_add_if, point_double


class FqRing:
    """Coordinate ring Fq: elements are (..., K) limb tensors."""

    def __init__(self, F: Field):
        self.F = F
        self.coord_shape = (F.k,)

    def mul(self, a, b):
        return self.F.mul(a, b)

    def square(self, a):
        return self.F.square(a)

    def neg(self, a):
        return self.F.neg(a)

    def zeros(self, shape=(), device="cuda"):
        return self.F.zeros(shape, device)

    def ones(self, shape=(), device="cuda"):
        return self.F.ones(shape, device)

    def is_zero(self, a):
        return self.F.is_zero(a)

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)

    def batch_inv(self, a, axis=0):
        return self.F.batch_inv(a, axis=axis)

    def encode(self, xs, device="cuda"):
        return self.F.encode(xs, device)

    def decode(self, a):
        return self.F.decode(a)


class Fq2Ring:
    """Coordinate ring Fq2 = Fq[u]/(u^2 - nr): elements are (..., 2, K).
    nr = -1 for BN254 and BLS12-381, -5 for BLS12-377 (fields/spec.py)."""

    def __init__(self, F: Field):
        self.F = F
        self.coord_shape = (2, F.k)
        self.nr = fq2_nonresidue(F.spec)
        assert self.nr < 0

    def _nr_t1(self, t1):
        """(-nr) * t1 (nr is a small negative int), as jcurve.py:107-109."""
        return t1 if self.nr == -1 else self.F.muli(t1, -self.nr)

    def mul(self, a, b):
        F = self.F
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        t0 = F.mul(a0, b0)
        t1 = F.mul(a1, b1)
        t2 = F.mul(F.add(a0, a1), F.add(b0, b1))
        return torch.stack([F.sub(t0, self._nr_t1(t1)), F.sub(F.sub(t2, t0), t1)], dim=-2)

    def square(self, a):
        return self.mul(a, a)

    def neg(self, a):
        return self.F.neg(a)

    def zeros(self, shape=(), device="cuda"):
        return self.F.zeros(tuple(shape) + (2,), device)

    def ones(self, shape=(), device="cuda"):
        F = self.F
        return torch.stack([F.ones(shape, device), F.zeros(shape, device)], dim=-2)

    def is_zero(self, a):
        return (a == 0).flatten(-2).all(-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def batch_inv(self, a, axis=0):
        F = self.F
        a0, a1 = a[..., 0, :], a[..., 1, :]
        norm = F.add(F.square(a0), self._nr_t1(F.square(a1)))  # a0^2 - nr a1^2
        ninv = F.batch_inv(norm, axis=axis)
        return torch.stack([F.mul(a0, ninv), F.neg(F.mul(a1, ninv))], dim=-2)

    def encode(self, xs, device="cuda"):
        """xs: nested lists of (c0, c1) pairs of ints."""
        return self.F.encode(np.asarray(xs, dtype=object), device)

    def decode(self, a):
        return self.F.decode(a)


class JCurve:
    """One curve group; points are (X, Y, Z) tuples of ring elements.

    Infinity is Z == 0 (with X = Y = 1, arkworks-style)."""

    def __init__(self, name: str, ring, curve_ref: _ref.CurveRef, fr: Field):
        self.name = name
        self.R = ring
        self.ref = curve_ref
        self.fr = fr  # scalar field
        self.order = curve_ref.order
        self._ncoord = len(ring.coord_shape)
        self.spec = ring.F.spec

    def batch_shape(self, P):
        return tuple(P[0].shape[: P[0].dim() - self._ncoord])

    # -- constructors ---------------------------------------------------

    def infinity(self, shape=(), device="cuda"):
        R = self.R
        one = R.ones(shape, device)
        return (one, one.clone(), R.zeros(shape, device))

    def encode(self, pts, shape=None, device="cuda"):
        """Flat list of affine points ((x, y) or None) -> Jacobian tensors,
        optionally reshaped to `shape` leading dims."""
        R = self.R
        is2 = self._ncoord == 2
        one = (1, 0) if is2 else 1
        zero = (0, 0) if is2 else 0
        xs = [p[0] if p is not None else one for p in pts]
        ys = [p[1] if p is not None else one for p in pts]
        zs = [zero if p is None else one for p in pts]
        out = [R.encode(v, device) for v in (xs, ys, zs)]
        if shape is not None:
            out = [c.reshape(tuple(shape) + R.coord_shape) for c in out]
        return tuple(out)

    def decode(self, P):
        """Jacobian tensors -> flat list of affine ((x, y) ints or None)."""
        X, Y, _ = self.to_affine(P)
        R = self.R
        xs, ys = R.decode(X), R.decode(Y)
        inf = self.is_inf(P).reshape(-1).cpu().numpy()
        is2 = self._ncoord == 2
        fx = np.asarray(xs, dtype=object).reshape(inf.shape[0], -1)
        fy = np.asarray(ys, dtype=object).reshape(inf.shape[0], -1)
        out = []
        for i in range(inf.shape[0]):
            if inf[i]:
                out.append(None)
            elif is2:
                out.append((tuple(fx[i]), tuple(fy[i])))
            else:
                out.append((fx[i][0], fy[i][0]))
        return out

    # -- predicates -----------------------------------------------------

    def is_inf(self, P):
        return self.R.is_zero(P[2])

    def select(self, cond, P, Q):
        R = self.R
        return tuple(R.select(cond, a, b) for a, b in zip(P, Q))

    # -- group law (kernels 2-4) ----------------------------------------

    def _flat(self, *coords):
        """Broadcast coordinates to one batch shape, contiguous."""
        cs = torch.broadcast_tensors(*coords)
        return [c.contiguous() for c in cs]

    def double(self, P, k: int = 1):
        """k successive doublings (one kernel launch)."""
        return point_double(self.spec, self._ncoord, tuple(self._flat(*P)), k)

    def add(self, P, Q):
        c = self._flat(*P, *Q)
        return point_add(self.spec, self._ncoord, tuple(c[:3]), tuple(c[3:]))

    def add_if(self, cond, P, Q):
        """cond ? P + Q : P, the predicate fused into the add kernel."""
        c = self._flat(*P, *Q)
        bshape = c[0].shape[: c[0].dim() - self._ncoord]
        cond = torch.broadcast_to(cond, bshape).contiguous()
        return point_add_if(self.spec, self._ncoord, tuple(c[:3]), tuple(c[3:]), cond)

    def neg(self, P):
        return (P[0], self.R.neg(P[1]), P[2])

    # -- conversions ----------------------------------------------------

    def to_affine(self, P):
        """Normalize Z -> 1 via batched inversion (arkworks batch_normalization)."""
        R = self.R
        X, Y, Z = P
        bshape = self.batch_shape(P)
        flatZ = Z.reshape((-1,) + R.coord_shape)
        zinv = R.batch_inv(flatZ, axis=0).reshape(Z.shape)
        zinv2 = R.square(zinv)
        zinv3 = R.mul(zinv2, zinv)
        dev = X.device
        return (
            R.mul(X, zinv2),
            R.mul(Y, zinv3),
            R.select(self.is_inf(P), R.zeros(bshape, dev), R.ones(bshape, dev)),
        )

    # -- scalar multiplication ------------------------------------------

    def _raw(self, P, scalars_mont):
        """Raw scalar limbs broadcast against P's batch shape."""
        raw = self.fr.from_mont(scalars_mont)
        bshape = torch.broadcast_shapes(self.batch_shape(P), raw.shape[:-1])
        return raw.expand(bshape + raw.shape[-1:]), bshape

    def scalar_mul(self, P, scalars_mont):
        """Batched variable-base scalar mul out[...] = P[...] * s[...]:
        binary double-and-add, one double and one add-if launch per bit.

        scalars_mont: Fr elements in Montgomery form, batch-shaped like P with
        a trailing (Kr,) limb axis."""
        raw, bshape = self._raw(P, scalars_mont)
        nbits = self.fr.spec.bits
        shifts = torch.arange(LIMB_BITS, device=raw.device, dtype=torch.int32)
        bits = ((raw.unsqueeze(-1) >> shifts) & 1).flatten(-2) > 0  # (..., 16K)
        acc = self.infinity(bshape, raw.device)
        for jj in range(nbits - 1, -1, -1):
            acc = self.double(acc)
            acc = self.add_if(bits[..., jj], acc, P)
        return acc

    def scalar_mul_w4(self, P, scalars_mont):
        """Windowed (c = 4) variable-base scalar mul: a per-element 16-entry
        multiples table (14 adds), then 64 windows of one 4-fold double
        launch and one table add.  The table lookup is a gather."""
        raw, bshape = self._raw(P, scalars_mont)
        c = 4
        nbits = self.fr.spec.bits
        n_windows = -(-nbits // c)
        per_limb = LIMB_BITS // c
        dev = raw.device
        Pb = tuple(torch.broadcast_to(x, bshape + x.shape[x.dim() - self._ncoord :]) for x in P)
        tbl = [self.infinity(bshape, dev), Pb]
        for _ in range(14):
            tbl.append(self.add(tbl[-1], Pb))
        B = int(np.prod(bshape)) if bshape else 1
        tail = self.R.coord_shape
        T = tuple(torch.stack([t[k] for t in tbl]).reshape((16, B) + tail) for k in range(3))
        del tbl
        rawf = raw.reshape(B, -1)
        idx = torch.arange(B, device=dev)
        acc = self.infinity((B,), dev)
        for i in range(n_windows):
            j = n_windows - 1 - i
            acc = self.double(acc, k=c)
            digit = ((rawf[:, j // per_limb] >> (c * (j % per_limb))) & 15).long()
            acc = self.add(acc, tuple(t[digit, idx] for t in T))
        return tuple(x.reshape(bshape + tail) for x in acc)

    def scalar_mul_int(self, P, c: int):
        """P * c for a host-int scalar."""
        s = self.fr.encode([c % self.order], device=P[0].device)[0]
        return self.scalar_mul(P, s.expand(self.batch_shape(P) + s.shape))

    def msm(self, P, scalars_mont):
        """sum_i P[i] * s[i] along axis 0, dispatched as jcurve.py:443-458
        does on the TPU: bucket Pippenger (curves/pippenger.py::msm_best)
        for m >= 256, the windowed scalar_mul_w4 and a tree sum below."""
        m = self.batch_shape(P)[0]
        if m >= 256:
            from .pippenger import msm_best

            return msm_best(self, tuple(torch.movedim(c, 0, len(self.batch_shape(P)) - 1)
                                        for c in P),
                            torch.movedim(scalars_mont, 0, -2))
        return self.sum(self.scalar_mul_w4(P, scalars_mont), axis=0)

    def sum(self, P, axis: int = 0):
        """Tree-reduce point sum along a batch axis."""
        nb = len(self.batch_shape(P))
        if axis < 0:
            axis += nb
        P = tuple(torch.movedim(c, axis, 0) for c in P)
        n = P[0].shape[0]
        while n > 1:
            half = n // 2
            even = tuple(c[0 : 2 * half : 2] for c in P)
            odd = tuple(c[1 : 2 * half : 2] for c in P)
            s = self.add(even, odd)
            if n % 2:
                s = tuple(torch.cat([a, c[-1:]], dim=0) for a, c in zip(s, P))
            P = s
            n = P[0].shape[0]
        return tuple(c[0] for c in P)

    # -- linear maps (PSS over group elements) --------------------------

    def matvec(self, M, P):
        """out[..., i] = sum_j M[i][j] * P[..., j] for a host-int matrix M
        (r x c) and points whose LAST batch axis has size c: one batched
        binary scalar_mul over all r*c products, then a tree sum (the
        'FFT in the exponent' of point packing, proving_key.rs:72-86)."""
        r, c = len(M), len(M[0])
        flat = [M[i][j] for i in range(r) for j in range(c)]
        dev = P[0].device
        S = self.fr.encode(flat, device=dev).reshape(r, c, self.fr.k)
        nc = self._ncoord
        Pt = tuple(x.unsqueeze(x.dim() - nc - 1) for x in P)  # (..., 1, c, coord)
        bshape = self.batch_shape(P)
        Sb = S.expand(bshape[:-1] + (r, c, self.fr.k))
        Pt = tuple(x.expand(bshape[:-1] + (r, c) + self.R.coord_shape) for x in Pt)
        prods = self.scalar_mul(Pt, Sb)
        return self.sum(prods, axis=-1)


CURVE_FAMILIES = ("bn254", "bls12_381", "bls12_377")


def _family(name: str) -> str:
    if name not in CURVE_FAMILIES:
        raise ValueError(f"unknown curve {name!r}; the port has {CURVE_FAMILIES}")
    return name


@functools.cache
def curve_g1(name: str = "bn254") -> JCurve:
    fam = _family(name)
    return JCurve(f"{fam}_g1", FqRing(field(FIELDS[f"{fam}_fq"])), _ref.CURVES[f"{fam}_g1"],
                  field(FIELDS[f"{fam}_fr"]))


@functools.cache
def curve_g2(name: str = "bn254") -> JCurve:
    fam = _family(name)
    return JCurve(f"{fam}_g2", Fq2Ring(field(FIELDS[f"{fam}_fq"])), _ref.CURVES[f"{fam}_g2"],
                  field(FIELDS[f"{fam}_fr"]))
