"""Kernels 2-8: point add, add-if, k-fold double, ring product and inverse,
affine+affine add, mixed add-if.

Ports of zksaas_tpu/curves/fused.py::_add_call (fused_add), ::_add_select_call
(fused_add_select), ::_double_call (fused_double), ::_fmul_call (pfmul),
::_finv_call (pfinv), ::_aadd_call (paddaa) and ::_madd_select_call
(pmadd_if): a = 0 Jacobian formulas and coordinate-ring arithmetic over Fq
(G1, (B, K) coordinates) or Fq2 = Fq[u]/(u^2 - nr) (G2, (B, 2, K)), one
thread per element in csrc/kernels.cuh (the add and add-if: a group of
lanes per point, csrc/add_group.cuh), for K = 16 (BN254) and K = 24
(BLS12-381, BLS12-377; nr = -5 for BLS12-377's Fq2).  Each wrapper (`point_add`, `ring_mul`, ...) launches the
CUDA kernel for CUDA tensors and takes the plain PyTorch version
(`*_plain`) only for CPU tensors.

The plain versions compute the same formulas (fused.py:165-214, 311-371,
392-454) on int64 limb tensors.  Independent products are stacked into one
montmul_plain call, since on the CPU the number of torch calls, not their
size, sets the time.  The complete adds' doubling is computed only when
some lane has P == Q, and the add-ifs compute only the lanes whose cond
is set; the selects leave the results unchanged either way.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..fields.field import add64, sub64
from ..fields.montmul import montmul_plain
from ..fields.spec import fq2_nonresidue


def _stack(ts):
    shape = ts[0].shape
    if all(t.shape == shape for t in ts):
        return torch.stack(ts)
    return torch.stack(torch.broadcast_tensors(*ts))


def _neg_nr(spec, nr, x):
    """-nr * x on int64 limbs: x itself for nr = -1, else 4x + x by
    doublings, as the kernels compute it (fused.py's muli)."""
    if nr == -1:
        return x
    assert nr == -5, nr
    d = add64(spec, x, x)
    return add64(spec, add64(spec, d, d), x)


class _PlainRing:
    """Fq (ncoord 1) or Fq2 = Fq[u]/(u^2 - nr) (ncoord 2, nr from
    fields/spec.py::fq2_nonresidue) on int64 limbs, with batched ops: each
    takes pairs and makes one call for all of them."""

    def __init__(self, spec, ncoord: int, device):
        self.spec = spec
        self.ncoord = ncoord
        self.nr = fq2_nonresidue(spec)
        k = spec.nlimbs
        one = torch.tensor(
            [(spec.r_mod_p >> (16 * i)) & 0xFFFF for i in range(k)],
            dtype=torch.int64, device=device,
        )
        if ncoord == 2:
            one = torch.stack([one, torch.zeros_like(one)])
        self.one = one

    def adds(self, *pairs):
        a, b = _stack([a for a, _ in pairs]), _stack([b for _, b in pairs])
        return add64(self.spec, a, b).unbind(0)

    def subs(self, *pairs):
        a, b = _stack([a for a, _ in pairs]), _stack([b for _, b in pairs])
        return sub64(self.spec, a, b).unbind(0)

    def muls(self, *pairs):
        a, b = _stack([a for a, _ in pairs]), _stack([b for _, b in pairs])
        if self.ncoord == 1:
            return montmul_plain(self.spec, a, b).unbind(0)
        # Karatsuba: (t0 + nr t1, (a0 + a1)(b0 + b1) - t0 - t1); the sums
        # stay unreduced (< 2p, and 4p < R keeps their product below R p)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        t = montmul_plain(self.spec, torch.stack([a0, a1, a0 + a1]), torch.stack([b0, b1, b0 + b1]))
        u = sub64(self.spec, torch.stack([t[0], t[2]]),
                  torch.stack([_neg_nr(self.spec, self.nr, t[1]), t[0]]))
        c1 = sub64(self.spec, u[1], t[1])
        return torch.stack([u[0], c1], dim=-2).unbind(0)

    def is_zero(self, a):
        return (a == 0).flatten(-self.ncoord).all(-1)

    def select(self, cond, a, b):
        c = cond.reshape(cond.shape + (1,) * self.ncoord)
        return torch.where(c, a, b)


@functools.cache
def _ring(spec, ncoord, device):
    return _PlainRing(spec, ncoord, device)


def _double64(R, X, Y, Z):
    """fused.py::_double_core on int64 limbs."""
    A, B, YZ = R.muls((X, X), (Y, Y), (Y, Z))
    XB, A2, Z3 = R.adds((X, B), (A, A), (YZ, YZ))
    (E,) = R.adds((A2, A))
    C, XB2, F2 = R.muls((B, B), (XB, XB), (E, E))
    (t,) = R.subs((XB2, A))
    (t,) = R.subs((t, C))
    D, C2 = R.adds((t, t), (C, C))
    D2, C4 = R.adds((D, D), (C2, C2))
    (X3,) = R.subs((F2, D2))
    (DX,) = R.subs((D, X3))
    EDX, = R.muls((E, DX))
    (C8,) = R.adds((C4, C4))
    (Y3,) = R.subs((EDX, C8))
    return X3, Y3, Z3


def _chord64(R, H, T, U1, S1, zh, dbl):
    """The part the complete adds share (fused.py's _add_core, _madd_core,
    _aadd_core), from H = U2 - U1 and T = S2 - S1: rr = 2T, I = (2H)^2,
    J = H I, V = U1 I, X3 = rr^2 - J - 2V, Y3 = rr (V - X3) - 2 S1 J, and
    Z3 = 2 zh H (2H when zh is None); then the selects for H == 0: the
    doubling of the point `dbl` where rr == 0 too (computed only when some
    lane needs it), (one, one, zero) where not."""
    H2, rr, *zz = R.adds((H, H), (T, T), *(((zh, zh),) if zh is not None else ()))
    I, RR, *z3 = R.muls((H2, H2), (rr, rr), *(((zz[0], H),) if zz else ()))
    J, V = R.muls((H, I), (U1, I))
    (X3a,) = R.subs((RR, J))
    (V2,) = R.adds((V, V))
    (X3,) = R.subs((X3a, V2))
    (VX,) = R.subs((V, X3))
    Y3a, SJ = R.muls((rr, VX), (S1, J))
    (SJ2,) = R.adds((SJ, SJ))
    (Y3,) = R.subs((Y3a, SJ2))
    out = (X3, Y3, z3[0] if z3 else H2)

    h0 = R.is_zero(H)
    r0 = R.is_zero(rr)
    is_dbl = h0 & r0
    if bool(is_dbl.any()):
        out = tuple(R.select(is_dbl, d, o) for d, o in zip(_double64(R, *dbl), out))
    zero = torch.zeros_like(H)
    return tuple(R.select(h0 & ~r0, i, o) for i, o in zip((R.one, R.one, zero), out))


def _add64(R, X1, Y1, Z1, X2, Y2, Z2):
    """fused.py::_add_core on int64 limbs, with its four selects."""
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2 = R.muls((Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (Z1, Z2))
    U1, U2, S1, S2 = R.muls((X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1))
    H, T = R.subs((U2, U1), (S2, S1))
    out = _chord64(R, H, T, U1, S1, Z1Z2, (X1, Y1, Z1))
    out = tuple(R.select(R.is_zero(Z1), q, o) for q, o in zip((X2, Y2, Z2), out))
    return tuple(R.select(R.is_zero(Z2), p, o) for p, o in zip((X1, Y1, Z1), out))


def _aadd64(R, X1, Y1, X2, Y2, inf1, inf2):
    """fused.py::_aadd_core on int64 limbs, with its selects."""
    H, T = R.subs((X2, X1), (Y2, Y1))
    one = R.one.expand_as(X1)
    zero = torch.zeros_like(X1)
    out = _chord64(R, H, T, X1, Y1, None, (X1, Y1, one))
    Zq = R.select(inf2, zero, one)
    out = tuple(R.select(inf1, q, o) for q, o in zip((X2, Y2, Zq), out))
    Zp = R.select(inf1, zero, one)
    return tuple(R.select(inf2, p, o) for p, o in zip((X1, Y1, Zp), out))


def _madd64(R, X1, Y1, Z1, x2, y2):
    """fused.py::_madd_core on int64 limbs, with its selects."""
    Z1Z1, y2Z1 = R.muls((Z1, Z1), (y2, Z1))
    U2, S2 = R.muls((x2, Z1Z1), (y2Z1, Z1Z1))
    H, T = R.subs((U2, X1), (S2, Y1))
    one = R.one.expand_as(X1)
    out = _chord64(R, H, T, X1, Y1, Z1, (x2, y2, one))
    return tuple(R.select(R.is_zero(Z1), q, o) for q, o in zip((x2, y2, one), out))


def _inv64(spec, x):
    """x^-1 (0 -> 0) on int64 Fq limbs (..., K) by Montgomery's trick: log-depth
    prefix and suffix products, and one inverse x^(p-2) of their total by
    fused.py::_finv_call's square-and-multiply (on the CPU, ~380 products of
    one element cost less than ~380 of the whole batch)."""
    k = spec.nlimbs
    mm = functools.partial(montmul_plain, spec)
    flat = x.reshape(-1, k)
    one = _ring(spec, 1, x.device).one.expand_as(flat)
    zero = (flat == 0).all(-1, keepdim=True)
    safe = torch.where(zero, one, flat)
    scans = torch.stack([safe, safe.flip(0)])  # prefix, then suffix order
    d = 1
    while d < flat.shape[0]:  # inclusive prefix products along axis 1
        scans = torch.cat([scans[:, :d], mm(scans[:, d:], scans[:, :-d])], dim=1)
        d *= 2
    pre, suf = scans[0], scans[1].flip(0)
    total = pre[-1:]
    acc = total
    for bit in bin(spec.p - 2)[3:]:
        acc = mm(acc, acc)
        if bit == "1":
            acc = mm(acc, total)
    others = mm(torch.cat([one[:1], pre[:-1]]), torch.cat([suf[1:], one[:1]]))
    return torch.where(zero, 0, mm(others, acc)).reshape(x.shape)


def ring_mul_plain(spec, ncoord, a, b):
    R = _ring(spec, ncoord, a.device)
    return R.muls((a.long(), b.long()))[0].int()


def ring_inv_plain(spec, ncoord, a):
    a = a.long()
    if ncoord == 1:
        return _inv64(spec, a).int()
    c = a.movedim(-2, 0)  # (c0, c1)
    sq = montmul_plain(spec, c, c)
    # the norm c0^2 - nr c1^2
    ninv = _inv64(spec, add64(spec, sq[0], _neg_nr(spec, fq2_nonresidue(spec), sq[1])))
    r = montmul_plain(spec, c, ninv)
    return torch.stack([r[0], sub64(spec, torch.zeros_like(r[1]), r[1])], dim=-2).int()


def point_aadd_plain(spec, ncoord, P, Q, inf1, inf2):
    R = _ring(spec, ncoord, P[0].device)
    out = _aadd64(R, *(c.long() for c in (*P, *Q)), inf1, inf2)
    return tuple(c.int() for c in out)


def _where_cond(fn, ncoord, P, Q, cond):
    """cond ? fn(P, Q) : P, with fn run on the lanes whose cond is set only."""
    tail = P[0].shape[P[0].dim() - ncoord :]
    out = tuple(c.clone() for c in P)
    idx = cond.reshape(-1).nonzero().squeeze(1)
    if idx.numel():
        lanes = (c.reshape((-1,) + tail)[idx].long() for c in (*P, *Q))
        for o, r in zip(out, fn(*lanes)):
            o.view((-1,) + tail)[idx] = r.int()
    return out


def point_madd_if_plain(spec, ncoord, P, Q, cond):
    R = _ring(spec, ncoord, P[0].device)
    return _where_cond(functools.partial(_madd64, R), ncoord, P, Q, cond)


def point_add_plain(spec, ncoord, P, Q):
    R = _ring(spec, ncoord, P[0].device)
    out = _add64(R, *(c.long() for c in P), *(c.long() for c in Q))
    return tuple(c.int() for c in out)


def point_add_if_plain(spec, ncoord, P, Q, cond):
    R = _ring(spec, ncoord, P[0].device)
    return _where_cond(functools.partial(_add64, R), ncoord, P, Q, cond)


def point_double_plain(spec, ncoord, P, k: int = 1):
    R = _ring(spec, ncoord, P[0].device)
    X, Y, Z = (c.long() for c in P)
    for _ in range(k):
        X, Y, Z = _double64(R, X, Y, Z)
    return X.int(), Y.int(), Z.int()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(spec, ncoord, coords, *conds):
    """All coordinates: one shape (B, K) / (B, 2, K), int32, contiguous, one
    device; each cond: (B,) bool.  Returns (device type, B)."""
    shape = coords[0].shape
    tail = (spec.nlimbs,) if ncoord == 1 else (2, spec.nlimbs)
    if ncoord not in (1, 2) or tuple(shape[-ncoord:]) != tail:
        raise ValueError(f"point coordinates must end in {tail}, got {tuple(shape)}")
    dev = coords[0].device
    for c in coords:
        if c.shape != shape or c.dtype != torch.int32 or not c.is_contiguous() or c.device != dev:
            raise ValueError("point coordinates must be contiguous int32 tensors of one shape")
    B = shape.numel() // tail[0] // (tail[1] if ncoord == 2 else 1)
    for cond in conds:
        if cond.dtype != torch.bool or cond.shape != shape[: len(shape) - ncoord] or cond.device != dev:
            raise ValueError("cond must be a bool tensor of the points' batch shape")
        if not cond.is_contiguous():
            raise ValueError("cond must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"point kernels run on cuda or cpu, not {dev}")
    return dev.type, B


def _outs(like):
    return tuple(torch.empty_like(like) for _ in range(3))


def point_add(spec, ncoord: int, P, Q):
    """Complete Jacobian P + Q (kernel 2)."""
    dev, B = _check(spec, ncoord, (*P, *Q))
    if dev == "cpu":
        return point_add_plain(spec, ncoord, P, Q)
    out = _outs(P[0])
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_point_add(
            nl, nr, ncoord, *(c.data_ptr() for c in (*P, *Q, *out)), B, prm,
            kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_ADD, rc, spec)
    return out


def point_add_if(spec, ncoord: int, P, Q, cond):
    """cond ? P + Q : P (kernel 3)."""
    dev, B = _check(spec, ncoord, (*P, *Q), cond)
    if dev == "cpu":
        return point_add_if_plain(spec, ncoord, P, Q, cond)
    out = _outs(P[0])
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_point_add_if(
            nl, nr, ncoord, *(c.data_ptr() for c in (*P, *Q, cond, *out)), B, prm,
            kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_ADD_IF, rc, spec)
    return out


def point_double(spec, ncoord: int, P, k: int = 1):
    """k successive doublings (kernel 4)."""
    dev, B = _check(spec, ncoord, P)
    if not 1 <= k <= 256:
        raise ValueError("k must be in 1..256")
    if dev == "cpu":
        return point_double_plain(spec, ncoord, P, k)
    out = _outs(P[0])
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_point_double(
            nl, nr, ncoord, *(c.data_ptr() for c in (*P, *out)), B, k, prm,
            kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_DOUBLE, rc, spec)
    return out


def ring_mul(spec, ncoord: int, a, b):
    """Coordinate-ring Montgomery product a * b (kernel 5)."""
    dev, B = _check(spec, ncoord, (a, b))
    if dev == "cpu":
        return ring_mul_plain(spec, ncoord, a, b)
    out = torch.empty_like(a)
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_ring_mul(
            nl, nr, ncoord, a.data_ptr(), b.data_ptr(), out.data_ptr(), B, prm,
            kernels.stream_of(a),
        )
        kernels.check(kernels.RING_MUL, rc, spec)
    return out


def ring_inv(spec, ncoord: int, a):
    """Coordinate-ring inverse a^-1 (0 -> 0), Fq2 through the norm (kernel 6)."""
    dev, B = _check(spec, ncoord, (a,))
    if dev == "cpu":
        return ring_inv_plain(spec, ncoord, a)
    out = torch.empty_like(a)
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_ring_inv(
            nl, nr, ncoord, a.data_ptr(), out.data_ptr(), B, prm, kernels.stream_of(a),
        )
        kernels.check(kernels.RING_INV, rc, spec)
    return out


def point_aadd(spec, ncoord: int, P, Q, inf1, inf2):
    """Affine P (x, y) + affine Q -> Jacobian, complete, with per-lane
    infinity flags (kernel 7)."""
    dev, B = _check(spec, ncoord, (*P, *Q), inf1, inf2)
    if dev == "cpu":
        return point_aadd_plain(spec, ncoord, P, Q, inf1, inf2)
    out = _outs(P[0])
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_point_aadd(
            nl, nr, ncoord, *(c.data_ptr() for c in (*P, *Q, inf1, inf2, *out)), B, prm,
            kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_AADD, rc, spec)
    return out


def point_madd_if(spec, ncoord: int, P, Q, cond):
    """cond ? P + Q : P with Jacobian P and affine Q (x, y), never at
    infinity: the caller folds Q's flag into cond (kernel 8)."""
    dev, B = _check(spec, ncoord, (*P, *Q), cond)
    if dev == "cpu":
        return point_madd_if_plain(spec, ncoord, P, Q, cond)
    out = _outs(P[0])
    if B:
        nl, nr, prm = kernels.field_args(spec)
        rc = kernels.cuda_lib().zk_point_madd_if(
            nl, nr, ncoord, *(c.data_ptr() for c in (*P, *Q, cond, *out)), B, prm,
            kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_MADD_IF, rc, spec)
    return out
