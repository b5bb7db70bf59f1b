"""Kernels 2-4: complete Jacobian point add, add-if and k-fold double.

Ports of zksaas_tpu/curves/fused.py::_add_call (fused_add), ::_add_select_call
(fused_add_select) and ::_double_call (fused_double): a = 0 Jacobian
formulas over Fq (G1, (B, K) coordinates) or Fq2 (G2, (B, 2, K)), one
thread per point in csrc/kernels.cu.  `point_add`, `point_add_if` and
`point_double` launch the CUDA kernel for CUDA tensors and take the plain
PyTorch version (`*_plain`) only for CPU tensors.

The plain versions compute the same formulas (fused.py:165-214) on int64
limb tensors.  Independent products are stacked into one montmul_plain
call, since on the CPU the number of torch calls, not their size, sets the
time.  The complete add's doubling is computed only when some lane has
P == Q; the select leaves the result unchanged either way.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..fields.field import add64, sub64
from ..fields.montmul import montmul_plain


def _stack(ts):
    return torch.stack(torch.broadcast_tensors(*ts))


class _PlainRing:
    """Fq (ncoord 1) or Fq2 = Fq[u]/(u^2 + 1) (ncoord 2) on int64 limbs,
    with batched ops: each takes pairs and makes one call for all of them."""

    def __init__(self, spec, ncoord: int, device):
        self.spec = spec
        self.ncoord = ncoord
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
        # Karatsuba, nr = -1: (t0 - t1, (a0 + a1)(b0 + b1) - t0 - t1)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        s = add64(self.spec, torch.stack([a0, b0]), torch.stack([a1, b1]))
        t = montmul_plain(self.spec, torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
        u = sub64(self.spec, torch.stack([t[0], t[2]]), torch.stack([t[1], t[0]]))
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


def _add64(R, X1, Y1, Z1, X2, Y2, Z2):
    """fused.py::_add_core on int64 limbs, with its four selects."""
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2 = R.muls((Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (Z1, Z2))
    U1, U2, S1, S2 = R.muls((X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1))
    H, T = R.subs((U2, U1), (S2, S1))
    H2, rr, ZZ2 = R.adds((H, H), (T, T), (Z1Z2, Z1Z2))
    I, RR, Z3 = R.muls((H2, H2), (rr, rr), (ZZ2, H))
    J, V = R.muls((H, I), (U1, I))
    (X3a,) = R.subs((RR, J))
    (V2,) = R.adds((V, V))
    (X3,) = R.subs((X3a, V2))
    (VX,) = R.subs((V, X3))
    Y3a, SJ = R.muls((rr, VX), (S1, J))
    (SJ2,) = R.adds((SJ, SJ))
    (Y3,) = R.subs((Y3a, SJ2))
    out = (X3, Y3, Z3)

    h0 = R.is_zero(H)
    r0 = R.is_zero(rr)
    is_dbl = h0 & r0
    if bool(is_dbl.any()):
        out = tuple(R.select(is_dbl, d, o) for d, o in zip(_double64(R, X1, Y1, Z1), out))
    inf = h0 & ~r0
    zero = torch.zeros_like(X1)
    out = tuple(R.select(inf, i, o) for i, o in zip((R.one, R.one, zero), out))
    out = tuple(R.select(R.is_zero(Z1), q, o) for q, o in zip((X2, Y2, Z2), out))
    out = tuple(R.select(R.is_zero(Z2), p, o) for p, o in zip((X1, Y1, Z1), out))
    return out


def point_add_plain(spec, ncoord, P, Q):
    R = _ring(spec, ncoord, P[0].device)
    out = _add64(R, *(c.long() for c in P), *(c.long() for c in Q))
    return tuple(c.int() for c in out)


def point_add_if_plain(spec, ncoord, P, Q, cond):
    R = _ring(spec, ncoord, P[0].device)
    if not bool(cond.any()):
        return tuple(c.clone() for c in P)
    P64 = tuple(c.long() for c in P)
    out = _add64(R, *P64, *(c.long() for c in Q))
    return tuple(R.select(cond, o, p).int() for o, p in zip(out, P64))


def point_double_plain(spec, ncoord, P, k: int = 1):
    R = _ring(spec, ncoord, P[0].device)
    X, Y, Z = (c.long() for c in P)
    for _ in range(k):
        X, Y, Z = _double64(R, X, Y, Z)
    return X.int(), Y.int(), Z.int()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(spec, ncoord, coords, cond=None):
    """All coordinates: one shape (B, K) / (B, 2, K), int32, contiguous, one
    device; cond: (B,) bool.  Returns (device type, B)."""
    shape = coords[0].shape
    tail = (spec.nlimbs,) if ncoord == 1 else (2, spec.nlimbs)
    if ncoord not in (1, 2) or tuple(shape[-ncoord:]) != tail:
        raise ValueError(f"point coordinates must end in {tail}, got {tuple(shape)}")
    dev = coords[0].device
    for c in coords:
        if c.shape != shape or c.dtype != torch.int32 or not c.is_contiguous() or c.device != dev:
            raise ValueError("point coordinates must be contiguous int32 tensors of one shape")
    B = shape.numel() // tail[0] // (tail[1] if ncoord == 2 else 1)
    if cond is not None:
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
        rc = kernels.cuda_lib().zk_point_add(
            ncoord, *(c.data_ptr() for c in (*P, *Q, *out)), B,
            kernels.field_params(spec).ctypes.data, kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_ADD, rc)
    return out


def point_add_if(spec, ncoord: int, P, Q, cond):
    """cond ? P + Q : P (kernel 3)."""
    dev, B = _check(spec, ncoord, (*P, *Q), cond)
    if dev == "cpu":
        return point_add_if_plain(spec, ncoord, P, Q, cond)
    out = _outs(P[0])
    if B:
        rc = kernels.cuda_lib().zk_point_add_if(
            ncoord, *(c.data_ptr() for c in (*P, *Q)), cond.data_ptr(),
            *(c.data_ptr() for c in out), B,
            kernels.field_params(spec).ctypes.data, kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_ADD_IF, rc)
    return out


def point_double(spec, ncoord: int, P, k: int = 1):
    """k successive doublings (kernel 4)."""
    dev, B = _check(spec, ncoord, P)
    if not 1 <= k <= 64:
        raise ValueError("k must be in 1..64")
    if dev == "cpu":
        return point_double_plain(spec, ncoord, P, k)
    out = _outs(P[0])
    if B:
        rc = kernels.cuda_lib().zk_point_double(
            ncoord, *(c.data_ptr() for c in (*P, *out)), B, k,
            kernels.field_params(spec).ctypes.data, kernels.stream_of(P[0]),
        )
        kernels.check(kernels.POINT_DOUBLE, rc)
    return out
