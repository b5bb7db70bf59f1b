"""Kernel 1: batched Montgomery multiply a*b*R^-1 mod p.

Port of zksaas_tpu/fields/pallas_mul.py::_mul_call (montmul_pallas), the
TPU path of Field.mul.  `montmul` launches the CUDA kernel
(csrc/kernels.cu::zk_montmul) for CUDA tensors and takes the plain PyTorch
version `montmul_plain` only for CPU tensors.

Layout: (..., K) int32 tensors of 16-bit limbs, Montgomery form, R = 2^(16K):
K = 16 for BN254's Fq and every Fr, 24 for the BLS12 base fields.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from .limbs import M16, split_columns, sub_multiples


@functools.cache
def _consts(spec, device):
    """p, N' = -p^-1 mod R and R - p as int64 limb tensors."""
    k = spec.nlimbs
    limbs = lambda x: torch.tensor(
        [(x >> (16 * i)) & M16 for i in range(k)], dtype=torch.int64, device=device
    )
    nprime = (-pow(spec.p, -1, spec.R)) % spec.R
    return limbs(spec.p), limbs(nprime), limbs(spec.R - spec.p)


# From this many elements on, the limb-major REDC below is the cheaper
# plain version on the CPU (3-7x at 4,096 elements); below it, its ~230
# small torch calls cost more than the few large ones of the separated form.
_REDC_MIN = 512


def _montmul_redc(spec, a, b):
    """Word-by-word Montgomery reduction with the limbs as rows, (K, n):
    columns of a b, one 16-bit quotient per row, carries, and one
    conditional subtraction of p (the result is < 2p).  A column sums at
    most K products a_i b_j and K products q p_j, each < 2^32, and a carry
    < 2^22: below 2^38 at K = 24 (2^37.6) as at K = 16 (2^37), so it is
    exact in float64 (53 bits), whose vector multiply-add the CPU runs
    several times faster than int64's."""
    k = spec.nlimbs
    shape = a.shape
    A = a.reshape(-1, k).t().double().contiguous()
    B = b.reshape(-1, k).t().double().contiguous()
    P = _consts(spec, a.device)[0].view(k, 1)
    t = torch.zeros((2 * k + 1, A.shape[1]), dtype=torch.float64, device=a.device)
    for i in range(k):
        t[i : i + k].addcmul_(B, A[i])
    Pf = P.double()
    for i in range(k):
        q = (t[i].long() & M16) * spec.n0inv & M16
        t[i : i + k].addcmul_(Pf, q.double())
        t[i + 1] += torch.floor(t[i] * 2.0**-16)  # t[i] = 0 mod 2^16 now
    r = t[k:].long()
    for i in range(k):
        r[i + 1] += r[i] >> 16
        r[i] &= M16
    d = r[:k] - P
    for i in range(k - 1):
        d[i + 1] += d[i] >> 16  # -1 on a borrow
        d[i] &= M16
    below_p = r[k] + (d[k - 1] >> 16) < 0
    d[k - 1] &= M16
    return torch.where(below_p, r[:k], d).t().contiguous().reshape(shape)


@functools.cache
def _mats(spec, device):
    """Constant float64 matrices of the small-batch plain version: Ck sums
    the products a_i b_j into their columns i + j; TNP and TP take the
    16-bit pieces of K columns (piece s of column i, worth 2^(16 (i + s)),
    s < 3, in that order) to the product columns of their value mod R
    times N' (low K columns) and times p; w weighs column c by
    2^(16 (c - K))."""
    k = spec.nlimbs
    P, NP, _ = (c.double() for c in _consts(spec, device))
    i = torch.arange(k, device=device)
    Ck = torch.zeros(k * k, 2 * k - 1, dtype=torch.float64, device=device)
    Ck[torch.arange(k * k, device=device), (i.view(-1, 1) + i.view(1, -1)).reshape(-1)] = 1.0
    at = (i.view(-1, 1) + torch.arange(3, device=device).view(1, -1)).reshape(-1, 1)  # i + s
    d = i.view(1, -1) - at
    TNP = torch.where(d >= 0, NP[d.clamp(min=0)], 0.0)
    d = torch.arange(2 * k - 1, device=device).view(1, -1) - at
    TP = torch.where((d >= 0) & (d < k) & (at < k), P[d.clamp(0, k - 1)], 0.0)
    w = 2.0 ** (16 * (i - k).double())
    return Ck, TNP, TP, w


@functools.cache
def _shifts3(device):
    return torch.tensor([0, 16, 32], dtype=torch.int64, device=device)


def _pieces(x):
    """(..., n) columns below 2^48 -> (..., 3n): the 16-bit pieces of each."""
    return ((x.unsqueeze(-1) >> _shifts3(x.device)) & M16).flatten(-2)


def _fmm(x, M):
    """x @ M for int64 x whose products' column sums stay below 2^53, so
    float64 is exact (and CUDA has no int64 matrix product)."""
    return (x.double() @ M).long()


def montmul_plain(spec, a, b):
    """Plain version on int64 limb tensors (broadcasting).  Needs a b < R p
    (canonical operands, or one raw operand < R times a canonical one, or
    two unreduced sums of canonical elements, each < 2p with limbs below
    2^17, since 4p < R for every field here).
    Large batches take the limb-major REDC above.  Small ones take a
    separated Montgomery reduction in few calls, with float64 matrix
    products against constants, each exact (sums below 2^40): the product
    columns T of a b (< K 2^34); m = T N' mod R from T's low half in 16-bit
    pieces, kept as the pieces of its columns below R (< 3R); S = T + m p
    (= 0 mod R), straight from those pieces; the carry out
    of S's low K columns, an integer < 2^27 that float64 sums within
    2^-24, so U = S / R < (R p + 3R p) / R + p = 5p; the last step picks
    the residue among U - j p, j < 5, from U's columns cut to 16-bit
    pieces, which sub_multiples' one normalization carries."""
    a, b = torch.broadcast_tensors(a, b)
    if a.numel() >= _REDC_MIN * spec.nlimbs:
        return _montmul_redc(spec, a, b)
    k = spec.nlimbs
    Ck, TNP, TP, w = _mats(spec, a.device)
    T = _fmm((a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2), Ck)
    S = T + _fmm(_pieces(_fmm(_pieces(T[..., :k]), TNP)), TP)
    U = S[..., k:].clone()
    U[..., 0] += torch.round(S[..., :k].double() @ w).long()
    return sub_multiples(torch.nn.functional.pad(split_columns(U, 3), (0, 1)), spec.p, k, 5)


def _check(a, b):
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("montmul takes int32 limb tensors")
    if a.shape != b.shape or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"montmul needs equal contiguous shapes, got {a.shape} {b.shape}")
    if a.device != b.device:
        raise ValueError("montmul operands on different devices")


def montmul(spec, a, b):
    """a*b*R^-1 mod p on (..., K) int32 tensors of one shape."""
    _check(a, b)
    if a.device.type == "cpu":
        return montmul_plain(spec, a.long(), b.long()).int()
    if a.device.type != "cuda":
        raise ValueError(f"montmul runs on cuda or cpu, not {a.device}")
    if a.shape[-1] != spec.nlimbs:
        raise ValueError(f"last axis must be {spec.nlimbs} limbs")
    out = torch.empty_like(a)
    n = a.numel() // spec.nlimbs
    if n == 0:
        return out
    nl, _, prm = kernels.field_args(spec)
    rc = kernels.cuda_lib().zk_montmul(
        nl, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, prm, kernels.stream_of(a)
    )
    kernels.check(kernels.MONTMUL, rc, spec)
    return out
