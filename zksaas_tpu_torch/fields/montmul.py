"""Kernel 1: batched Montgomery multiply a*b*R^-1 mod p.

Port of zksaas_tpu/fields/pallas_mul.py::_mul_call (montmul_pallas), the
TPU path of Field.mul.  `montmul` launches the CUDA kernel
(csrc/kernels.cu::zk_montmul) for CUDA tensors and takes the plain PyTorch
version `montmul_plain` only for CPU tensors.

Layout: (..., K) int32 tensors of 16-bit limbs, Montgomery form, R = 2^(16K).
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from .limbs import M16, conv, normalize, split_columns, sub_multiples


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
# plain version on the CPU (16x at 8192 elements); below it, its ~230 small
# torch calls cost more than the few large ones of the separated form.
_REDC_MIN = 256


def _montmul_redc(spec, a, b):
    """Word-by-word Montgomery reduction with the limbs as rows, (K, n):
    columns of a b, one 16-bit quotient per row, carries, and one
    conditional subtraction of p (the result is < 2p).  The columns stay
    below 2^38, so they are exact in float64, whose vector multiply-add the
    CPU runs several times faster than int64's."""
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


def montmul_plain(spec, a, b):
    """Plain version on int64 limb tensors (broadcasting).  Needs a b < R p
    (canonical operands, or one raw operand < R times a canonical one).
    Large batches take the limb-major REDC above.  Small ones take a
    separated Montgomery reduction T = a b, m = T N' mod R, (T + m p) / R
    in few calls: m is kept redundant (16-bit pieces summed, < 4R), so
    (T + m p) / R < 5p and the last step picks the residue among r - j p,
    j < 5."""
    a, b = torch.broadcast_tensors(a, b)
    if a.numel() >= _REDC_MIN * spec.nlimbs:
        return _montmul_redc(spec, a, b)
    P, NP, _ = _consts(spec, a.device)
    k = spec.nlimbs
    T = conv(a, b)  # 2K columns < K 2^32
    m = split_columns(conv(T[..., :k], NP)[..., :k], 4)[..., :k]  # = T N' mod R, < 4 2^16
    S, _ = normalize(split_columns(T + conv(m, P), 3))  # = 0 mod R, S / R < 5p
    return sub_multiples(S[..., k : 2 * k + 2], spec.p, k, 5)


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
    L = kernels.cuda_lib()
    prm = kernels.field_params(spec)
    kernels.check(
        kernels.MONTMUL,
        L.zk_montmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            prm.ctypes.data, kernels.stream_of(a),
        ),
    )
    return out
