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


def montmul_plain(spec, a, b):
    """Plain version on int64 limb tensors (broadcasting): separated
    Montgomery reduction T = a b, m = T N' mod R, (T + m p) / R.  m is kept
    redundant (16-bit pieces summed, < 4R), so (T + m p) / R < 5p and the
    last step picks the residue among r - j p, j < 5.  Needs a b < R p
    (canonical operands, or one raw operand < R times a canonical one)."""
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
