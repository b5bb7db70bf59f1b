"""Kernel 9: ascending sort of unsigned 32-bit keys by an LSD radix sort.

Port of zksaas_tpu/fields/sortperm.py::sort_u32 (the _stage_call kernel,
one bitonic k-stage per launch under _sort_call).  The bucket-Pippenger MSM
(curves/pippenger.py) sorts its (window | digit | slot) keys with it and
reads the gather order from the low bits.

Keys are int32 tensors holding the keys' 32-bit patterns; they are ordered
as unsigned values, so a key with bit 31 set sorts after every key without
it.  `sort_u32` sorts each row (the last axis, a power of two long) of a
CUDA tensor with csrc/kernels.cu::zk_sort_u32, whatever its length: there
is no fallback to torch.sort on the card.  `sort_u32_plain`, which CPU
tensors take, is torch.sort on the keys widened to int64 (CPU torch has no
unsigned 32-bit compare), as the JAX package's CPU branch is jnp.sort.
"""

from __future__ import annotations

import torch

from .. import kernels


def sort_u32_plain(keys):
    wide = keys.long() & 0xFFFFFFFF
    out = torch.sort(wide, dim=-1).values
    return torch.where(out >= 1 << 31, out - (1 << 32), out).int()


def sort_u32(keys):
    """Each row of an int32 (..., n) tensor sorted ascending as unsigned
    32-bit keys; n a power of two.  Returns a new tensor."""
    if keys.dtype != torch.int32 or keys.dim() == 0:
        raise ValueError("sort_u32 takes an int32 tensor of rows")
    n = keys.shape[-1]
    if n & (n - 1):
        raise ValueError(f"rows must have a power-of-two length, not {n}")
    if keys.device.type == "cpu":
        return sort_u32_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_u32 runs on cuda or cpu, not {keys.device}")
    out = keys.contiguous().clone()
    if out.numel():
        lib = kernels.cuda_lib()
        scratch = torch.empty(lib.zk_sort_u32_scratch_words(out.numel(), n),
                              dtype=torch.int32, device=out.device)
        rc = lib.zk_sort_u32(out.data_ptr(), scratch.data_ptr(), out.numel(), n,
                             kernels.stream_of(out))
        kernels.check(kernels.SORT_U32, rc)
    return out
