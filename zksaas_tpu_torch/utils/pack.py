"""Share-vector packing layouts.

Port of the layout helpers of zksaas_tpu/utils/pack.py:

  stride_chunks   the rearranged layout of d_fft inputs (qap.rs:100-113,
                  dfft/mod.rs:284-303): chunk i holds elements i, i+m/l, ...
  unstride_chunks its inverse
  rearrange_perm  fft_in_place_rearrange (dfft/mod.rs:322-335) as an index
                  permutation
"""

from __future__ import annotations

import numpy as np

from ..ntt.domain import bitrev_perm


def rearrange_perm(m: int) -> np.ndarray:
    """Index permutation equal to fft_in_place_rearrange (bit reversal)."""
    return bitrev_perm(m)


def stride_chunks(x, l: int):
    """(..., m, K) rearranged vector -> (..., m/l, l, K) where chunk i =
    elements [i, i + m/l, i + 2m/l, ...]."""
    m, k = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    return x.reshape(lead + (l, m // l, k)).transpose(-3, -2)


def unstride_chunks(x):
    """Inverse of stride_chunks: (..., m/l, l, K) -> (..., m, K)."""
    lead = tuple(x.shape[:-3])
    mbyl, l, k = x.shape[-3:]
    return x.transpose(-3, -2).reshape(lead + (mbyl * l, k))
