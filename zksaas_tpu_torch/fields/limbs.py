"""Plain PyTorch limb arithmetic on int64 tensors.

The port's public layout is (..., K) int32 tensors of 16-bit limbs.  The
plain versions of the kernels and the field's add/sub work on int64 copies,
where a product of two limbs (< 2^32) and sums of a few dozen of them fit
without wrapping (CPU torch has no unsigned 32-bit add or shift).

On the CPU every torch call costs microseconds whatever its size, so these
functions are written for few calls, not few operations:

* wide columns are cut into 16-bit pieces that are summed back shifted
  (`split_columns`), which takes any column below 2^64 to a few times 2^16
  in one step instead of one carry pass per 16 bits;
* `normalize` then needs one carry pass, and a ripple resolution in one
  more step only when a column is still >= 2^16 after it (large tensors
  carry limb by limb instead, with the limbs as rows);
* a reduction mod p compares all candidates r - j p at once
  (`sub_multiples`).
"""

from __future__ import annotations

import functools

import torch

M16 = 0xFFFF


def _pass(x):
    """One carry pass: every column's excess over 16 bits moves one limb up.
    Returns (x, carry out of the top limb)."""
    h = x >> 16
    x = x & M16
    x[..., 1:] += h[..., :-1]
    return x, h[..., -1]


def _resolve(x):
    """Exact carries of columns each <= 2^16 + 3 (what one pass leaves of
    columns < 2^18); returns (limbs, carry_out).

    A column >= 2^16 generates a carry (never two: even with one coming in
    it stays below 2^17), one == 0xFFFF passes one on; the carry out of
    column j is set iff the last column <= j that does not pass generates.
    Encoding each non-passing column j as 2j+2+gen and taking a running
    maximum finds that column and its parity at once.  The running maximum
    takes log2(n) shifted maxima: torch.cummax's CUDA scan took about 9 ms a
    call at the prove's shapes on an H100 (profile_prove, 80% of the card's
    busy time), the shifted maxima tens of microseconds."""
    n = x.shape[-1]
    base = torch.arange(2, 2 * n + 2, 2, dtype=x.dtype, device=x.device)
    v = torch.where(x == M16, 0, base + (x >> 16))
    d = 1
    while d < n:  # inclusive running maximum along the last axis
        v = torch.maximum(v, torch.nn.functional.pad(v, (d, 0))[..., :n])
        d *= 2
    cout = v & 1
    out = x.clone()
    out[..., 1:] += cout[..., :-1]
    return out & M16, cout[..., -1]


# From this many limbs on, a sequential carry with the limbs as rows is the
# cheaper normalization on the CPU (4x at 2^20 limbs): its passes are
# O(K) small calls, where _resolve's shifted maxima move the whole tensor
# several times.  Counted in limbs, so it switches at 4,096 elements of 16
# limbs and 2,731 of 24: both costs grow with the limbs per element alike.
_SEQ_MIN = 1 << 16


def _carry_rows(x):
    """Exact carries, one limb after the other, with the limbs as rows."""
    k = x.shape[-1]
    t = x.reshape(-1, k).t().contiguous()
    for i in range(k - 1):
        t[i + 1] += t[i] >> 16
        t[i] &= M16
    top = t[k - 1] >> 16
    t[k - 1] &= M16
    return t.t().contiguous().reshape(x.shape), top.reshape(x.shape[:-1])


def normalize(x):
    """Non-negative redundant columns, each below 2^18, -> exact 16-bit
    limbs and the carry out of the top limb."""
    if x.numel() >= _SEQ_MIN:
        return _carry_rows(x)
    x, top = _pass(x)  # columns <= 2^16 + 3
    if int(x.max()) > M16:
        x, c = _resolve(x)
        top = top + c
    return x, top


@functools.cache
def _shifts(npieces: int, device):
    return torch.arange(0, 16 * npieces, 16, dtype=torch.int64, device=device).view(npieces, 1)


def _skew_sum(rows):
    """(..., r, n) -> (..., n + r - 1): out[c] = sum_i rows[i, c - i]."""
    r, n = rows.shape[-2:]
    w = n + r - 1
    z = torch.nn.functional.pad(rows, (0, w + 1 - n))  # (..., r, w+1), contiguous
    # row i of the same memory read with stride w instead of w+1 starts i later
    return z.as_strided(z.shape[:-2] + (r, w), z.stride()[:-2] + (w, 1)).sum(-2)


def split_columns(x, npieces: int):
    """Columns < 2^(16 npieces) -> npieces-1 more columns of the same value,
    each < npieces 2^16: column j's 16-bit piece s is added at j + s."""
    return _skew_sum((x.unsqueeze(-2) >> _shifts(npieces, x.device)) & M16)


@functools.cache
def _multiples(p: int, k: int, count: int, device):
    """Limbs (k+2 of them) of 2R - j p for j < count, R = 2^(16k)."""
    R2 = 2 << (16 * k)
    rows = [[((R2 - j * p) >> (16 * i)) & M16 for i in range(k + 2)] for j in range(count)]
    return torch.tensor(rows, dtype=torch.int64, device=device)


def sub_multiples(r, p: int, k: int, count: int):
    """r mod p for exact limbs r (..., k+2) of a value < count p (< 2R):
    every candidate r - j p + 2R at once; the largest j whose candidate
    reaches 2R (limb k >= 2) gives the residue in its low k limbs."""
    c, _ = normalize(r.unsqueeze(-2) + _multiples(p, k, count, r.device))  # (..., count, k+2)
    j = (c[..., k] >= 2).sum(-1, keepdim=True) - 1
    idx = j.unsqueeze(-1).expand(j.shape + (k,))
    return torch.gather(c[..., :k], -2, idx).squeeze(-2)
