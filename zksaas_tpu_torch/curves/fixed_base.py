"""Fixed-base scalar multiplication via windowed tables.

Port of zksaas_tpu/curves/fixed_base.py.  For the fixed generator B, the
table T[j][d] = d * 2^(4j) * B is built once on the host from the copied
big-int oracle (curves/ref.py); then s*B is 64 table lookups (plain tensor
indexing) and 64 point adds (kernel 2), batched over every scalar.  This
is the FixedBase::msm analog ark-groth16 uses for CRS generation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.spec import LIMB_BITS
from ..utils.trace import span
from .curve import JCurve

_WINDOW = 4


@functools.cache
def _table_np(curve: JCurve):
    """(n_windows * 2^c, *coord) Jacobian-encoded numpy limb arrays."""
    ref = curve.ref
    c = _WINDOW
    n_windows = -(-curve.fr.spec.bits // c)
    flat = []
    base = ref.gen
    for _ in range(n_windows):
        flat.append(None)  # 0 * B = infinity
        acc = None
        for _d in range(1, 1 << c):
            acc = ref.add(acc, base)
            flat.append(acc)
        for _ in range(c):
            base = ref.add(base, base)
    R = curve.R
    is2 = len(R.coord_shape) == 2
    one = (1, 0) if is2 else 1
    zero = (0, 0) if is2 else 0
    F = R.F
    cols = (
        [p[0] if p is not None else one for p in flat],
        [p[1] if p is not None else one for p in flat],
        [zero if p is None else one for p in flat],
    )
    return tuple(F.encode_np(np.asarray(v, dtype=object)).astype(np.int32) for v in cols)


@functools.cache
def _table(curve: JCurve, device):
    return tuple(torch.from_numpy(a).to(device) for a in _table_np(curve))


@span("zk.fixed_base")
def fixed_base_mul(curve: JCurve, scalars_mont):
    """generator * s for a batch of scalars (..., K) -> points (...)."""
    fr = curve.fr
    raw = fr.from_mont(scalars_mont)
    dev = raw.device
    Tf = _table(curve, dev)
    c = _WINDOW
    n_windows = -(-fr.spec.bits // c)
    bshape = tuple(raw.shape[:-1])
    per_limb = LIMB_BITS // c  # windows per 16-bit limb
    acc = curve.infinity(bshape, dev)
    for j in range(n_windows):
        digit = (raw[..., j // per_limb] >> (c * (j % per_limb))) & ((1 << c) - 1)
        idx = j * (1 << c) + digit.long()
        acc = curve.add(acc, tuple(t[idx] for t in Tf))
    return acc
