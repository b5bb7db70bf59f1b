"""Bucket-Pippenger MSM from sorts, gathers and reduction trees.

Port of zksaas_tpu/curves/pippenger.py (msm_pippenger, msm_best).  With
c-bit windows, the window sum S_j = sum_k k B_jk equals sum_{k=1}^{2^c-1}
T_jk, where T_jk is the sum of the points whose digit j is >= k (a suffix
sum).  So there is no scatter into buckets: every (window, point) slot gets
the key (window | digit | slot), one sort groups the slots by window and
digit and gives the gather order in its low bits, one reduction tree over
the sorted slots serves every suffix query, and a log-depth fold combines
the windows.

The input points are made affine once (one batched inversion for all of
them), so tree level 1 is the affine+affine add and the level-0 queries
the mixed add.  Kernels on this path: ring_mul and ring_inv (the
inversion), sort_u32 (the keys), point_aadd (level 1), point_add (deeper
levels, segment sums, the fold), point_madd_if and point_add_if (the
queries), point_double (the fold).  The gathers and the searchsorted of
the query starts are plain PyTorch, as the JAX package leaves them to XLA.
Its four stages are the spans zk.msm.sort (the keys), zk.msm.inv (the
affine points), zk.msm.tree (the tree and the queries) and zk.msm.fold (the
segment sums and the window fold).

Points are (X, Y, Z) tuples in the port's layout, (..., K) for G1 and
(..., 2, K) for G2; a batch of MSMs (the parties of a d_msm) is one leading
axis of every tensor here, not a loop.  The JAX package's TPU workarounds
(_deinter, the fixed-width scan of the deep levels, _DBL_CHUNK, vary(), the
ZKSAAS_MSM_* variables and the VMEM bound MAX_VIRT) have no counterpart:
every level runs at its true width, one double launch takes any k, and the
slots of one pass are bounded by device memory (MAX_SLOT_BYTES).
"""

from __future__ import annotations

import math

import torch

from ..fields.sortperm import sort_u32
from ..fields.spec import LIMB_BITS
from ..utils.trace import span
from .point_ops import (
    point_aadd,
    point_add,
    point_add_if,
    point_double,
    point_madd_if,
    ring_inv,
    ring_mul,
)

WINDOW = 8  # c, the JAX package's default
# Packed keys (window | digit | slot) stay below 2^31, so the sorted keys
# are non-negative int32 and torch.searchsorted orders them as unsigned.
KEY_BITS = 31
# The tree levels of one pass hold about one Jacobian point per sorted slot
# (MSMs x windows x points); they may take this many bytes: 2^24 slots of
# BN254 G2 (384 B a point), 2^23 of BLS12 G2 (576 B).  A larger MSM is cut
# into point chunks whose results add.
MAX_SLOT_BYTES = 6 << 30
ROOT = 1024  # widest ring_inv at the root of the inversion tree


def _pairs(a, tail):
    """(2n, *tail) -> its even and odd elements, each contiguous."""
    v = a.view((-1, 2) + tail)
    return v[:, 0].contiguous(), v[:, 1].contiguous()


def _batch_inv(curve, d):
    """Inverses of the nonzero ring elements d (B, *tail): a product tree
    up by ring_mul, ring_inv at its root (at most ROOT wide), then down,
    inv(left) = inv(parent) * right and vice versa
    (zksaas_tpu/curves/pippenger.py::_pbatch_inv)."""
    spec, nc, tail = curve.spec, curve._ncoord, curve.R.coord_shape
    levels = []
    cur = d
    while cur.shape[0] > ROOT:
        if cur.shape[0] % 2:
            cur = torch.cat([cur, curve.R.ones((1,), cur.device)])
        levels.append(cur)
        cur = ring_mul(spec, nc, *_pairs(cur, tail))
    cur = ring_inv(spec, nc, cur)
    for lev in reversed(levels):
        lo, hi = _pairs(lev, tail)
        cur = cur[: lo.shape[0]]
        cur = torch.stack([ring_mul(spec, nc, cur, hi), ring_mul(spec, nc, cur, lo)], dim=1)
        cur = cur.reshape(lev.shape)
    return cur[: d.shape[0]]


def _to_affine(curve, P):
    """Jacobian (X, Y, Z), each (B, *tail) -> (x, y, inf): one batched
    inversion and four products (pippenger.py::_to_affine_planes)."""
    spec, nc = curve.spec, curve._ncoord
    X, Y, Z = P
    inf = curve.is_inf(P)
    one = curve.R.ones(inf.shape, Z.device)
    zi = _batch_inv(curve, curve.R.select(inf, one, Z).contiguous())
    zi2 = ring_mul(spec, nc, zi, zi)
    zi3 = ring_mul(spec, nc, zi2, zi)
    return ring_mul(spec, nc, X, zi2), ring_mul(spec, nc, Y, zi3), inf


def _psum_seg(curve, P, groups: int):
    """Sum of each of `groups` contiguous equal segments of the points P
    (pippenger.py::_psum_seg): every level adds the halves of each segment."""
    spec, nc, tail = curve.spec, curve._ncoord, curve.R.coord_shape
    n = P[0].shape[0] // groups
    while n > 1:
        half = n // 2
        v = [c.view((groups, n) + tail) for c in P]
        lo = tuple(c[:, :half].reshape((-1,) + tail).contiguous() for c in v)
        hi = tuple(c[:, half : 2 * half].reshape((-1,) + tail).contiguous() for c in v)
        s = point_add(spec, nc, lo, hi)
        if n % 2:
            s = tuple(torch.cat([a.view((groups, half) + tail), c[:, -1:]], dim=1)
                      .reshape((-1,) + tail) for a, c in zip(s, v))
        P = s
        n = P[0].shape[0] // groups
    return P


def _fold_windows(curve, S, c: int):
    """(nb, W) window sums -> (nb,) totals, sum_j 2^(c j) S_j, as a log fold
    T_j = S_2j + 2^(c 2^level) S_2j+1 (pippenger.py:342-363)."""
    spec, nc, tail = curve.spec, curve._ncoord, curve.R.coord_shape
    nb = S[0].shape[0]
    k = c
    while S[0].shape[1] > 1:
        n = S[0].shape[1]
        half = n // 2
        lo = tuple(x[:, 0 : 2 * half : 2].reshape((-1,) + tail).contiguous() for x in S)
        hi = tuple(x[:, 1 : 2 * half : 2].reshape((-1,) + tail).contiguous() for x in S)
        nxt = point_add(spec, nc, lo, point_double(spec, nc, hi, k))
        nxt = tuple(x.view((nb, half) + tail) for x in nxt)
        if n % 2:  # the odd tail waits a level; its weight doubles with k
            nxt = tuple(torch.cat([a, x[:, -1:]], dim=1) for a, x in zip(nxt, S))
        S = nxt
        k *= 2
    return tuple(x[:, 0] for x in S)


def msm_pippenger(curve, P, scalars_mont):
    """sum_i P[b, i] * s[b, i] for each b.  P: points (nb, m), m a power of
    two; scalars: (nb, m, Kr) in Montgomery form.  Returns (nb,) points."""
    nb, m = P[0].shape[:2]
    c = WINDOW
    n_windows = -(-curve.fr.spec.bits // c)
    wbits = (n_windows - 1).bit_length()
    point_bytes = 3 * math.prod(curve.R.coord_shape) * 4
    max_slots = MAX_SLOT_BYTES // point_bytes
    chunk = min(1 << (KEY_BITS - c - wbits),
                1 << max(0, (max_slots // (nb << wbits)).bit_length() - 1))
    if m > chunk:
        acc = None
        for i in range(0, m, chunk):
            part = msm_pippenger(curve, tuple(x[:, i : i + chunk] for x in P),
                                 scalars_mont[:, i : i + chunk])
            acc = part if acc is None else curve.add(acc, part)
        return acc

    spec, nc, tail = curve.spec, curve._ncoord, curve.R.coord_shape
    dev = scalars_mont.device
    L = m.bit_length() - 1
    W = 1 << wbits  # windows past n_windows have digit 0 and sum to infinity
    V = W * m  # sorted slots per MSM

    with span("zk.msm.sort"):
        raw = curve.fr.from_mont(scalars_mont.reshape(nb * m, -1)).view(nb, m, -1)
        j = torch.arange(n_windows, device=dev)
        per_limb = LIMB_BITS // c
        digits = (raw[:, :, j // per_limb] >> (c * (j % per_limb))) & ((1 << c) - 1)
        digits = torch.nn.functional.pad(digits.long(), (0, W - n_windows)).transpose(1, 2)
        wtag = torch.arange(W, device=dev).view(1, W, 1)
        slot = torch.arange(m, device=dev).view(1, 1, m)
        keys = ((wtag << (c + L)) | (digits << L) | slot).reshape(nb, V).int()
        skeys = sort_u32(keys)
        # the slot in the low bits is the point's index: flat into (nb * m)
        order = (skeys & (m - 1)).long() + torch.arange(nb, device=dev).view(nb, 1) * m
        order = order.view(-1)

    with span("zk.msm.inv"):
        xa, ya, infa = _to_affine(curve, tuple(x.reshape((nb * m,) + tail).contiguous()
                                               for x in P))

    with span("zk.msm.tree"):
        # the reduction tree over the sorted slots: level l holds the sums of
        # aligned runs of 2^l slots; runs of at most m slots stay in one window
        levels = [None]
        if L >= 1:
            lo, hi = order[0::2], order[1::2]
            lev = point_aadd(spec, nc, (xa[lo], ya[lo]), (xa[hi], ya[hi]), infa[lo], infa[hi])
            levels.append(lev)
            for _ in range(2, L + 1):
                halves = [_pairs(x, tail) for x in lev]
                lev = point_add(spec, nc, tuple(h[0] for h in halves),
                                tuple(h[1] for h in halves))
                levels.append(lev)

        # suffix query (w, k), k = 1 .. 2^c - 1: the sorted slots [b, end of
        # window w), b the first with key >= (w | k | 0), as the tree nodes
        # given by the bits of r = end - b: node (b + r mod 2^l) >> l of level
        # l for each set bit l
        nk = (1 << c) - 1
        ws = torch.arange(W, device=dev).repeat_interleave(nk)
        ks = torch.arange(1, nk + 1, device=dev).repeat(W)
        targets = ((ws << (c + L)) | (ks << L)).int().expand(nb, -1).contiguous()
        b = torch.searchsorted(skeys, targets)  # (nb, W * nk)
        r = (ws + 1) * m - b
        row = torch.arange(nb, device=dev).view(nb, 1)
        acc = tuple(x.contiguous() for x in curve.infinity((nb * W * nk,), dev))
        for lv in range(L + 1):
            has = (((r >> lv) & 1) == 1).view(-1)
            node = torch.clamp((b + (r & ((1 << lv) - 1))) >> lv, max=(V >> lv) - 1)
            idx = (node + row * (V >> lv)).view(-1)
            if lv == 0:
                pt = order[idx]
                acc = point_madd_if(spec, nc, acc, (xa[pt], ya[pt]), has & ~infa[pt])
            else:
                acc = point_add_if(spec, nc, acc, tuple(x[idx] for x in levels[lv]), has)

    with span("zk.msm.fold"):
        S = _psum_seg(curve, acc, nb * W)  # the window sums, (nb * W)
        return _fold_windows(curve, tuple(x.view((nb, W) + tail) for x in S), c)


def msm_best(curve, P, scalars_mont):
    """MSM over the last batch axis, with the leading ones as a batch of
    MSMs (pippenger.py::msm_best): P: points (..., m); scalars (..., m, Kr).
    The point axis is padded to a power of two with (infinity, 0) pairs.
    Returns points of shape (...)."""
    tail = curve.R.coord_shape
    bshape = curve.batch_shape(P)[:-1]
    m = curve.batch_shape(P)[-1]
    mp = 1 << (m - 1).bit_length()
    if mp != m:
        inf = curve.infinity(bshape + (mp - m,), P[0].device)
        P = tuple(torch.cat([x, i], dim=len(bshape)) for x, i in zip(P, inf))
        scalars_mont = torch.nn.functional.pad(scalars_mont, (0, 0, 0, mp - m))
    nb = math.prod(bshape)
    out = msm_pippenger(curve, tuple(x.reshape((nb, mp) + tail) for x in P),
                        scalars_mont.reshape(nb, mp, -1))
    return tuple(x.reshape(bshape + tail) for x in out)
