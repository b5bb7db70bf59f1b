"""Distributed two-stage FFT over packed shares.

Port of zksaas_tpu/dist/dfft.py (reference dist-primitives/src/dfft/mod.rs).
A length-m vector is shared as m/l packed sharings per party in the
"rearranged" layout (bit-reverse, then chunk i = elements i, i+m/l, ...).

* FFT1 (dfft/mod.rs:178-208): the first log(m)-log(l) butterfly stages
  combine slots within a party's local vector, so every party runs them
  share-locally (batched over the party axis).
* FFT2 (dfft/mod.rs:210-237): the last log(l) stages mix across the packed
  axis, so masked shares go to the king, who unpacks, finishes the
  butterflies, optionally coset-scales and bit-reverse-rearranges, and
  re-shares with fresh pads.

Masking (FftMask, dfft/mod.rs:16-95): parties add in_mask before the
gather and out_mask after the scatter, so the king only sees masked
values.  Randomness comes from explicit torch.Generators.  Under SpmdNet
the king's work is split over the ranks (`_fft2_sharded`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..comm.net import SpmdNet
from ..fields.field import Field, field
from ..fields.spec import FieldSpec
from ..ntt.domain import Radix2Domain, powers
from ..pss.pss import PackedSharingParams
from ..utils.pack import rearrange_perm, stride_chunks
from ..utils.rng import split
from ..utils.trace import span


@functools.cache
def _stage_factors(spec: FieldSpec, m: int, l: int, gen: int, stage_set: str, device):
    """Per-stage butterfly factor tables: for stage i, index k the factor
    is gen^(2^(i-1) * (k+1)) (dfft/mod.rs:196-206, :222-232)."""
    F = field(spec)
    p = spec.p
    log_m = m.bit_length() - 1
    log_l = l.bit_length() - 1
    stages = range(log_m, log_l, -1) if stage_set == "fft1" else range(log_l, 0, -1)
    tables = {}
    for i in stages:
        stride = pow(gen, 1 << (i - 1), p)
        tables[i] = F.encode(powers(p, stride, (m >> i) + 1)[1:], device)
    return tables


def fft1_local(pp: PackedSharingParams, px, gen: int):
    """Share-local butterfly stages (fft1_in_place, dfft/mod.rs:178-208).

    px: (..., m/l, K); gen: the full-domain generator (int)."""
    F = pp.F
    mbyl = px.shape[-2]
    m = mbyl * pp.l
    k = F.k
    tables = _stage_factors(pp.spec, m, pp.l, gen, "fft1", px.device)
    log_m = m.bit_length() - 1
    log_l = pp.l.bit_length() - 1
    lead = tuple(px.shape[:-2])
    for i in range(log_m, log_l, -1):
        ps = m >> i
        rows = (1 << i) // pp.l
        v = px.reshape(lead + (rows // 2, 2, ps, k))
        x = v[..., 0, :, :]
        y = F.mul(v[..., 1, :, :], tables[i])
        px = torch.stack([F.add(x, y), F.sub(x, y)], dim=-3).reshape(lead + (mbyl, k))
    return px


def fft2_king(pp: PackedSharingParams, s1, gen: int):
    """King-side final stages (fft2_in_place, dfft/mod.rs:210-237).

    s1: (..., m, K) unpacked values in chunk-interleaved order."""
    F = pp.F
    m = s1.shape[-2]
    k = F.k
    tables = _stage_factors(pp.spec, m, pp.l, gen, "fft2", s1.device)
    log_l = pp.l.bit_length() - 1
    lead = tuple(s1.shape[:-2])
    for i in range(log_l, 0, -1):
        ps = m >> i
        half = 1 << (i - 1)
        v = s1.reshape(lead + (ps, half, 2, k))
        x = v[..., 0, :]
        y = F.mul(v[..., 1, :], tables[i].unsqueeze(-2))
        s1 = torch.cat([F.add(x, y), F.sub(x, y)], dim=-3).reshape(lead + (m, k))
    return torch.roll(s1, 1, dims=-2)


@functools.cache
def _powers_table(spec: FieldSpec, g: int, m: int, device):
    return field(spec).encode(powers(spec.p, g, m), device)


def _distribute_powers(F: Field, x, g: int, m: int):
    return F.mul(x, _powers_table(F.spec, g, m, x.device))


@functools.cache
def _perm(m: int, device):
    return torch.from_numpy(rearrange_perm(m)).to(device)


@dataclass(frozen=True, eq=False)
class _FftKing:
    """The king computation for one (pp, m, gen, g, rearrange) config."""

    pp: PackedSharingParams
    m: int
    gen: int
    g: int
    rearrange: bool

    def __call__(self, shares, parties, rng):
        """shares: (n_present, *B, m/l, K); extra batch dims between the
        party and chunk axes carry independent transforms (the a/b/c
        polynomials batched into one round, ext_wit.rs:62-74)."""
        pp = self.pp
        F = pp.F
        mbyl = self.m // pp.l
        lead = tuple(shares.shape[1:-2])
        sh = torch.movedim(shares, 0, -2)  # (*B, m/l, n_present, K)
        secrets = pp.unpack_missing_shares(sh, parties)  # (*B, m/l, l, K)
        s1 = secrets.reshape(lead + (self.m, F.k))
        s1 = fft2_king(pp, s1, self.gen)
        if self.g != 1:
            s1 = _distribute_powers(F, s1, self.g, self.m)
        if self.rearrange:
            s1 = s1.index_select(-2, _perm(self.m, s1.device))
            chunks = stride_chunks(s1, pp.l)
        else:
            chunks = s1.reshape(lead + (mbyl, pp.l, F.k))
        out = pp.pack(chunks, pp.rand_pads(rng, lead + (mbyl,), s1.device))
        return torch.movedim(out, -2, 0)  # (n, *B, m/l, K)


# ---------------------------------------------------------------------------
# Sharded-king fft2 (the SpmdNet path)
#
# The king's O(m log l) work splits exactly over the ranks: the fft2 stages
# only ever combine values of the SAME chunk (each stage pairs adjacent
# elements, and after all log(l) stages chunk c's q-th combination sits at
# q*(m/l) + c).  So each rank unpacks and transforms an equal range of
# chunks:
#
#   all_to_all (masked shares, redistributed by chunk range)
#   -> per-chunk unpack (the unpack2 mat-vec)
#   -> per-chunk stage-composition matrix T[c] (host table)
#   -> the trailing roll by 1 (the previous rank's boundary column)
#   -> coset powers (a slice of the table)
#   -> re-pack in out-chunk order (host gather tables), the king's pads
#   -> all_to_all (each party's fresh shares) -> the receiver permutation
#
# Two all_to_alls move 1/n of the replicated king's all_gather bytes.
# Bit-equal to the king path (same matrices, same pads).  The host tables
# are cached as numpy and moved to the device where they are used.
# ---------------------------------------------------------------------------


@functools.cache
def _fft2_chunk_mats(spec: FieldSpec, m: int, l: int, gen: int):
    """Simulate fft2_king's stage loop symbolically: host-int T of shape
    (m/l, l, l) with  stage_out[q*(m/l) + c] = sum_j T[c][q][j] * s1[c*l + j],
    checking the position structure."""
    p = spec.p
    log_l = l.bit_length() - 1
    state = [(g // l, tuple(1 if j == g % l else 0 for j in range(l))) for g in range(m)]
    for i in range(log_l, 0, -1):
        ps = m >> i
        half = 1 << (i - 1)
        tab = powers(p, pow(gen, 1 << (i - 1), p), ps + 1)[1:]
        new = [None] * m
        for a in range(ps):
            fa = tab[a]
            for h in range(half):
                cx, vx = state[a * 2 * half + 2 * h]
                cy, vy = state[a * 2 * half + 2 * h + 1]
                if cx != cy:
                    raise AssertionError("fft2 stage mixed chunks")
                new[a * half + h] = (cx, tuple((u + fa * v) % p for u, v in zip(vx, vy)))
                new[m // 2 + a * half + h] = (cx, tuple((u - fa * v) % p for u, v in zip(vx, vy)))
        state = new
    T = [[None] * l for _ in range(m // l)]
    for x, (c, vec) in enumerate(state):
        q, cc = divmod(x, m // l)
        if cc != c:
            raise AssertionError("fft2 stage-out position structure violated")
        T[c][q] = vec
    return tuple(tuple(r) for r in T)


@functools.cache
def _fft2_mats_enc(spec: FieldSpec, m: int, l: int, gen: int) -> np.ndarray:
    """_fft2_chunk_mats encoded: (m/l, l, l, K) uint32 limbs."""
    T = _fft2_chunk_mats(spec, m, l, gen)
    flat = [T[c][q][j] for c in range(m // l) for q in range(l) for j in range(l)]
    return field(spec).encode_np(flat).reshape(m // l, l, l, spec.nlimbs)


@functools.cache
def _sharded_fft_tables(m: int, l: int, n: int, rearrange: bool):
    """Index tables of the sharded pack and scatter.

    Out-chunk k draws its slot-t value from stripe q'(k), column c'(k, t)
    of the stage-out array (x = q*(m/l) + c):
      rearrange: x' = bitrev_m(k + t*m/l) -> q' = rev_ll(k mod l),
                 c' = (rev_{lm-ll}(k) mod 2^{lm-2ll})*l + rev_ll(t)
      plain:     x' = k*l + t          -> q' = k >> (lm-2ll),
                 c' = (k mod 2^{lm-2ll})*l + t
    Rank d owns columns [d*C, (d+1)*C) and packs the out-chunks whose
    column block falls in its range, by ascending k.  Returns
    (gather_idx (n, C, l) into the flattened (l*C,) local stripe array,
     k_of (n, C) out-chunk ids, recv_perm (m/l,) the receiver's order)."""
    mbyl = m // l
    C = mbyl // n
    lm = m.bit_length() - 1
    ll = l.bit_length() - 1

    def rev(x, nb):
        r = 0
        for _ in range(nb):
            r = (r << 1) | (x & 1)
            x >>= 1
        return r

    per_dev = [[] for _ in range(n)]
    qp = np.zeros(mbyl, dtype=np.int64)
    cp = np.zeros((mbyl, l), dtype=np.int64)
    for k in range(mbyl):
        if rearrange:
            q = rev(k & (l - 1), ll)
            base = (rev(k, lm - ll) % (1 << (lm - 2 * ll))) * l
            cols = [base + rev(t, ll) for t in range(l)]
        else:
            q = k >> (lm - 2 * ll)
            base = (k % (1 << (lm - 2 * ll))) * l
            cols = [base + t for t in range(l)]
        qp[k] = q
        cp[k] = cols
        per_dev[cols[0] // C].append(k)

    gather_idx = np.zeros((n, C, l), dtype=np.int32)
    k_of = np.zeros((n, C), dtype=np.int32)
    recv_perm = np.zeros(mbyl, dtype=np.int32)
    for d in range(n):
        if len(per_dev[d]) != C:
            raise AssertionError("unbalanced out-chunk assignment")
        for u, k in enumerate(per_dev[d]):
            k_of[d, u] = k
            recv_perm[k] = d * C + u
            for t in range(l):
                gather_idx[d, u, t] = qp[k] * C + (cp[k, t] - d * C)
    return gather_idx, k_of, recv_perm


def _index(a: np.ndarray, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _fft2_sharded(pp, xm, rearrange, g, gen, net: SpmdNet, rng):
    """xm: (*B, m/l, K) this rank's masked post-fft1 shares; leading batch
    dims carry independent transforms (the batched a/b/c).  Returns this
    party's fresh shares, same shape."""
    F = pp.F
    n, l, k = pp.n, pp.l, F.k
    mbyl = xm.shape[-2]
    m = mbyl * l
    C = mbyl // n
    lead = tuple(xm.shape[:-2])
    nb = len(lead)
    me, dev = net.rank, xm.device
    net.begin_round("fft")

    # 1. redistribute: my shares of chunk range e -> rank e
    recv = net.all_to_all(xm.reshape(lead + (n, C, k)), nb, nb)
    sh = recv.transpose(-3, -2)  # (*B, C, n, K): all shares of MY chunks
    secrets = pp.unpack2(sh)  # (*B, C, l, K)

    # 2. per-chunk stage-composition matrix
    T = _fft2_mats_enc(pp.spec, m, l, gen)[me * C : (me + 1) * C]  # (C, l, l, K)
    T = torch.from_numpy(T.astype(np.int32)).to(dev)
    vals = F.sum(F.mul(T, secrets.unsqueeze(-3)), axis=-1)  # (*B, C, l, K)
    S = vals.transpose(-3, -2)  # (*B, l, C, K): [q, c] = stage-out at q*(m/l) + me*C + c

    # 3. roll by 1 in x order: each column shifts right, column 0 takes the
    # previous rank's last column (stripe-shifted on rank 0, where the
    # stripe index steps down across the wrap)
    prev_last = net.shift_from_prev(S[..., -1, :])  # (*B, l, K)
    first_col = torch.roll(prev_last, 1, dims=-2) if me == 0 else prev_last
    S = torch.cat([first_col.unsqueeze(-2), S[..., :-1, :]], dim=-2)

    # 4. coset powers at x = q*(m/l) + me*C + c
    if g != 1:
        P = _powers_table(pp.spec, g, m, dev).reshape(l, mbyl, k)
        S = F.mul(S, P[:, me * C : (me + 1) * C])

    # 5. pack my out-chunks with the king's pads
    gi, ko, rp = _sharded_fft_tables(m, l, n, rearrange)
    flat = S.reshape(lead + (l * C, k))
    chunks = flat.index_select(-2, _index(gi[me].reshape(-1), dev)).reshape(lead + (C, l, k))
    pads = pp.rand_pads(rng, lead + (mbyl,), dev)  # (*B, m/l, t, K), all ranks alike
    out = pp.pack(chunks, pads.index_select(-3, _index(ko[me], dev)))  # (*B, C, n, K)

    # 6. scatter, then the receiver's reorder to out-chunk order
    back = net.all_to_all(out, nb + 1, nb)  # (*B, n C, 1, K)
    return back.reshape(lead + (mbyl, k)).index_select(-2, _index(rp, dev))


def _fft2_with_rearrange(pp, px, mask, rearrange, g, gen, net, rng, channel):
    """dfft/mod.rs:240-320: mask -> gather -> king -> scatter -> unmask;
    under SpmdNet, the sharded king where the chunks split evenly (m/l
    divisible by n, each rank's chunks by l, and m >= l^2)."""
    F = pp.F
    m = px.shape[-2] * pp.l
    out = F.add(px, mask.in_mask)
    mbyl = m // pp.l
    if (isinstance(net, SpmdNet) and mbyl % pp.n == 0 and (mbyl // pp.n) % pp.l == 0
            and m >= pp.l * pp.l):
        return F.add(_fft2_sharded(pp, out, rearrange, g, gen, net, rng), mask.out_mask)
    king = _FftKing(pp, m, gen, g, rearrange)
    out_share = net.round(out, lambda xs, parties: king(xs, parties, rng), channel)
    return F.add(out_share, mask.out_mask)


@span("zk.dfft")
def d_fft(pp, pcoeff_share, mask, rearrange, dom: Radix2Domain, net, rng, channel=0):
    """Packed shares of (rearranged) coefficients -> packed shares of
    evaluations (d_fft, dfft/mod.rs:99-134)."""
    if pcoeff_share.shape[-2] * pp.l != dom.n:
        raise ValueError("share length does not match the domain")
    px = fft1_local(pp, pcoeff_share, dom.group_gen)
    return _fft2_with_rearrange(pp, px, mask, rearrange, 1, dom.group_gen, net, rng, channel)


@span("zk.difft")
def d_ifft(pp, peval_share, mask, rearrange, dom: Radix2Domain, g: int, net, rng, channel=0):
    """Packed shares of (rearranged) evaluations -> packed shares of
    coefficients, optionally scaled by powers of g (dfft/mod.rs:137-175)."""
    if peval_share.shape[-2] * pp.l != dom.n:
        raise ValueError("share length does not match the domain")
    px = pp.F.muli(peval_share, dom.size_inv)
    px = fft1_local(pp, px, dom.group_gen_inv)
    return _fft2_with_rearrange(pp, px, mask, rearrange, g, dom.group_gen_inv, net, rng, channel)


@dataclass
class FftMask:
    """Per-party additive masks for one d_fft/d_ifft call
    (dfft/mod.rs:16-95).  in_mask/out_mask: (n, m/l, K)."""

    in_mask: torch.Tensor
    out_mask: torch.Tensor

    @staticmethod
    def sample(rearrange: bool, g: int, gen: int, m: int, pp: PackedSharingParams, rng,
               device="cuda"):
        """Run the fft2 pipeline on fresh randomness (dfft/mod.rs:30-85)."""
        F = pp.F
        k_vals, k_in, k_out = split(rng, 3)
        vals = F.rand(k_vals, (m,), device)
        mbyl = m // pp.l
        in_shares = pp.pack(vals.reshape(mbyl, pp.l, F.k), pp.rand_pads(k_in, (mbyl,), device))
        s = fft2_king(pp, vals, gen)
        if g != 1:
            s = _distribute_powers(F, s, g, m)
        s = F.neg(s)
        if rearrange:
            s = s.index_select(-2, _perm(m, s.device))
            out_chunks = stride_chunks(s, pp.l)
        else:
            out_chunks = s.reshape(mbyl, pp.l, F.k)
        out_shares = pp.pack(out_chunks, pp.rand_pads(k_out, (mbyl,), device))
        return FftMask(
            in_mask=in_shares.transpose(0, 1).contiguous(),
            out_mask=out_shares.transpose(0, 1).contiguous(),
        )

    def party(self, i):
        return FftMask(in_mask=self.in_mask[i], out_mask=self.out_mask[i])
