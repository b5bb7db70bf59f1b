"""Distributed two-stage FFT over packed shares (king path).

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
values.  Randomness comes from explicit torch.Generators.  The sharded
(multi-device) king is a later slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..fields.field import Field, field
from ..fields.spec import FieldSpec
from ..ntt.domain import Radix2Domain, powers
from ..pss.pss import PackedSharingParams
from ..utils.pack import rearrange_perm, stride_chunks
from ..utils.rng import split


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


def _fft2_with_rearrange(pp, px, mask, rearrange, g, gen, net, rng, channel):
    """dfft/mod.rs:240-320: mask -> gather -> king -> scatter -> unmask."""
    F = pp.F
    m = px.shape[-2] * pp.l
    out = F.add(px, mask.in_mask)
    king = _FftKing(pp, m, gen, g, rearrange)
    out_share = net.round(out, lambda xs, parties: king(xs, parties, rng), channel)
    return F.add(out_share, mask.out_mask)


def d_fft(pp, pcoeff_share, mask, rearrange, dom: Radix2Domain, net, rng, channel=0):
    """Packed shares of (rearranged) coefficients -> packed shares of
    evaluations (d_fft, dfft/mod.rs:99-134)."""
    if pcoeff_share.shape[-2] * pp.l != dom.n:
        raise ValueError("share length does not match the domain")
    px = fft1_local(pp, pcoeff_share, dom.group_gen)
    return _fft2_with_rearrange(pp, px, mask, rearrange, 1, dom.group_gen, net, rng, channel)


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
