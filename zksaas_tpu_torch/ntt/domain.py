"""Radix-2 evaluation domains with batched NTTs on tensors.

Port of zksaas_tpu/ntt/domain.py (the arkworks Radix2EvaluationDomain
replacement).  Generators are derived exactly as arkworks derives them
(FieldSpec.root_of_unity), so transforms agree bit for bit.  The transform
axis is the second-to-last: arrays are (..., n, K) and leading batch dims
are transformed together; each butterfly stage is one field mul (kernel 1
on the card) and one add and sub over the whole batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.field import Field, field
from ..fields.spec import FieldSpec


def bitrev_perm(n: int) -> np.ndarray:
    """Bit-reversal permutation indices (host)."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def powers(p: int, g: int, n: int) -> list[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = (out[i - 1] * g) % p
    return out


class Radix2Domain:
    """An (optionally coset-shifted) power-of-two evaluation domain."""

    def __init__(self, spec: FieldSpec, n: int, offset: int = 1):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"domain size must be a power of two, got {n}")
        self.spec = spec
        self.F: Field = field(spec)
        self.n = n
        self.log_n = n.bit_length() - 1
        p = spec.p
        self.group_gen = spec.root_of_unity(n) if n > 1 else 1
        self.group_gen_inv = pow(self.group_gen, -1, p)
        self.size_inv = pow(n, -1, p)
        self.offset = offset % p
        self.offset_inv = pow(self.offset, -1, p)
        self.offset_pow_size = pow(self.offset, n, p)
        self._brev = torch.from_numpy(bitrev_perm(n))

    @functools.cache
    def _twiddles(self, g: int, device):
        """Per-stage twiddle tables (Montgomery form) on `device`."""
        p = self.spec.p
        tables = []
        m = 1
        while m < self.n:
            tables.append(self.F.encode(powers(p, pow(g, self.n // (2 * m), p), m), device))
            m *= 2
        return tables

    @functools.cache
    def _powers(self, g: int, device):
        return self.F.encode(powers(self.spec.p, g, self.n), device)

    # ------------------------------------------------------------------

    def get_coset(self, offset: int) -> "Radix2Domain":
        return domain(self.spec, self.n, offset)

    def element(self, i: int) -> int:
        return (self.offset * pow(self.group_gen, i, self.spec.p)) % self.spec.p

    def elements(self) -> list[int]:
        p = self.spec.p
        out = [self.offset]
        for _ in range(self.n - 1):
            out.append((out[-1] * self.group_gen) % p)
        return out

    def evaluate_vanishing_polynomial(self, tau: int) -> int:
        """Z(tau) = tau^n - offset^n (host int; as arkworks evaluates it)."""
        return (pow(tau, self.n, self.spec.p) - self.offset_pow_size) % self.spec.p

    # ------------------------------------------------------------------

    def _butterflies(self, x, tables):
        """Iterative DIT NTT on bit-reversed input, axis -2."""
        F = self.F
        n = self.n
        shape = x.shape
        for s, tw in enumerate(tables):
            m = 1 << s
            xv = x.reshape(shape[:-2] + (n // (2 * m), 2, m, F.k))
            u = xv[..., 0, :, :]
            v = F.mul(xv[..., 1, :, :], tw)
            x = torch.stack([F.add(u, v), F.sub(u, v)], dim=-3).reshape(shape)
        return x

    def distribute_powers(self, x, g: int):
        """x[i] *= g^i along axis -2 (arkworks distribute_powers)."""
        return self.F.mul(x, self._powers(g % self.spec.p, x.device))

    def fft(self, coeffs):
        """coeffs (..., n, K) -> evaluations at offset*g^i, natural order."""
        if coeffs.shape[-2] != self.n:
            raise ValueError(f"expected {self.n} coefficients on axis -2")
        x = coeffs
        if self.offset != 1:
            x = self.distribute_powers(x, self.offset)
        x = x.index_select(-2, self._brev.to(x.device))
        return self._butterflies(x, self._twiddles(self.group_gen, x.device))

    def ifft(self, evals):
        """Inverse of fft (coset-aware)."""
        if evals.shape[-2] != self.n:
            raise ValueError(f"expected {self.n} evaluations on axis -2")
        x = evals.index_select(-2, self._brev.to(evals.device))
        x = self._butterflies(x, self._twiddles(self.group_gen_inv, x.device))
        x = self.F.muli(x, self.size_inv)
        if self.offset != 1:
            x = self.distribute_powers(x, self.offset_inv)
        return x


@functools.cache
def domain(spec: FieldSpec, n: int, offset: int = 1) -> Radix2Domain:
    return Radix2Domain(spec, n, offset % spec.p)
