"""Batched prime-field arithmetic on PyTorch tensors.

Port of zksaas_tpu/fields/jfield.py::Field.  Field elements are (..., K)
int32 tensors of K 16-bit little-endian limbs in Montgomery form with
R = 2^(16K): the JAX package's layout, held in int32 because CPU torch has
no unsigned 32-bit add, compare or shift.  Every result is the canonical
residue (< p), so values are bit-equal to the reference's.

`mul` is kernel 1 (fields/montmul.py): a hand-written CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.  add/sub/neg and the
compositions (inv, batch_inv, sum, rand) are plain tensor code on either
device.  Randomness comes from explicit torch.Generators, drawn on the CPU
and moved, so a seed gives the same elements on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..utils.trace import span
from .limbs import M16, normalize
from .montmul import _consts, montmul
from .spec import LIMB_BITS, LIMB_MASK, FieldSpec


def _int_to_limbs(x: int, k: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(k)]


def _limbs_to_int(a) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a))


@functools.cache
def _offsets(spec, device):
    """Candidate offsets for add ([0, R - p]) and sub ([R, R + p]), with R
    as redundant limbs [2^16, 0xFFFF, ...] so a - b + R has non-negative
    columns and carries out iff a >= b."""
    P, _, NEGP = _consts(spec, device)
    full = torch.full((spec.nlimbs,), M16, dtype=torch.int64, device=device)
    full[0] = 1 << 16
    return torch.stack([torch.zeros_like(P), NEGP]), torch.stack([full, full + P])


def add64(spec, a, b):
    """(a + b) mod p on int64 limb tensors (broadcasting): both candidates
    a + b and a + b - p + R in one normalization; the second carries out
    iff a + b >= p."""
    off_add, _ = _offsets(spec, a.device)
    x, top = normalize((a + b).unsqueeze(-2) + off_add)
    return torch.where(top[..., 1:] > 0, x[..., 1, :], x[..., 0, :])


def sub64(spec, a, b):
    """(a - b) mod p on int64 limb tensors (broadcasting): candidates
    a - b + R and a - b + R + p; the first carries out iff a >= b."""
    _, off_sub = _offsets(spec, a.device)
    x, top = normalize((a - b).unsqueeze(-2) + off_sub)
    return torch.where(top[..., :1] > 0, x[..., 0, :], x[..., 1, :])


class Field:
    """Arithmetic context for one prime field (one instance per spec)."""

    _cache: dict[str, "Field"] = {}

    def __new__(cls, spec: FieldSpec):
        inst = cls._cache.get(spec.name)
        if inst is None:
            inst = super().__new__(cls)
            inst._init(spec)
            cls._cache[spec.name] = inst
        return inst

    def _init(self, spec: FieldSpec) -> None:
        self.spec = spec
        self.p = spec.p
        self.k = spec.nlimbs
        self.r_mod_p = spec.r_mod_p
        self.rand_bytes = 0  # bytes rand() has drawn on the host (and copied to the device)
        e = spec.p - 2
        self._inv_bits = [(e >> i) & 1 for i in reversed(range(e.bit_length()))]

    # ------------------------------------------------------------------
    # host <-> device conversion
    # ------------------------------------------------------------------

    def _native(self):
        if not hasattr(self, "_native_ctx"):
            from ..utils.native import context

            self._native_ctx = context(self.spec)
        return self._native_ctx

    def encode_np(self, xs) -> np.ndarray:
        """Python ints (nested lists ok) -> Montgomery-form uint32 limb array."""
        arr = np.asarray(xs, dtype=object)
        flat = arr.reshape(-1)
        nat = self._native()
        if nat is not None and flat.shape[0] > 64:
            vals = [int(v) % self.p for v in flat]
            return nat.encode_ints(vals).reshape(arr.shape + (self.k,))
        out = np.empty((flat.shape[0], self.k), dtype=np.uint32)
        for i, v in enumerate(flat):
            out[i] = _int_to_limbs((int(v) * self.r_mod_p) % self.p, self.k)
        return out.reshape(arr.shape + (self.k,))

    def encode(self, xs, device="cuda") -> torch.Tensor:
        """Python ints -> (..., K) int32 Montgomery tensor on `device`."""
        dev = resolve_device(device)
        return torch.from_numpy(self.encode_np(xs).astype(np.int32)).to(dev)

    def decode(self, a) -> np.ndarray:
        """Montgomery-form limb tensor -> object ndarray of Python ints."""
        a = np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
        a = a.astype(np.uint32)
        shape = a.shape[:-1]
        flat = a.reshape(-1, self.k)
        nat = self._native()
        out = np.empty(flat.shape[0], dtype=object)
        if nat is not None and flat.shape[0] > 64:
            out[:] = nat.decode_ints(flat)
        else:
            rinv = pow(self.spec.R, -1, self.p)
            for i in range(flat.shape[0]):
                out[i] = (_limbs_to_int(flat[i]) * rinv) % self.p
        return out.reshape(shape) if shape else out[0]

    def const(self, x: int, shape=(), device="cuda") -> torch.Tensor:
        """A Python int as a broadcast (shape + (K,)) Montgomery tensor."""
        limbs = _int_to_limbs((x % self.p) * self.r_mod_p % self.p, self.k)
        t = torch.tensor(limbs, dtype=torch.int32, device=resolve_device(device))
        return t.expand(tuple(shape) + (self.k,))

    def zeros(self, shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.k,), dtype=torch.int32,
                           device=resolve_device(device))

    def ones(self, shape=(), device="cuda") -> torch.Tensor:
        return self.const(1, shape, device)

    # ------------------------------------------------------------------
    # arithmetic (Montgomery form in, Montgomery form out)
    # ------------------------------------------------------------------

    def add(self, a, b):
        return add64(self.spec, a.long(), b.long()).int()

    def sub(self, a, b):
        return sub64(self.spec, a.long(), b.long()).int()

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p: kernel 1 (fields/montmul.py)."""
        a, b = torch.broadcast_tensors(a, b)
        return montmul(self.spec, a.contiguous(), b.contiguous())

    def square(self, a):
        return self.mul(a, a)

    def from_mont(self, a):
        """Montgomery form -> raw integer limbs (montmul by literal 1)."""
        one_raw = torch.zeros(self.k, dtype=torch.int32, device=a.device)
        one_raw[0] = 1
        return self.mul(a, one_raw)

    def muli(self, a, c: int):
        """Multiply by a host-int constant."""
        return self.mul(a, self.const(c, device=a.device))

    def sum(self, x, axis: int = 0):
        """Tree-reduce field sum along a batch axis."""
        if axis < 0:
            axis += x.dim() - 1
        x = torch.movedim(x, axis, 0)
        n = x.shape[0]
        while n > 1:
            half = n // 2
            s = self.add(x[0 : 2 * half : 2], x[1 : 2 * half : 2])
            if n % 2:
                s = torch.cat([s, x[-1:]], dim=0)
            x = s
            n = x.shape[0]
        return x[0]

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def eq(self, a, b):
        return (a == b).all(dim=-1)  # Montgomery form is canonical (< p)

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)

    # ------------------------------------------------------------------
    # inversion / exponentiation
    # ------------------------------------------------------------------

    def inv(self, a):
        """Fermat inversion a^(p-2); 0 maps to 0."""
        acc = self.ones(a.shape[:-1], device=a.device)
        for bit in self._inv_bits:
            acc = self.square(acc)
            if bit:
                acc = self.mul(acc, a)
        return acc

    def pow_const(self, a, e: int):
        """a^e for a host-int exponent (square-and-multiply)."""
        if e == 0:
            return self.ones(a.shape[:-1], device=a.device)
        acc = None
        for bit in bin(e)[2:]:
            acc = self.square(acc) if acc is not None else a
            if bit == "1" and acc is not a:
                acc = self.mul(acc, a)
        return acc

    def _scan(self, x):
        """Inclusive prefix products along axis 0 in log depth (Hillis-Steele;
        replaces jax.lax.associative_scan)."""
        d = 1
        n = x.shape[0]
        while d < n:
            x = torch.cat([x[:d], self.mul(x[d:], x[:-d])], dim=0)
            d *= 2
        return x

    def batch_inv(self, x, axis: int = 0):
        """Montgomery batched inversion along `axis` (one Fermat inversion and
        O(m log m) muls); zeros map to zeros, as ark_ff::batch_inversion."""
        x = torch.movedim(x, axis, 0)
        zero_mask = self.is_zero(x)
        one = self.ones(x.shape[:-1], device=x.device)
        safe = self.select(zero_mask, one, x)
        prefix = self._scan(safe)
        suffix = self._scan(safe.flip(0)).flip(0)
        total_inv = self.inv(prefix[-1])
        p_prev = torch.cat([one[:1], prefix[:-1]], dim=0)
        s_next = torch.cat([suffix[1:], one[:1]], dim=0)
        out = self.mul(self.mul(p_prev, s_next), total_inv.unsqueeze(0))
        out = self.select(zero_mask, torch.zeros_like(out), out)
        return torch.movedim(out, 0, axis)

    # ------------------------------------------------------------------
    # randomness
    # ------------------------------------------------------------------

    @span("zk.rand")
    def rand(self, gen: torch.Generator, shape=(), device="cuda"):
        """Uniform field elements in Montgomery form: 2K random 16-bit limbs
        (twice the modulus width) reduced to hi R + lo mod p, as
        jfield.py:388-403 does, so the mod-p bias is ~2^-256.  Both halves
        are Montgomery products (hi R^2 R^-1 and lo (R mod p) R^-1), exact
        for a raw operand below R.  `gen` is a CPU generator; `rand_bytes`
        counts the int32 limbs it draws, 8 K bytes an element."""
        dev = resolve_device(device)
        shape = tuple(shape)
        raw = torch.randint(0, 1 << 16, shape + (2 * self.k,), generator=gen,
                            dtype=torch.int32)
        self.rand_bytes += raw.numel() * raw.element_size()
        raw = raw.to(dev)
        lo, hi = raw[..., : self.k], raw[..., self.k :]
        r2 = torch.tensor(_int_to_limbs(self.spec.r2_mod_p, self.k), dtype=torch.int32,
                          device=dev)
        hi_red = self.mul(hi, r2)  # hi * R mod p
        lo_red = self.mul(lo, self.ones(device=dev))  # lo mod p
        return self.add(hi_red, lo_red)


@functools.cache
def field(spec: FieldSpec) -> Field:
    return Field(spec)
