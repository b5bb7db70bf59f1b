"""Batched prime-field arithmetic on PyTorch tensors.

Port of zksaas_tpu/fields/jfield.py::Field.  Field elements are (..., K)
int32 tensors of K 16-bit little-endian limbs in Montgomery form with
R = 2^(16K): the JAX package's layout, held in int32 because CPU torch has
no unsigned 32-bit add, compare or shift.  Every result is the canonical
residue (< p), so values are bit-equal to the reference's.

`mul` is kernel 1 (fields/montmul.py): a hand-written CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.  add/sub/neg and the
compositions (inv, batch_inv, sum) are plain tensor code on either device.
`rand` takes an explicit CPU torch.Generator, from which it draws only a
256-bit ChaCha20 key; the elements come from the key's keystream, made and
reduced on the device by one kernel (csrc/kernels.cu::zk_field_rand) for
CUDA tensors and by its plain PyTorch version `rand_plain` for CPU
tensors, so a seed gives the same elements on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..utils.trace import span
from .limbs import M16, normalize
from .montmul import _consts, montmul, montmul_plain
from .spec import LIMB_BITS, LIMB_MASK, FieldSpec


M32 = 0xFFFFFFFF
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def _quarter(a, b, c, d):
    a = (a + b) & M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha20_keystream(key, nblocks: int):
    """The first `nblocks` ChaCha20 blocks (RFC 8439 section 2.3) of an
    8-word key (int64 tensor of values below 2^32), nonce 0, counter 0, 1,
    ...: (nblocks, 16) int64 words on the key's device.  The state's rows
    a, b, c, d (4 words each, one column per block) take a column round,
    then a diagonal one as the column round of b, c, d rotated by 1, 2, 3."""
    dev = key.device
    init = torch.empty((16, nblocks), dtype=torch.int64, device=dev)
    init[:4] = torch.tensor(_SIGMA, dtype=torch.int64, device=dev).view(4, 1)
    init[4:12] = key.view(8, 1)
    init[12] = torch.arange(nblocks, dtype=torch.int64, device=dev)
    init[13:] = 0
    a, b, c, d = init.view(4, 4, nblocks).unbind(0)
    for _ in range(10):
        a, b, c, d = _quarter(a, b, c, d)
        a, b, c, d = _quarter(a, b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0))
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return ((torch.cat([a, b, c, d]) + init) & M32).t()


def rand_blocks(spec, n: int) -> int:
    """ChaCha20 blocks of n elements of `spec` (K words each); raises past
    the 32-bit block counter."""
    nblocks = -(-n * spec.nlimbs // 16)
    if nblocks > 1 << 32:
        raise ValueError(f"{n} elements of {spec.name} need {nblocks} ChaCha20 blocks, "
                         "more than the 2^32 one key gives")
    return nblocks


def rand_plain(spec, key, shape, device="cpu"):
    """Plain version of zk_field_rand on `device`: element i from words [K i,
    K (i + 1)) of the key's keystream, each word two 16-bit limbs (low half
    first), lo the first K limbs and hi the next K, reduced to hi R + lo mod
    p as two Montgomery products (hi R^2 R^-1 and lo (R mod p) R^-1, exact
    for a raw operand below R) and an add, so the mod-p bias is ~2^-256."""
    shape = tuple(shape)
    k = spec.nlimbs
    n = int(np.prod(shape, dtype=np.int64))
    words = chacha20_keystream(key.to(device), rand_blocks(spec, n)).reshape(-1)[: n * k]
    raw = torch.stack([words & LIMB_MASK, words >> LIMB_BITS], -1).reshape(shape + (2 * k,))
    lo, hi = raw[..., :k], raw[..., k:]
    limbs = lambda x: torch.tensor(_int_to_limbs(x, k), dtype=torch.int64, device=device)
    hi_red = montmul_plain(spec, hi, limbs(spec.r2_mod_p))  # hi * R mod p
    lo_red = montmul_plain(spec, lo, limbs(spec.r_mod_p))  # lo mod p
    return add64(spec, hi_red, lo_red).int()


def _rand_cuda(spec, key, shape, device):
    """zk_field_rand: the elements of `key` made on the card."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    rand_blocks(spec, n)
    out = torch.empty(shape + (spec.nlimbs,), dtype=torch.int32, device=device)
    if n == 0:
        return out
    words = key.numpy().astype(np.uint32)  # read by the launcher, on the host
    nl, _, prm = kernels.field_args(spec)
    rc = kernels.cuda_lib().zk_field_rand(nl, words.ctypes.data, out.data_ptr(), n, prm,
                                          kernels.stream_of(out))
    kernels.check(kernels.FIELD_RAND, rc, n, spec)
    return out


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
        self.rand_bytes = 0  # bytes rand() has drawn on the host: 64 (a key) a call
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
        """Uniform field elements in Montgomery form, as jfield.py:388-403
        draws them (2K random 16-bit limbs reduced mod p).  `gen` is a CPU
        generator; the only draw from it is a 256-bit ChaCha20 key (8 words
        of 32 bits, counted in `rand_bytes`), so it advances alike on every
        device.  The elements are the key's keystream reduced
        (`rand_plain`), made by zk_field_rand for a CUDA device."""
        dev = resolve_device(device)
        key = torch.randint(0, 1 << 32, (8,), generator=gen, dtype=torch.int64)
        self.rand_bytes += key.numel() * key.element_size()
        if dev.type == "cuda":
            return _rand_cuda(self.spec, key, shape, dev)
        if dev.type != "cpu":
            raise ValueError(f"rand runs on cuda or cpu, not {dev}")
        return rand_plain(self.spec, key, shape, dev)


@functools.cache
def field(spec: FieldSpec) -> Field:
    return Field(spec)
