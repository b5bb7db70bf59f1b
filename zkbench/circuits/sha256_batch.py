"""SHA256_2 instances as one R1CS: the benchmark's circuit generator.

Parameters: `instances` (k).  The circuit holds k independent SHA256_2
instances (circomlib's Sha256_2 convention: two 216-bit field inputs
a, b, hashed as the one padded 512-bit block of their 27-byte big-endian
encodings), each exposing its 256-bit digest as two 128-bit public outputs,
in instance order.  With k = 1 it is the flagship fixture of
tangle-network/zk-SaaS (groth16/examples/sha256.rs, fixtures/sha256),
51,454 constraints.

The synthesiser is a frozen copy of the port's (zksaas_tpu_torch/circom/
sha256.py: boolean wires, XOR/AND/MAJ/CH as quadratic constraints, mod
2^32 adds by binary decomposition), on the benchmark's own builder.
`statement` gives the public outputs from hashlib alone, for the
reference.
"""

from __future__ import annotations

import hashlib
import random

from ..r1cs import LC, Circuit, ConstraintBuilder

_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]


class _Sha256Synth:
    """Synthesizes one-block SHA-256 over bit wires.

    Words are lists of 32 wire ids, LSB first (index 0 = bit 0).
    Constant bits are the special ids CONST0/CONST1 handled inline."""

    def __init__(self, cb: ConstraintBuilder):
        self.cb = cb

    # -- wire helpers ---------------------------------------------------

    def bit(self, value: int) -> int:
        """Allocate a boolean-constrained witness bit."""
        w = self.cb.witness(value & 1)
        # w * (w - 1) = 0
        self.cb.constrain([(1, w)], [(1, w), (-1, 0)], [])
        return w

    def val(self, w) -> int:
        if isinstance(w, int) and w == -1:
            return 0
        return self.cb._val(w)

    def xor2(self, a, b) -> int:
        """c = a + b - 2ab."""
        c = self.bit(self.val(a) ^ self.val(b))
        # a*b = (a + b - c)/2  ->  constraint: a * b = t, c = a + b - 2t
        # single constraint: (2a) * b = a + b - c
        self.cb.constrain([(2, a)], [(1, b)], [(1, a), (1, b), (-1, c)])
        return c

    def xor3(self, a, b, c) -> int:
        return self.xor2(self.xor2(a, b), c)

    def and2(self, a, b) -> int:
        c = self.bit(self.val(a) & self.val(b))
        self.cb.constrain([(1, a)], [(1, b)], [(1, c)])
        return c

    def maj(self, a, b, c) -> int:
        """maj = ab + c(a + b - 2ab): 2 constraints."""
        t = self.and2(a, b)
        out_val = (self.val(a) & self.val(b)) ^ (self.val(a) & self.val(c)) ^ (
            self.val(b) & self.val(c)
        )
        out = self.bit(out_val)
        # c * (a + b - 2t) = out - t
        self.cb.constrain([(1, c)], [(1, a), (1, b), (-2, t)], [(1, out), (-1, t)])
        return out

    def ch(self, e, f, g) -> int:
        """ch = e(f - g) + g: 1 constraint."""
        out_val = (self.val(e) & self.val(f)) ^ ((1 - self.val(e)) & self.val(g))
        out = self.bit(out_val)
        self.cb.constrain([(1, e)], [(1, f), (-1, g)], [(1, out), (-1, g)])
        return out

    # -- word helpers (lists of 32 bits, LSB first) ---------------------

    def rotr(self, w: list[int], n: int) -> list[int]:
        return [w[(i + n) % 32] for i in range(32)]

    def shr(self, w: list[int], n: int) -> list:
        """Logical right shift; top bits become const 0 (id -1 marker is
        not used — zeros enter via linear coefficients)."""
        return [w[i + n] if i + n < 32 else None for i in range(32)]

    def word_val(self, w) -> int:
        v = 0
        for i, b in enumerate(w):
            if b is None:
                continue
            v |= self.val(b) << i
        return v

    def xor3_words(self, x, y, z) -> list[int]:
        out = []
        for a, b, c in zip(x, y, z):
            terms = [t for t in (a, b, c) if t is not None]
            if len(terms) == 3:
                out.append(self.xor3(*terms))
            elif len(terms) == 2:
                out.append(self.xor2(*terms))
            elif len(terms) == 1:
                out.append(terms[0])
            else:
                out.append(None)
        return out

    def add_words(self, words: list, consts: list[int] = ()) -> list[int]:
        """Sum words and constants mod 2^32 via binary decomposition."""
        total = sum(self.word_val(w) for w in words) + sum(consts)
        nbits = 32 + max(1, (len(words) + len(consts)).bit_length())
        out_bits = [self.bit((total >> i) & 1) for i in range(nbits)]
        # sum_i 2^i out_i == sum words + consts   (linear, x * 1 = y)
        lhs: LC = []
        for w in words:
            for i, b in enumerate(w):
                if b is not None:
                    lhs.append((1 << i, b))
        const_sum = sum(consts)
        if const_sum:
            lhs.append((const_sum, 0))
        rhs: LC = [(1 << i, b) for i, b in enumerate(out_bits)]
        self.cb.constrain(lhs, [(1, 0)], rhs)
        return out_bits[:32]

    def compress(self, msg_bits: list[int]) -> list[list[int]]:
        """One-block compression; msg_bits: 512 wires (block bit order:
        msg_bits[i] = bit i of the padded message, MSB-first within
        words).  Returns 8 output words (bit lists, LSB first)."""
        # w[t] words: big-endian bit order in the block -> LSB-first lists
        w = []
        for t in range(16):
            blk = msg_bits[32 * t : 32 * (t + 1)]  # MSB first
            w.append(list(reversed(blk)))
        for t in range(16, 64):
            s0 = self.xor3_words(
                self.rotr(w[t - 15], 7), self.rotr(w[t - 15], 18), self.shr(w[t - 15], 3)
            )
            s1 = self.xor3_words(
                self.rotr(w[t - 2], 17), self.rotr(w[t - 2], 19), self.shr(w[t - 2], 10)
            )
            w.append(self.add_words([w[t - 16], s0, w[t - 7], s1]))

        # initial state as constant words: represent via add with consts
        a = b = c = d = e = f = g = h = None
        state_consts = list(_H0)
        # materialize state words as bits (cheap: 8 adds of a constant)
        st = [self.add_words([], [hc]) for hc in state_consts]
        a, b, c, d, e, f, g, h = st

        for t in range(64):
            S1 = self.xor3_words(self.rotr(e, 6), self.rotr(e, 11), self.rotr(e, 25))
            ch = [self.ch(x, y, z) for x, y, z in zip(e, f, g)]
            S0 = self.xor3_words(self.rotr(a, 2), self.rotr(a, 13), self.rotr(a, 22))
            mj = [self.maj(x, y, z) for x, y, z in zip(a, b, c)]
            t1 = self.add_words([h, S1, ch, w[t]], [_K[t]])
            t2 = self.add_words([S0, mj])
            h, g, f, e = g, f, e, self.add_words([d, t1])
            d, c, b, a = c, b, a, self.add_words([t1, t2])

        return [
            self.add_words([x], [hc])
            for x, hc in zip([a, b, c, d, e, f, g, h], _H0)
        ]


def draw_inputs(params: dict, rng: random.Random) -> list[tuple[int, int]]:
    """The witness inputs (a, b) of every instance, from the run's seed."""
    return [(rng.getrandbits(216), rng.getrandbits(216)) for _ in range(params["instances"])]


def _digest(a_val: int, b_val: int) -> int:
    msg = a_val.to_bytes(27, "big") + b_val.to_bytes(27, "big")
    return int.from_bytes(hashlib.sha256(msg).digest(), "big")


def statement(params: dict, inputs, p: int) -> list[int]:
    """The public outputs (high and low 128 bits of each digest), from
    hashlib."""
    out = []
    for a_val, b_val in inputs:
        d = _digest(a_val, b_val)
        out += [d >> 128, d & ((1 << 128) - 1)]
    return out


def _instance(cb: ConstraintBuilder, synth: _Sha256Synth, a_val: int, b_val: int) -> None:
    """One SHA256_2 instance, allocated and constrained as the port's
    sha256_two_inputs does."""
    if not (0 <= a_val < 1 << 216 and 0 <= b_val < 1 << 216):
        raise ValueError("SHA256_2 inputs are 216-bit")

    def input_bits(v: int) -> list[int]:
        bits = [synth.bit((v >> i) & 1) for i in range(216)]  # LSB first
        wv = cb.witness(v)
        cb.constrain([(1 << i, b) for i, b in enumerate(bits)], [(1, 0)], [(1, wv)])
        return list(reversed(bits))  # MSB first

    msg_bits = input_bits(a_val) + input_bits(b_val)
    one = cb.witness(1)
    cb.constrain([(1, one)], [(1, 0)], [(1, 0)])  # one == 1
    zero = cb.witness(0)
    cb.constrain([(1, zero)], [(1, 0)], [])  # zero == 0
    msg_bits.append(one)
    length = 432
    msg_bits += [zero] * (512 - 64 - len(msg_bits))
    msg_bits += [one if (length >> i) & 1 else zero for i in reversed(range(64))]

    out_words = synth.compress(msg_bits)

    digest_int = _digest(a_val, b_val)
    out_hi = cb.pub_input(digest_int >> 128)
    out_lo = cb.pub_input(digest_int & ((1 << 128) - 1))
    lc_hi: LC = []
    lc_lo: LC = []
    for wi, word in enumerate(out_words):
        shift = 224 - 32 * wi  # word 0 is the most significant
        for i, bit in enumerate(word):
            power = shift + i
            if power >= 128:
                lc_hi.append((1 << (power - 128), bit))
            else:
                lc_lo.append((1 << power, bit))
    cb.constrain(lc_hi, [(1, 0)], [(1, out_hi)])
    cb.constrain(lc_lo, [(1, 0)], [(1, out_lo)])


def synthesize(params: dict, inputs, p: int) -> Circuit:
    """The k-instance circuit over the scalar field of modulus p (> 2^216)
    and its full assignment."""
    if p <= 1 << 216:
        raise ValueError("SHA256_2 needs a scalar field above 2^216")
    cb = ConstraintBuilder(p)
    synth = _Sha256Synth(cb)
    for a_val, b_val in inputs:
        _instance(cb, synth, a_val, b_val)
    return cb.finalize()
