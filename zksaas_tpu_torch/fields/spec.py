"""Copy of zksaas_tpu/fields/spec.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python).

Field specifications for the SNARK fields used by the stack.

Mirrors the constants arkworks bakes into its field configs (reference:
arkworks ark-ff MontConfig derive; used by secret-sharing/src/pss.rs and
every layer above it).  All parameters are derived from (modulus,
multiplicative generator, two-adicity) exactly the way arkworks derives
them, so evaluation-domain generators match bit-for-bit.

Elements live on device as arrays of 16-bit limbs stored in uint32 lanes
(little-endian limb order), in Montgomery form with R = 2**(16*nlimbs).
16-bit limbs are the TPU-native choice: the VPU has no 64-bit integer
multiply, but a 16x16 product fits exactly in a uint32 lane and partial
products can be accumulated lo/hi-split without overflow.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field (host-side Python ints only)."""

    name: str
    p: int
    generator: int  # arkworks GENERATOR (multiplicative generator of F*)
    two_adicity: int  # s where p - 1 = 2^s * trace, trace odd

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def nlimbs(self) -> int:
        # R = 2^(16*nlimbs) must exceed p (one spare bit is enough for
        # the single conditional subtract at the end of montmul).
        return -(-self.bits // LIMB_BITS)

    @property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.nlimbs)

    @functools.cached_property
    def r_mod_p(self) -> int:
        return self.R % self.p

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return (self.R * self.R) % self.p

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^16 (the per-limb Montgomery factor)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def two_adic_root_of_unity(self) -> int:
        """generator^((p-1) / 2^two_adicity) mod p — matches arkworks'
        TWO_ADIC_ROOT_OF_UNITY."""
        trace = (self.p - 1) >> self.two_adicity
        return pow(self.generator, trace, self.p)

    def root_of_unity(self, n: int) -> int:
        """Primitive n-th root of unity, n a power of two — matches
        arkworks F::get_root_of_unity(n) used by Radix2EvaluationDomain
        (reference: secret-sharing/src/pss.rs:44-52 builds its domains
        from these)."""
        assert n & (n - 1) == 0 and n > 0
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, f"no 2^{log_n}-th root of unity in {self.name}"
        return pow(self.two_adic_root_of_unity, 1 << (self.two_adicity - log_n), self.p)


# --- scalar fields (Fr) -----------------------------------------------------

BN254_FR = FieldSpec(
    name="bn254_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    two_adicity=28,
)

BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    p=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
    two_adicity=32,
)

BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    p=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    generator=22,
    two_adicity=47,
)

# --- base fields (Fq, for curve arithmetic) ---------------------------------

BN254_FQ = FieldSpec(
    name="bn254_fq",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
    two_adicity=1,
)

BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
    two_adicity=1,
)

BLS12_377_FQ = FieldSpec(
    name="bls12_377_fq",
    p=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=15,
    two_adicity=46,
)

FIELDS = {
    f.name: f
    for f in (BN254_FR, BLS12_381_FR, BLS12_377_FR, BN254_FQ, BLS12_381_FQ, BLS12_377_FQ)
}

# Fq2 = Fq[u]/(u^2 - nr) quadratic nonresidue per base field (arkworks
# Fp2Config::NONRESIDUE): -1 everywhere except BLS12-377's -5.
_FQ2_NONRESIDUE = {"bls12_377_fq": -5}


def fq2_nonresidue(spec: FieldSpec) -> int:
    return _FQ2_NONRESIDUE.get(spec.name, -1)
