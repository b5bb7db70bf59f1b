"""Prime fields of the benchmark's curves, as host Python ints.

The moduli, multiplicative generators and two-adicities are arkworks'
(ark-bn254, ark-bls12-381, ark-bls12-377), so roots of unity match the
evaluation domains of the program under test bit for bit.  Plain Python:
nothing here knows how the program stores a field element.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FieldSpec:
    name: str
    p: int
    generator: int  # multiplicative generator of F*
    two_adicity: int  # s with p - 1 = 2^s * odd

    def root_of_unity(self, n: int) -> int:
        """The primitive n-th root of unity arkworks' get_root_of_unity(n)
        gives, n a power of two."""
        if n <= 0 or n & (n - 1):
            raise ValueError(f"{n} is not a power of two")
        log_n = n.bit_length() - 1
        if log_n > self.two_adicity:
            raise ValueError(f"no 2^{log_n}-th root of unity in {self.name}")
        root = pow(self.generator, (self.p - 1) >> self.two_adicity, self.p)
        return pow(root, 1 << (self.two_adicity - log_n), self.p)


BN254_FR = FieldSpec(
    "bn254_fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    5, 28)
BLS12_381_FR = FieldSpec(
    "bls12_381_fr",
    52435875175126190479447740508185965837690552500527637822603658699938581184513,
    7, 32)
BLS12_377_FR = FieldSpec(
    "bls12_377_fr",
    8444461749428370424248824938781546531375899335154063827935233455917409239041,
    22, 47)
BN254_FQ = FieldSpec(
    "bn254_fq",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    3, 1)
BLS12_381_FQ = FieldSpec(
    "bls12_381_fq",
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    2, 1)
BLS12_377_FQ = FieldSpec(
    "bls12_377_fq",
    0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    15, 46)

# the scalar field of each curve family's groups
SCALAR_FIELDS = {"bn254": BN254_FR, "bls12_381": BLS12_381_FR, "bls12_377": BLS12_377_FR}
