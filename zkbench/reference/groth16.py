"""The plain reference of a Groth16 proof: what the prover must output.

Given the toxic waste and query scalars of the CRS (the benchmark's input),
the full assignment z, the public outputs and the proof's r and s, a
Groth16 proof is fixed in the exponent:

  a = alpha + sum_i z_i A_i(tau) + r delta
  b = beta  + sum_i z_i B_i(tau) + s delta
  c = (a b - alpha beta - sum_{i public} z_i (beta A_i + alpha B_i + C_i)(tau)) / delta

(A = a G1, B = b G2, C = c G1): c is the one value for which the pairing
check e(A, B) = e(alpha, beta) e(IC, gamma) e(C, delta) holds.  So the
proof the program unpacks must equal (a G1, b G2, c G1) coordinate for
coordinate, a stricter test than the pairing check: a proof made with any
other r or s, or for another statement, differs.  `verify` is the pairing
check itself, with the verifying key made from the same scalars.

Plain Python; nothing of the program under test is imported.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import curves


def groups(family: str):
    return curves.CURVES[f"{family}_g1"], curves.CURVES[f"{family}_g2"]


@dataclass
class Statement:
    """What one run's proofs share: the curve family, the CRS scalars
    (an object with alpha, beta, gamma, delta, a_t, b_t, gamma_abc), the
    public outputs, and A(tau), B(tau) of the assignment."""

    family: str
    crs: object
    public: list
    a_tau: int
    b_tau: int

    @staticmethod
    def make(family: str, crs, z: list[int], public: list[int]) -> "Statement":
        order = groups(family)[0].order
        a_tau = sum(x * y for x, y in zip(z, crs.a_t)) % order
        b_tau = sum(x * y for x, y in zip(z, crs.b_t)) % order
        return Statement(family, crs, list(public), a_tau, b_tau)

    def exponents(self, r: int, s: int) -> tuple[int, int, int]:
        crs = self.crs
        q = groups(self.family)[0].order
        a = (crs.alpha + self.a_tau + r * crs.delta) % q
        b = (crs.beta + self.b_tau + s * crs.delta) % q
        ic = crs.gamma_abc[0] + sum(x * g for x, g in zip(self.public, crs.gamma_abc[1:]))
        c = (a * b - crs.alpha * crs.beta - ic * crs.gamma) * pow(crs.delta, -1, q) % q
        return a, b, c

    def expected_proof(self, r: int, s: int):
        """(A, B, C) as affine points, the format the program's decode gives."""
        G1, G2 = groups(self.family)
        a, b, c = self.exponents(r, s)
        return G1.mul(G1.gen, a), G2.mul(G2.gen, b), G1.mul(G1.gen, c)


def verify(family: str, crs, public: list[int], proof) -> bool:
    """The Groth16 pairing check of proof = (A, B, C) against the verifying
    key of the CRS scalars."""
    G1, G2 = groups(family)
    ic = (crs.gamma_abc[0] + sum(x * g for x, g in zip(public, crs.gamma_abc[1:]))) % G1.order
    A, B, C = proof
    lhs = curves.pairing(A, B, family)
    rhs = curves.multi_pairing(
        [(G1.mul(G1.gen, crs.alpha), G2.mul(G2.gen, crs.beta)),
         (G1.mul(G1.gen, ic), G2.mul(G2.gen, crs.gamma)),
         (C, G2.mul(G2.gen, crs.delta))],
        family,
    )
    return lhs == rhs
