"""Rank-1 constraint systems as the benchmark makes them: plain lists.

A frozen copy of the port's ConstraintBuilder (zksaas_tpu_torch/circom/
r1cs.py), kept here so that the circuits the benchmark proves, and the
reference that checks the proofs, depend on nothing of the program under
test.  The harness hands a Circuit to the program as the program's own
R1CS type.

Variables follow arkworks' order: 0 is the constant one, then the public
inputs, then the witness.  A constraint is three linear combinations
(A, B, C), lists of (coefficient, variable), meaning <A,z> * <B,z> = <C,z>.
"""

from __future__ import annotations

from dataclasses import dataclass

LC = list[tuple[int, int]]


@dataclass
class Circuit:
    p: int  # the scalar field's modulus
    num_instance: int  # the constant one and the public inputs
    num_witness: int
    a: list[LC]
    b: list[LC]
    c: list[LC]
    z: list[int]  # the full assignment [1, public..., witness...]

    @property
    def num_constraints(self) -> int:
        return len(self.a)

    @property
    def num_vars(self) -> int:
        return self.num_instance + self.num_witness

    @property
    def public(self) -> list[int]:
        return self.z[1 : self.num_instance]

    def is_satisfied(self) -> bool:
        p, z = self.p, self.z

        def ev(lc):
            return sum(c * z[i] for c, i in lc) % p

        return all((ev(ra) * ev(rb) - ev(rc)) % p == 0
                   for ra, rb, rc in zip(self.a, self.b, self.c))


class ConstraintBuilder:
    """Circuit synthesis: public inputs and witnesses are allocated with
    their values, constraints reference them by temporary ids (0 the
    constant one, -(k+1) public input k, k+1 witness k) that `finalize`
    maps to arkworks' order."""

    def __init__(self, p: int):
        self.p = p
        self.pub: list[int] = []
        self.wit: list[int] = []
        self._constraints: list[tuple[LC, LC, LC]] = []

    def pub_input(self, value: int) -> int:
        self.pub.append(value % self.p)
        return -len(self.pub)

    def witness(self, value: int) -> int:
        self.wit.append(value % self.p)
        return len(self.wit)

    def constrain(self, a: LC, b: LC, c: LC) -> None:
        self._constraints.append((a, b, c))

    def mul(self, x: int, y: int) -> int:
        """Allocate z = x * y with its constraint."""
        z = self.witness(self._val(x) * self._val(y) % self.p)
        self.constrain([(1, x)], [(1, y)], [(1, z)])
        return z

    def _val(self, vid: int) -> int:
        if vid == 0:
            return 1
        if vid < 0:
            return self.pub[-vid - 1]
        return self.wit[vid - 1]

    def finalize(self) -> Circuit:
        ni = 1 + len(self.pub)
        p = self.p

        def remap(vid: int) -> int:
            if vid == 0:
                return 0
            if vid < 0:
                return -vid
            return ni + vid - 1

        a, b, c = [], [], []
        for ra, rb, rc in self._constraints:
            a.append([(co % p, remap(v)) for co, v in ra])
            b.append([(co % p, remap(v)) for co, v in rb])
            c.append([(co % p, remap(v)) for co, v in rc])
        circuit = Circuit(p, ni, len(self.wit), a, b, c, [1] + self.pub + self.wit)
        if not circuit.is_satisfied():
            raise ValueError("the synthesised circuit is not satisfied by its witness")
        return circuit
