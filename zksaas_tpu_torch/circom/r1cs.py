"""Copy of zksaas_tpu/circom/r1cs.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python).

R1CS structures, circom binary ingestion, and a circuit builder.

Replaces the reference's use of webb's ark-circom fork
(groth16/Cargo.toml:15; CircomConfig/CircomBuilder in
groth16/examples/sha256.rs:162-177):

* R1CS — sparse constraint matrices in arkworks ConstraintMatrices
  layout (rows of (coeff, var_index) pairs; variable 0 is the constant
  one; instance variables first, then witness).
* load_r1cs / load_wtns — parsers for circom's .r1cs and .wtns binary
  formats (the iden3 spec), so real circom artifacts can be proven.
* ConstraintBuilder — a small host-side circuit DSL to synthesize
  fixtures (the snapshot's sha256.r1cs blob is absent upstream, so
  fixtures are built natively; see fixtures/ for the SHA-256 circuit).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dfield

from ..fields.spec import BN254_FR, FieldSpec

LC = list[tuple[int, int]]  # linear combination: [(coeff, var_idx), ...]


@dataclass
class R1CS:
    spec: FieldSpec
    num_instance: int  # includes the constant-one variable (arkworks style)
    num_witness: int
    a: list[LC]
    b: list[LC]
    c: list[LC]

    @property
    def num_constraints(self) -> int:
        return len(self.a)

    @property
    def num_vars(self) -> int:
        return self.num_instance + self.num_witness

    def eval_lc(self, lc: LC, z: list[int]) -> int:
        return sum(c * z[i] for c, i in lc) % self.spec.p

    def is_satisfied(self, z: list[int]) -> bool:
        for ra, rb, rc in zip(self.a, self.b, self.c):
            if (
                self.eval_lc(ra, z) * self.eval_lc(rb, z) - self.eval_lc(rc, z)
            ) % self.spec.p != 0:
                return False
        return True


class ConstraintBuilder:
    """Host-side circuit synthesis (CircomBuilder stand-in).

    Variables: 0 = const one; public inputs allocated first, then
    witnesses.  Build constraints as (A, B, C) linear-combination
    triples meaning <A,z> * <B,z> = <C,z>."""

    def __init__(self, spec: FieldSpec = BN254_FR):
        self.spec = spec
        self.pub: list[int] = []  # values of public inputs
        self.wit: list[int] = []  # values of witnesses
        self._constraints: list[tuple[LC, LC, LC]] = []

    def pub_input(self, value: int) -> int:
        self.pub.append(value % self.spec.p)
        return -len(self.pub)  # temporary negative id, fixed in finalize

    def witness(self, value: int) -> int:
        self.wit.append(value % self.spec.p)
        return len(self.wit)  # temporary positive id

    def constrain(self, a: LC, b: LC, c: LC) -> None:
        """LC terms reference: 0 = const one, negative = public input
        -(k+1) -> k, positive = witness k+1 -> k."""
        self._constraints.append((a, b, c))

    def mul(self, x: int, y: int) -> int:
        """Convenience: allocate z = x*y with a constraint."""
        z = self.witness(self._val(x) * self._val(y) % self.spec.p)
        self.constrain([(1, x)], [(1, y)], [(1, z)])
        return z

    def _val(self, vid: int) -> int:
        if vid == 0:
            return 1
        if vid < 0:
            return self.pub[-vid - 1]
        return self.wit[vid - 1]

    def finalize(self) -> tuple[R1CS, list[int]]:
        """Returns (r1cs, full_assignment) with arkworks variable order:
        [1, pub..., wit...]."""
        ni = 1 + len(self.pub)

        def remap(vid: int) -> int:
            if vid == 0:
                return 0
            if vid < 0:
                return -vid  # public input k -> 1 + k
            return ni + vid - 1

        a, b, c = [], [], []
        for ra, rb, rc in self._constraints:
            a.append([(co % self.spec.p, remap(v)) for co, v in ra])
            b.append([(co % self.spec.p, remap(v)) for co, v in rb])
            c.append([(co % self.spec.p, remap(v)) for co, v in rc])
        r1cs = R1CS(self.spec, ni, len(self.wit), a, b, c)
        z = [1] + self.pub + self.wit
        assert r1cs.is_satisfied(z), "unsatisfied circuit"
        return r1cs, z


# ---------------------------------------------------------------------------
# circom binary formats (iden3 spec)
# ---------------------------------------------------------------------------


def _read_header(f, magic: bytes):
    assert f.read(4) == magic, f"bad magic, want {magic!r}"
    (version,) = struct.unpack("<I", f.read(4))
    (n_sections,) = struct.unpack("<I", f.read(4))
    sections = {}
    for _ in range(n_sections):
        (sec_type,) = struct.unpack("<I", f.read(4))
        (size,) = struct.unpack("<Q", f.read(8))
        pos = f.tell()
        sections.setdefault(sec_type, []).append((pos, size))
        f.seek(pos + size)
    return version, sections


def load_r1cs(path: str, spec: FieldSpec = BN254_FR) -> R1CS:
    """Parse a circom .r1cs file (the format ark-circom reads;
    reference ingestion at groth16/examples/sha256.rs:162-166).

    Note on variable ordering: circom wires are [1, pub_outputs,
    pub_inputs, prv_inputs, internal...] which matches arkworks'
    instance-then-witness split used here."""
    with open(path, "rb") as f:
        _, sections = _read_header(f, b"r1cs")
        # section 1: header
        pos, size = sections[1][0]
        f.seek(pos)
        (fs,) = struct.unpack("<I", f.read(4))
        prime = int.from_bytes(f.read(fs), "little")
        assert prime == spec.p, "r1cs prime != field spec"
        n_wires, n_pub_out, n_pub_in, n_prv_in, n_labels, n_constraints = struct.unpack(
            "<IIIIQI", f.read(28)
        )
        # section 2: constraints
        pos, size = sections[2][0]
        f.seek(pos)
        a, b, c = [], [], []
        for _ in range(n_constraints):
            rows = []
            for _k in range(3):
                (nterms,) = struct.unpack("<I", f.read(4))
                lc = []
                for _t in range(nterms):
                    (widx,) = struct.unpack("<I", f.read(4))
                    coeff = int.from_bytes(f.read(fs), "little")
                    lc.append((coeff, widx))
                rows.append(lc)
            a.append(rows[0])
            b.append(rows[1])
            c.append(rows[2])
        ni = 1 + n_pub_out + n_pub_in
        return R1CS(spec, ni, n_wires - ni, a, b, c)


def load_wtns(path: str, spec: FieldSpec = BN254_FR) -> list[int]:
    """Parse a circom .wtns witness file -> full assignment [1, ...]."""
    with open(path, "rb") as f:
        _, sections = _read_header(f, b"wtns")
        pos, _ = sections[1][0]
        f.seek(pos)
        (fs,) = struct.unpack("<I", f.read(4))
        prime = int.from_bytes(f.read(fs), "little")
        assert prime == spec.p
        (n,) = struct.unpack("<I", f.read(4))
        pos, _ = sections[2][0]
        f.seek(pos)
        return [int.from_bytes(f.read(fs), "little") for _ in range(n)]
