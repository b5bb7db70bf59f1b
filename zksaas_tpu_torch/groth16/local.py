"""Copy of zksaas_tpu/groth16/local.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python).

Host Groth16 oracle: circuit-specific setup, single-machine prover,
and pairing verification.

Stand-in for ark-groth16 (the reference delegates exactly these three
jobs to arkworks: setup at groth16/examples/sha256.rs:172-174, the
ground-truth proof at :191-199, verification at :389-415).  Algorithms
follow ark-groth16's generator/prover/verifier including the
CircomReduction variant of the witness map and h_query (ark-groth16
r1cs_to_qap.rs), so the distributed prover can be asserted bit-exact
against `local_prove` with the same (r, s).

Everything here is Python big-int math on the host — key generation and
verification are off the TPU hot path by design.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..circom.r1cs import R1CS
from ..curves import ref as cref
from ..fields.spec import FieldSpec
from ..ntt.ref import fft_ref, ifft_ref


def _domain_size(n: int) -> int:
    s = 1
    while s < n:
        s *= 2
    return s


# curve family from the scalar field of the constraint system
_FAMILY_BY_FR = {
    "bn254_fr": "bn254",
    "bls12_381_fr": "bls12_381",
    "bls12_377_fr": "bls12_377",
}


def curve_family(spec: FieldSpec) -> str:
    return _FAMILY_BY_FR[spec.name]


def curve_refs(spec: FieldSpec):
    """(G1, G2, family) host oracles for a scalar-field spec."""
    fam = curve_family(spec)
    return cref.CURVES[f"{fam}_g1"], cref.CURVES[f"{fam}_g2"], fam


def qap_evals(r1cs: R1CS, z: list[int]) -> tuple[list[int], list[int], list[int], int]:
    """Evaluate per-constraint <A_i,z>, <B_i,z>, and c = a*b over the
    constraint domain, circom-reduction style: instance variables are
    appended as extra rows after the constraints (reference qap(),
    groth16/src/qap.rs:42-89)."""
    p = r1cs.spec.p
    m = _domain_size(r1cs.num_constraints + r1cs.num_instance)
    a = [0] * m
    b = [0] * m
    for i in range(r1cs.num_constraints):
        a[i] = r1cs.eval_lc(r1cs.a[i], z)
        b[i] = r1cs.eval_lc(r1cs.b[i], z)
    for i in range(r1cs.num_instance):
        a[r1cs.num_constraints + i] = z[i]
    c = [(x * y) % p for x, y in zip(a, b)]
    return a, b, c, m


def _lagrange_coeffs_at(spec: FieldSpec, m: int, tau: int) -> list[int]:
    """L_i(tau) for the size-m radix-2 domain (u_i in ark-poly's
    evaluate_all_lagrange_coefficients)."""
    p = spec.p
    g = spec.root_of_unity(m)
    zt = (pow(tau, m, p) - 1) % p
    m_inv = pow(m, -1, p)
    out = []
    gi = 1
    if zt == 0:
        # tau on the domain: indicator vector
        for i in range(m):
            out.append(1 if pow(g, i, p) == tau % p else 0)
        return out
    for i in range(m):
        # L_i(tau) = (g^i / m) * Z(tau) / (tau - g^i)
        out.append(zt * gi % p * m_inv % p * pow((tau - gi) % p, -1, p) % p)
        gi = gi * g % p
    return out


@dataclass
class Groth16Keys:
    """Proving + verifying key (affine host points, arkworks layout)."""

    spec: FieldSpec
    reduction: str  # "circom" | "libsnark"
    # vk
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list
    # pk extras
    beta_g1: tuple
    delta_g1: tuple
    a_query: list
    b_g1_query: list
    b_g2_query: list
    h_query: list
    l_query: list


@dataclass
class Proof:
    a: tuple
    b: tuple
    c: tuple


def setup(r1cs: R1CS, rng: random.Random, reduction: str = "circom") -> Groth16Keys:
    """Circuit-specific setup (ark-groth16 generator.rs semantics)."""
    spec = r1cs.spec
    p = spec.p
    G1, G2, _ = curve_refs(spec)
    m = _domain_size(r1cs.num_constraints + r1cs.num_instance)

    alpha = rng.randrange(1, p)
    beta = rng.randrange(1, p)
    gamma = rng.randrange(1, p)
    delta = rng.randrange(1, p)
    tau = rng.randrange(1, p)

    u = _lagrange_coeffs_at(spec, m, tau)
    nv = r1cs.num_vars
    a_t = [0] * nv
    b_t = [0] * nv
    c_t = [0] * nv
    for r in range(r1cs.num_constraints):
        for coeff, v in r1cs.a[r]:
            a_t[v] = (a_t[v] + coeff * u[r]) % p
        for coeff, v in r1cs.b[r]:
            b_t[v] = (b_t[v] + coeff * u[r]) % p
        for coeff, v in r1cs.c[r]:
            c_t[v] = (c_t[v] + coeff * u[r]) % p
    # instance rows appended after constraints (the circom/arkworks
    # instance map; generator.rs + qap.rs:67-71)
    for i in range(r1cs.num_instance):
        a_t[i] = (a_t[i] + u[r1cs.num_constraints + i]) % p

    zt = (pow(tau, m, p) - 1) % p
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)

    gamma_abc = [
        (beta * a_t[i] + alpha * b_t[i] + c_t[i]) * gamma_inv % p
        for i in range(r1cs.num_instance)
    ]
    l_scalars = [
        (beta * a_t[i] + alpha * b_t[i] + c_t[i]) * delta_inv % p
        for i in range(r1cs.num_instance, nv)
    ]

    if reduction == "libsnark":
        h_scalars = [zt * delta_inv % p * pow(tau, i, p) % p for i in range(m - 1)]
    elif reduction == "circom":
        # ark-groth16 CircomReduction::h_query_scalars: delta_inv * tau^i
        # for i in 0..2(m-1)+1, ifft over the doubled domain, odd coeffs
        max_power = m - 1
        scal = [delta_inv * pow(tau, i, p) % p for i in range(2 * max_power + 1)]
        d2 = _domain_size(len(scal))
        scal = scal + [0] * (d2 - len(scal))
        coeffs = ifft_ref(spec, scal)
        h_scalars = coeffs[1::2]
    else:
        raise ValueError(reduction)

    def g1(x):
        return G1.mul(G1.gen, x)

    def g2(x):
        return G2.mul(G2.gen, x)

    return Groth16Keys(
        spec=spec,
        reduction=reduction,
        alpha_g1=g1(alpha),
        beta_g2=g2(beta),
        gamma_g2=g2(gamma),
        delta_g2=g2(delta),
        gamma_abc_g1=[g1(x) for x in gamma_abc],
        beta_g1=g1(beta),
        delta_g1=g1(delta),
        a_query=[g1(x) for x in a_t],
        b_g1_query=[g1(x) for x in b_t],
        b_g2_query=[g2(x) for x in b_t],
        h_query=[g1(x) for x in h_scalars],
        l_query=[g1(x) for x in l_scalars],
    )


def witness_map(r1cs: R1CS, z: list[int], reduction: str = "circom") -> list[int]:
    """The h vector the prover MSMs against h_query.

    circom (ark-circom CircomReduction::witness_map, mirrored by the
    reference's circom_h at groth16/src/ext_wit.rs:104-181): evaluate
    a, b, c on the 'odd' double-domain coset, h = a*b - c there.
    libsnark: coefficients of (ab - c)/Z from the coset FFT pipeline
    (ext_wit.rs:14-102)."""
    spec = r1cs.spec
    p = spec.p
    a, b, c, m = qap_evals(r1cs, z)
    if reduction == "circom":
        root2m = spec.root_of_unity(2 * m)
        ac = ifft_ref(spec, a)
        bc = ifft_ref(spec, b)
        cc = ifft_ref(spec, c)
        ac = [x * pow(root2m, i, p) % p for i, x in enumerate(ac)]
        bc = [x * pow(root2m, i, p) % p for i, x in enumerate(bc)]
        cc = [x * pow(root2m, i, p) % p for i, x in enumerate(cc)]
        ae = fft_ref(spec, ac)
        be = fft_ref(spec, bc)
        ce = fft_ref(spec, cc)
        return [(x * y - w) % p for x, y, w in zip(ae, be, ce)]
    elif reduction == "libsnark":
        g = spec.generator
        ac = ifft_ref(spec, a)
        bc = ifft_ref(spec, b)
        cc = ifft_ref(spec, c)
        ae = fft_ref(spec, ac, offset=g)
        be = fft_ref(spec, bc, offset=g)
        ce = fft_ref(spec, cc, offset=g)
        zinv = pow((pow(g, m, p) - 1) % p, -1, p)
        he = [(x * y - w) * zinv % p for x, y, w in zip(ae, be, ce)]
        hc = ifft_ref(spec, he, offset=g)
        return hc[: m - 1]
    raise ValueError(reduction)


def local_prove(keys: Groth16Keys, r1cs: R1CS, z: list[int], r: int, s: int) -> Proof:
    """Deterministic prover given (r, s) — the ground truth the
    distributed prover must match bit-for-bit
    (create_proof_with_reduction_and_matrices, sha256.rs:191-199)."""
    p = keys.spec.p
    G1, G2, _ = curve_refs(keys.spec)
    h = witness_map(r1cs, z, keys.reduction)

    ni = r1cs.num_instance
    assignment = z  # full, variable 0 = 1

    # A = alpha + sum a_i A_i + r delta
    A = G1.add(keys.alpha_g1, G1.msm(keys.a_query, assignment))
    A = G1.add(A, G1.mul(keys.delta_g1, r))

    # B (G2) and B (G1)
    B2 = G2.add(keys.beta_g2, G2.msm(keys.b_g2_query, assignment))
    B2 = G2.add(B2, G2.mul(keys.delta_g2, s))
    B1 = G1.add(keys.beta_g1, G1.msm(keys.b_g1_query, assignment))
    B1 = G1.add(B1, G1.mul(keys.delta_g1, s))

    # C = l_query . aux + h_query . h + s A + r B1 - r s delta
    C = G1.msm(keys.l_query, assignment[ni:])
    C = G1.add(C, G1.msm(keys.h_query, h))
    C = G1.add(C, G1.mul(A, s))
    C = G1.add(C, G1.mul(B1, r))
    C = G1.add(C, G1.neg(G1.mul(keys.delta_g1, r * s % p)))
    return Proof(a=A, b=B2, c=C)


def verify(keys: Groth16Keys, public_inputs: list[int], proof: Proof) -> bool:
    """e(A,B) == e(alpha,beta) e(acc_gamma, gamma) e(C, delta)."""
    G1, _, family = curve_refs(keys.spec)
    acc = keys.gamma_abc_g1[0]
    for x, pt in zip(public_inputs, keys.gamma_abc_g1[1:]):
        acc = G1.add(acc, G1.mul(pt, x))
    lhs = cref.pairing(proof.a, proof.b, family)
    rhs = cref.multi_pairing(
        [
            (keys.alpha_g1, keys.beta_g2),
            (acc, keys.gamma_g2),
            (proof.c, keys.delta_g2),
        ],
        family,
    )
    return lhs == rhs
