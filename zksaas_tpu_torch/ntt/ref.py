"""Copy of zksaas_tpu/ntt/ref.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python).

Host big-int radix-2 NTT oracle.

Used only as a correctness oracle for the device NTT and in the CPU
Groth16 reference prover (the stand-in for arkworks ark-poly's
Radix2EvaluationDomain, reference usage at secret-sharing/src/pss.rs:44-52
and groth16/src/ext_wit.rs)."""

from __future__ import annotations

from ..fields.spec import FieldSpec


def _fft_int(vals: list[int], g: int, p: int) -> list[int]:
    """In-order DFT: out[i] = sum_j vals[j] g^(ij), iterative Cooley-Tukey."""
    n = len(vals)
    assert n & (n - 1) == 0
    if n == 1:
        return list(vals)
    x = list(vals)
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            x[i], x[j] = x[j], x[i]
    m = 1
    while m < n:
        w_m = pow(g, n // (2 * m), p)
        for k in range(0, n, 2 * m):
            w = 1
            for jj in range(m):
                u = x[k + jj]
                v = (x[k + jj + m] * w) % p
                x[k + jj] = (u + v) % p
                x[k + jj + m] = (u - v) % p
                w = (w * w_m) % p
        m *= 2
    return x


def fft_ref(spec: FieldSpec, coeffs: list[int], offset: int = 1) -> list[int]:
    """Evaluations of the polynomial at offset * g^i (arkworks coset fft)."""
    n = len(coeffs)
    g = spec.root_of_unity(n)
    if offset != 1:
        coeffs = [(c * pow(offset, i, spec.p)) % spec.p for i, c in enumerate(coeffs)]
    return _fft_int(coeffs, g, spec.p)


def ifft_ref(spec: FieldSpec, evals: list[int], offset: int = 1) -> list[int]:
    """Inverse of fft_ref (arkworks coset ifft)."""
    n = len(evals)
    p = spec.p
    g_inv = pow(spec.root_of_unity(n), -1, p)
    n_inv = pow(n, -1, p)
    coeffs = [(c * n_inv) % p for c in _fft_int(evals, g_inv, p)]
    if offset != 1:
        oinv = pow(offset, -1, p)
        coeffs = [(c * pow(oinv, i, p)) % p for i, c in enumerate(coeffs)]
    return coeffs
