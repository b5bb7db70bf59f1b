"""Copy of zksaas_tpu/pss/gao.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python); a word with too
many errors raises ValueError here.

Gao Reed-Solomon decoding (reference: secret-sharing/src/gao.rs).

Error-correcting decode of a share vector: treat the n shares as a GRS
codeword, run the partial extended Euclidean algorithm against the
share domain's vanishing polynomial until the remainder degree drops
below (n + k)/2, then divide (gao.rs:11-84; both are ports of
SageMath's GRS decoder).  Like the reference, this is available for
malicious-share recovery but is not wired into the hot path (dropouts
use lagrange_unpack).

xgcd is inherently sequential over tiny (<= n-length) polynomials, so
it runs on the host with Python ints: a device has nothing to contribute
at n <= 64 (SURVEY §7 step 4)."""

from __future__ import annotations

from ..fields.spec import FieldSpec
from ..ntt.ref import ifft_ref


def _deg(a: list[int]) -> int:
    for i in reversed(range(len(a))):
        if a[i]:
            return i
    return -1


def _trim(a: list[int]) -> list[int]:
    d = _deg(a)
    return a[: d + 1] if d >= 0 else [0]


def _poly_mul(a, b, p):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x:
            for j, y in enumerate(b):
                out[i + j] = (out[i + j] + x * y) % p
    return _trim(out)


def _poly_sub(a, b, p):
    n = max(len(a), len(b))
    a = a + [0] * (n - len(a))
    b = b + [0] * (n - len(b))
    return _trim([(x - y) % p for x, y in zip(a, b)])


def _poly_divmod(a, b, p):
    a = list(a)
    db, da = _deg(b), _deg(a)
    if da < db:
        return [0], _trim(a)
    inv_lead = pow(b[db], -1, p)
    q = [0] * (da - db + 1)
    for i in range(da - db, -1, -1):
        c = (a[i + db] * inv_lead) % p
        q[i] = c
        if c:
            for j in range(db + 1):
                a[i + j] = (a[i + j] - c * b[j]) % p
    return _trim(q), _trim(a)


def partial_xgcd(spec: FieldSpec, a: list[int], b: list[int], codelength: int, dimension: int):
    """Euclid on (a, b) until deg(remainder) < (n + k) / 2; returns
    (r, s) with r = a*s_prev + b*t_prev at the step before termination
    (gao.rs:11-45)."""
    p = spec.p
    stop = (dimension + codelength) // 2
    s, prev_s = [1], [0]
    r, prev_r = _trim(list(b)), _trim(list(a))
    while _deg(r) >= stop:
        q, _ = _poly_divmod(prev_r, r, p)
        r, prev_r = _poly_sub(prev_r, _poly_mul(q, r, p), p), r
        s, prev_s = _poly_sub(prev_s, _poly_mul(q, s, p), p), s
    return r, s


def decode_to_message(
    spec: FieldSpec, received_code: list[int], codelength: int, dimension: int
) -> list[int]:
    """Decode a (possibly corrupted) share vector back to the message
    polynomial coefficients (gao.rs:47-84).  The share domain is the
    radix-2 domain of size len(received_code)."""
    p = spec.p
    n = len(received_code)
    # interpolate the received word on the share domain
    r_poly = _trim(ifft_ref(spec, received_code))
    # vanishing polynomial x^n - 1
    z = [(-1) % p] + [0] * (n - 1) + [1]
    q1, q0 = partial_xgcd(spec, z, r_poly, codelength, dimension)
    h, rem = _poly_divmod(q1, q0, p)
    if _deg(rem) >= 0:
        raise ValueError("Gao decoding failed (too many errors)")
    return h
