"""Copy of zksaas_tpu/utils/serial.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python); malformed bytes
raise ValueError here.

Arkworks-compatible (de)serialization.

The reference moves every wire object through ark-serialize
CanonicalSerialize (mpc-net/src/ser_net.rs:24-25); for cross-stack
fixtures and client hand-off this module mirrors the formats:

* Field elements: little-endian bytes of the raw integer, padded to
  the limb width (32 bytes for 254/255-bit fields).
* Short-Weierstrass points, compressed: x only, with arkworks SWFlags
  in the top bits of the LAST byte — 0x40 = point at infinity, 0x80 =
  y is the lexicographically larger root.  Fp2 x-coordinates are
  serialized c0 || c1 with the flag on the final byte; Fp2 ordering
  compares c1 first (arkworks QuadExtField ordering).
* Groth16 proof = compressed A (G1) || B (G2) || C (G1).
"""

from __future__ import annotations

from ..curves import ref as cref
from ..fields.spec import FieldSpec

FLAG_INF = 0x40
FLAG_Y_LARGEST = 0x80


def _nbytes(p: int) -> int:
    return (p.bit_length() + 7) // 8


def fr_to_bytes(spec: FieldSpec, x: int) -> bytes:
    return (x % spec.p).to_bytes(_nbytes(spec.p), "little")


def fr_from_bytes(spec: FieldSpec, data: bytes) -> int:
    v = int.from_bytes(data, "little")
    if v >= spec.p:
        raise ValueError("non-canonical field element")
    return v


def _sqrt_fp(a: int, p: int):
    """Modular square root for p = 3 mod 4; None if non-residue."""
    assert p % 4 == 3
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


def _sqrt_fp2(a, p):
    """Square root in Fp2 = Fp[u]/(u^2+1) (complex method)."""
    a0, a1 = a
    if a1 % p == 0:
        r = _sqrt_fp(a0, p)
        if r is not None:
            return (r, 0)
        # sqrt(a0) = u * sqrt(-a0)
        r = _sqrt_fp(-a0 % p, p)
        return None if r is None else (0, r)
    norm = (a0 * a0 + a1 * a1) % p
    lam = _sqrt_fp(norm, p)
    if lam is None:
        return None
    two_inv = pow(2, -1, p)
    x0 = (a0 + lam) * two_inv % p
    c0 = _sqrt_fp(x0, p)
    if c0 is None:
        x0 = (a0 - lam) * two_inv % p
        c0 = _sqrt_fp(x0, p)
        if c0 is None:
            return None
    c1 = a1 * pow(2 * c0, -1, p) % p
    cand = (c0, c1)
    # verify
    chk = ((c0 * c0 - c1 * c1) % p, 2 * c0 * c1 % p)
    return cand if chk == (a0 % p, a1 % p) else None


def _fp2_gt(a, b, p) -> bool:
    """Arkworks QuadExtField ordering: compare c1, then c0."""
    if a[1] != b[1]:
        return a[1] > b[1]
    return a[0] > b[0]


def g1_to_bytes(curve: cref.CurveRef, P) -> bytes:
    p = curve.K.p
    nb = _nbytes(p)
    if P is None:
        return bytes(nb - 1) + bytes([FLAG_INF])
    x, y = P
    data = bytearray(x.to_bytes(nb, "little"))
    if y > (p - y) % p:
        data[-1] |= FLAG_Y_LARGEST
    return bytes(data)


def g1_from_bytes(curve: cref.CurveRef, data: bytes):
    p = curve.K.p
    flags = data[-1] & 0xC0
    if flags & FLAG_INF:
        return None
    x = int.from_bytes(bytes(data[:-1]) + bytes([data[-1] & 0x3F]), "little")
    rhs = (pow(x, 3, p) + curve.a * x + curve.b) % p
    y = _sqrt_fp(rhs, p)
    if y is None:
        raise ValueError("x not on curve")
    if (y > (p - y) % p) != bool(flags & FLAG_Y_LARGEST):
        y = (p - y) % p
    P = (x, y)
    if not curve.on_curve(P):
        raise ValueError("point not on curve")
    return P


def g2_to_bytes(curve: cref.CurveRef, P) -> bytes:
    p = curve.K.p
    nb = _nbytes(p)
    if P is None:
        return bytes(2 * nb - 1) + bytes([FLAG_INF])
    (x0, x1), y = P
    data = bytearray(x0.to_bytes(nb, "little") + x1.to_bytes(nb, "little"))
    ny = curve.K.neg(y)
    if _fp2_gt(y, ny, p):
        data[-1] |= FLAG_Y_LARGEST
    return bytes(data)


def g2_from_bytes(curve: cref.CurveRef, data: bytes):
    p = curve.K.p
    nb = _nbytes(p)
    flags = data[-1] & 0xC0
    if flags & FLAG_INF:
        return None
    x0 = int.from_bytes(data[:nb], "little")
    x1 = int.from_bytes(bytes(data[nb:-1]) + bytes([data[-1] & 0x3F]), "little")
    x = (x0, x1)
    K = curve.K
    rhs = K.add(K.mul(K.mul(x, x), x), curve.b)
    y = _sqrt_fp2(rhs, p)
    if y is None:
        raise ValueError("x not on curve")
    ny = K.neg(y)
    if _fp2_gt(y, ny, p) != bool(flags & FLAG_Y_LARGEST):
        y = ny
    P = (x, y)
    if not curve.on_curve(P):
        raise ValueError("point not on curve")
    return P


def proof_to_bytes(proof) -> bytes:
    """Groth16 proof (BN254): compressed a || b || c (32 + 64 + 32)."""
    return (
        g1_to_bytes(cref.BN254_G1, proof.a)
        + g2_to_bytes(cref.BN254_G2, proof.b)
        + g1_to_bytes(cref.BN254_G1, proof.c)
    )


def proof_from_bytes(data: bytes):
    from ..groth16.local import Proof

    nb = _nbytes(cref.BN254_G1.K.p)
    a = g1_from_bytes(cref.BN254_G1, data[:nb])
    b = g2_from_bytes(cref.BN254_G2, data[nb : 3 * nb])
    c = g1_from_bytes(cref.BN254_G1, data[3 * nb : 4 * nb])
    return Proof(a=a, b=b, c=c)
