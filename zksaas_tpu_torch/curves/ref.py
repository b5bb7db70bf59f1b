"""Copy of zksaas_tpu/curves/ref.py from the JAX package, kept in the port so
that it imports nothing of that package (host-only Python).

Host big-int elliptic-curve + pairing oracle.

The stand-in for arkworks ark-ec/ark-bn254 used by the reference for
setup and verification (groth16/examples/sha256.rs:172-174, :389-415) —
pairings are off the hot path there too, so a CPU oracle is the right
altitude.  Affine coordinates, Python ints; Fp2 as (c0, c1) with
u^2 = -1; Fp12 as Fp[w]/(w^12 - 18 w^6 + 82) for the BN254 pairing
(polynomial-basis construction, same as the widely-used py_ecc layout).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.spec import (
    BLS12_377_FQ,
    BLS12_377_FR,
    BLS12_381_FQ,
    BLS12_381_FR,
    BN254_FQ,
    BN254_FR,
    FieldSpec,
)

# ---------------------------------------------------------------------------
# generic short-Weierstrass affine arithmetic over Fp or Fp2
# y^2 = x^3 + a x + b ;  None = point at infinity
# ---------------------------------------------------------------------------


class Coord:
    """Coordinate arithmetic: plain ints mod p."""

    def __init__(self, p: int):
        self.p = p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def muli(self, a, c: int):
        return (a * c) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def neg(self, a):
        return (-a) % self.p

    zero = 0
    one = 1

    def is_zero(self, a):
        return a == 0

    def eq(self, a, b):
        return a % self.p == b % self.p


class Coord2:
    """Fp2 = Fp[u]/(u^2 - nr): elements are (c0, c1) tuples.

    nr = -1 for BN254/BLS12-381; BLS12-377 builds its tower with
    nr = -5 (arkworks Fp2Config::NONRESIDUE)."""

    def __init__(self, p: int, nr: int = -1):
        self.p = p
        self.nr = nr
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul(self, a, b):
        p = self.p
        t0 = a[0] * b[0]
        t1 = a[1] * b[1]
        t2 = (a[0] + a[1]) * (b[0] + b[1])
        return ((t0 + self.nr * t1) % p, (t2 - t0 - t1) % p)

    def muli(self, a, c: int):
        return ((a[0] * c) % self.p, (a[1] * c) % self.p)

    def inv(self, a):
        p = self.p
        norm = (a[0] * a[0] - self.nr * a[1] * a[1]) % p
        ninv = pow(norm, -1, p)
        return ((a[0] * ninv) % p, (-a[1] * ninv) % p)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)

    def is_zero(self, a):
        return a[0] % self.p == 0 and a[1] % self.p == 0

    def eq(self, a, b):
        return a[0] % self.p == b[0] % self.p and a[1] % self.p == b[1] % self.p


@dataclass(frozen=True)
class CurveRef:
    """One short-Weierstrass group (affine, host ints)."""

    name: str
    K: object  # Coord or Coord2
    a: object
    b: object
    gen: tuple  # (x, y) of the subgroup generator
    order: int  # subgroup order r

    def on_curve(self, P) -> bool:
        if P is None:
            return True
        x, y = P
        K = self.K
        lhs = K.mul(y, y)
        rhs = K.add(K.add(K.mul(K.mul(x, x), x), K.mul(self.a, x)), self.b)
        return K.eq(lhs, rhs)

    def add(self, P, Q):
        K = self.K
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if K.eq(x1, x2):
            if K.eq(y1, y2):
                if K.is_zero(y1):
                    return None
                # doubling
                num = K.add(K.muli(K.mul(x1, x1), 3), self.a)
                den = K.muli(y1, 2)
            else:
                return None
        else:
            num = K.sub(y2, y1)
            den = K.sub(x2, x1)
        lam = K.mul(num, K.inv(den))
        x3 = K.sub(K.sub(K.mul(lam, lam), x1), x2)
        y3 = K.sub(K.mul(lam, K.sub(x1, x3)), y1)
        return (x3, y3)

    def neg(self, P):
        if P is None:
            return None
        return (P[0], self.K.neg(P[1]))

    def mul(self, P, k: int):
        k %= self.order
        acc = None
        add = P
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc

    def msm(self, points, scalars) -> object:
        acc = None
        for P, s in zip(points, scalars):
            acc = self.add(acc, self.mul(P, s))
        return acc

    def rand(self, rng) -> tuple:
        return self.mul(self.gen, rng.randrange(1, self.order))


# ---------------------------------------------------------------------------
# concrete curves
# ---------------------------------------------------------------------------

_bn_p = BN254_FQ.p
_bn_r = BN254_FR.p

BN254_G1 = CurveRef(
    name="bn254_g1",
    K=Coord(_bn_p),
    a=0,
    b=3,
    gen=(1, 2),
    order=_bn_r,
)

# G2 generator coordinates are the standard EIP-197 values (c0 real part
# listed second there; here tuples are (c0, c1)).
BN254_G2 = CurveRef(
    name="bn254_g2",
    K=Coord2(_bn_p),
    a=(0, 0),
    b=Coord2(_bn_p).mul((3, 0), Coord2(_bn_p).inv((9, 1))),  # 3 / (9 + u)
    gen=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
    order=_bn_r,
)

_bls_p = BLS12_381_FQ.p
_bls_r = BLS12_381_FR.p

BLS12_381_G1 = CurveRef(
    name="bls12_381_g1",
    K=Coord(_bls_p),
    a=0,
    b=4,
    gen=(
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ),
    order=_bls_r,
)

_b377_p = BLS12_377_FQ.p
_b377_r = BLS12_377_FR.p

BLS12_377_G1 = CurveRef(
    name="bls12_377_g1",
    K=Coord(_b377_p),
    a=0,
    b=1,
    gen=(
        0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
        0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    ),
    order=_b377_r,
)

# G2 groups on the sextic twists.  Twist equations and subgroup
# generators are derived + verified from the BLS family parameter x by
# scripts/derive_g2.py (r = x^4-x^2+1, q = ((x-1)^2 r)/3 + x, twist
# order via the trace identities, generator by cofactor clearing).
# BLS12-381 uses the standard spec generator (verified on-curve with
# order r by the same script); BLS12-377's generator is our
# deterministic derived one (same subgroup as arkworks').
BLS12_381_G2 = CurveRef(
    name="bls12_381_g2",
    K=Coord2(_bls_p),
    a=(0, 0),
    b=(4, 4),  # M-twist: b * (1 + u)
    gen=(
        (
            0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
            0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
        ),
        (
            0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
            0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
        ),
    ),
    order=_bls_r,
)

BLS12_377_G2 = CurveRef(
    name="bls12_377_g2",
    K=Coord2(_b377_p, nr=-5),
    a=(0, 0),
    b=(0, pow(5, -1, _b377_p) * (_b377_p - 1) % _b377_p),  # D-twist: b / u = -u/5
    gen=(
        (
            39292833563790338514455678255839969442444299076493345799525535236324569704972737101027043002275594504529645125033,
            97668274349181098911216378040700666521757961257997861327997265570326738925466145318868002777904267769221513117576,
        ),
        (
            245994257517657523171405884474647188067285204768246772529216161539930069107591277111081140518594262108675661622819,
            174231680960632680395570731097190109725774571769655017475028422391967989708646134812133505559105641519841883619409,
        ),
    ),
    order=_b377_r,
)

CURVES = {
    c.name: c
    for c in (
        BN254_G1,
        BN254_G2,
        BLS12_381_G1,
        BLS12_381_G2,
        BLS12_377_G1,
        BLS12_377_G2,
    )
}


# ---------------------------------------------------------------------------
# Pairings (host oracle), parameterized over BN254 / BLS12-381 / BLS12-377
#
# Fp12 in one polynomial basis Fp[w]/(w^12 - c6 w^6 - c0) per curve, with
# the Fp2 unit u = w^6 - s:
#   BN254:      w^12 = 18 w^6 - 82,  u = w^6 - 9   (D-twist, xi = 9 + u)
#   BLS12-381:  w^12 =  2 w^6 -  2,  u = w^6 - 1   (M-twist, xi = 1 + u)
#   BLS12-377:  w^12 =        - 5,   u = w^6       (D-twist, xi = u)
# BN uses the ate loop 6x+2 plus two Frobenius lines; BLS uses the plain
# x-loop (f inverted for negative x).  Final exponentiation is the full
# (p^12 - 1)/r power -- slow but exact; pairings are off the hot path
# (groth16/examples/sha256.rs:389-415 verifies host-side too).
# ---------------------------------------------------------------------------


def _make_fq12(p: int, c6: int, c0: int):
    """Fp12 class in polynomial basis for w^12 = c6 w^6 + c0."""

    class FQ12:
        __slots__ = ("c",)

        def __init__(self, coeffs):
            assert len(coeffs) == 12
            self.c = [x % p for x in coeffs]

        @classmethod
        def one(cls):
            return cls([1] + [0] * 11)

        @classmethod
        def zero(cls):
            return cls([0] * 12)

        def __eq__(self, other):
            return self.c == other.c

        def __add__(self, other):
            return FQ12([a + b for a, b in zip(self.c, other.c)])

        def __sub__(self, other):
            return FQ12([a - b for a, b in zip(self.c, other.c)])

        def __mul__(self, other):
            if isinstance(other, int):
                return FQ12([a * other for a in self.c])
            t = [0] * 23
            for i, a in enumerate(self.c):
                if a:
                    for j, b in enumerate(other.c):
                        t[i + j] += a * b
            for i in range(22, 11, -1):
                top = t[i] % p
                if top:
                    t[i - 6] += c6 * top
                    t[i - 12] += c0 * top
                t[i] = 0
            return FQ12(t[:12])

        def __pow__(self, e: int):
            res = FQ12.one()
            base = self
            while e:
                if e & 1:
                    res = res * base
                base = base * base
                e >>= 1
            return res

        def inv(self):
            # extended Euclid over Fp[w] against the modulus polynomial
            mod = [(-c0) % p] + [0] * 5 + [(-c6) % p] + [0] * 5
            lm, hm = [1] + [0] * 12, [0] * 13
            low = self.c + [0]
            high = mod + [1]

            def deg(poly):
                for i in reversed(range(len(poly))):
                    if poly[i] % p:
                        return i
                return 0

            def poly_rounded_div(a, b):
                dega, degb = deg(a), deg(b)
                temp = [x for x in a]
                o = [0] * len(a)
                for i in range(dega - degb, -1, -1):
                    q = (temp[degb + i] * pow(b[degb], -1, p)) % p
                    o[i] = (o[i] + q) % p
                    for c in range(degb + 1):
                        temp[c + i] = (temp[c + i] - q * b[c]) % p
                return [x % p for x in o]

            while deg(low):
                r = poly_rounded_div(high, low)
                r += [0] * (13 - len(r))
                nm = [x for x in hm]
                new = [x for x in high]
                for i in range(13):
                    for j in range(13 - i):
                        nm[i + j] = (nm[i + j] - lm[i] * r[j]) % p
                        new[i + j] = (new[i + j] - low[i] * r[j]) % p
                lm, low, hm, high = nm, new, lm, low
            c0inv = pow(low[0], -1, p)
            return FQ12([(x * c0inv) % p for x in lm[:12]])

        def __truediv__(self, other):
            return self * other.inv()

    return FQ12


def _fq12_double(pt):
    x, y = pt
    lam = x * x * 3 / (y * 2)
    nx = lam * lam - x * 2
    return (nx, lam * (x - nx) - y)


def _fq12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _fq12_double(p1)
    if x1 == x2:
        return None
    lam = (y2 - y1) / (x2 - x1)
    nx = lam * lam - x1 - x2
    return (nx, lam * (x1 - nx) - y1)


def _linefunc(P1, P2, T):
    x1, y1 = P1
    x2, y2 = P2
    xt, yt = T
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = x1 * x1 * 3 / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


class PairingCtx:
    """Ate pairing machinery for one curve family."""

    def __init__(self, p, r, c6, c0, basis_s, loop, bn_frobenius, x_neg, m_twist):
        self.p = p
        self.FQ12 = _make_fq12(p, c6, c0)
        self.basis_s = basis_s
        self.loop = loop
        self.bn_frobenius = bn_frobenius
        self.x_neg = x_neg
        self.final_exp = (p**12 - 1) // r
        W = self.FQ12([0, 1] + [0] * 10)
        W2, W3 = W * W, W * W * W
        # D-twist untwists by multiplying with w^2/w^3, M-twist by dividing
        self._tw2 = W2 if not m_twist else W2.inv()
        self._tw3 = W3 if not m_twist else W3.inv()

    def _twist(self, Q):
        if Q is None:
            return None
        (x0, x1), (y0, y1) = Q
        s, p = self.basis_s, self.p
        xc = [(x0 - s * x1) % p, x1]
        yc = [(y0 - s * y1) % p, y1]
        nx = self.FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
        ny = self.FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
        return (nx * self._tw2, ny * self._tw3)

    def _cast_g1(self, P):
        if P is None:
            return None
        return (self.FQ12([P[0]] + [0] * 11), self.FQ12([P[1]] + [0] * 11))

    def miller_loop(self, Q, P):
        FQ12 = self.FQ12
        if Q is None or P is None:
            return FQ12.one()
        R = Q
        f = FQ12.one()
        loop = self.loop
        for b in reversed(range(loop.bit_length() - 1)):
            f = f * f * _linefunc(R, R, P)
            R = _fq12_double(R)
            if loop & (1 << b):
                f = f * _linefunc(R, Q, P)
                R = _fq12_add(R, Q)
        if self.bn_frobenius:
            p = self.p
            Q1 = (Q[0] ** p, Q[1] ** p)
            nQ2 = (Q1[0] ** p, (FQ12.zero() - Q1[1]) ** p)
            f = f * _linefunc(R, Q1, P)
            R = _fq12_add(R, Q1)
            f = f * _linefunc(R, nQ2, P)
        if self.x_neg:
            f = f.inv()
        return f

    def pairing(self, P, Q):
        """Full pairing e(P in G1, Q in G2) -> FQ12 (unity subgroup)."""
        if P is None or Q is None:
            return self.FQ12.one()
        return self.miller_loop(self._twist(Q), self._cast_g1(P)) ** self.final_exp

    def multi_pairing(self, pairs):
        """prod e(P_i, Q_i) with one shared final exponentiation."""
        f = self.FQ12.one()
        for P, Q in pairs:
            if P is None or Q is None:
                continue
            f = f * self.miller_loop(self._twist(Q), self._cast_g1(P))
        return f**self.final_exp


_BN_X = 4965661367192848881
_BLS381_X = 0xD201000000010000  # |x|; the BLS12-381 parameter is negative
_BLS377_X = 0x8508C00000000001

_CTXS = {
    "bn254": lambda: PairingCtx(
        _bn_p, _bn_r, 18, -82, 9, 6 * _BN_X + 2,
        bn_frobenius=True, x_neg=False, m_twist=False,
    ),
    "bls12_381": lambda: PairingCtx(
        _bls_p, _bls_r, 2, -2, 1, _BLS381_X,
        bn_frobenius=False, x_neg=True, m_twist=True,
    ),
    "bls12_377": lambda: PairingCtx(
        _b377_p, _b377_r, 0, -5, 0, _BLS377_X,
        bn_frobenius=False, x_neg=False, m_twist=False,
    ),
}
_ctx_cache: dict = {}


def pairing_ctx(family: str = "bn254") -> PairingCtx:
    if family not in _ctx_cache:
        _ctx_cache[family] = _CTXS[family]()
    return _ctx_cache[family]


# --- module-level API (family-selectable; BN254 default for back-compat) ---

FQ12 = pairing_ctx("bn254").FQ12


def pairing(P, Q, family: str = "bn254"):
    return pairing_ctx(family).pairing(P, Q)


def multi_pairing(pairs, family: str = "bn254"):
    return pairing_ctx(family).multi_pairing(pairs)
