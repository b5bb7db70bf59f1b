// Field and point arithmetic shared by the CUDA kernels (kernels.cuh) and
// the g++ host build used by the CPU tests (host_core.cpp).
//
// Replaces the in-kernel limb library of the JAX package
// (zksaas_tpu/fields/kernel_lib.py::KernelField), the mixed add's point
// core of zksaas_tpu/curves/fused.py (_madd_core; the other cores are the
// grouped programs of add_group.cuh), its Fermat inverse (_finv_call) and
// the digit passes of the key sort (zksaas_tpu/fields/sortperm.py).
//
// An Fq element is NL little-endian 32-bit limbs in Montgomery form: NL = 8
// for BN254's Fq and every scalar field (256-bit), NL = 12 for the BLS12
// base fields (384-bit).  The tensors at the kernel boundary hold 2 NL
// 16-bit limbs per element (R = 2^(32 NL) either way), so limb pairs are
// packed on load and split on store.  Every function returns the canonical
// residue (< p), so results are bit-equal to the reference whatever the
// order of the carries.
//
// The coordinate rings are Fq (G1) and Fq2 = Fq[u]/(u^2 - nr) (G2) with
// nr = -1 (BN254, BLS12-381) or nr = -5 (BLS12-377).

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

namespace zk {

// p, Montgomery one (R mod p) and n0 = -p^-1 mod 2^32, set by the host.
template <int NL>
struct FieldParams {
    uint32_t p[NL];
    uint32_t one[NL];
    uint32_t n0;
};

template <int NL>
struct Fq {
    uint32_t v[NL];
};

template <int NL>
ZK_HD Fq<NL> fq_zero() {
    Fq<NL> r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = 0;
    return r;
}

template <int NL>
ZK_HD Fq<NL> fq_one(const FieldParams<NL>& F) {
    Fq<NL> r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = F.one[i];
    return r;
}

template <int NL>
ZK_HD bool fq_is_zero(const Fq<NL>& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) acc |= a.v[i];
    return acc == 0;
}

// s (with carry bit `top` above limb NL-1) reduced once by p; s < 2p.
template <int NL>
ZK_HD Fq<NL> fq_reduce_once(const Fq<NL>& s, uint32_t top, const FieldParams<NL>& F) {
    Fq<NL> d;
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t t = (uint64_t)s.v[i] - F.p[i] - br;
        d.v[i] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    return (top || !br) ? d : s;
}

template <int NL>
ZK_HD Fq<NL> fq_add(const Fq<NL>& a, const Fq<NL>& b, const FieldParams<NL>& F) {
    Fq<NL> s;
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
        s.v[i] = (uint32_t)t;
        c = (uint32_t)(t >> 32);
    }
    return fq_reduce_once(s, c, F);
}

template <int NL>
ZK_HD Fq<NL> fq_dbl(const Fq<NL>& a, const FieldParams<NL>& F) {
    return fq_add(a, a, F);
}

template <int NL>
ZK_HD Fq<NL> fq_sub(const Fq<NL>& a, const Fq<NL>& b, const FieldParams<NL>& F) {
    Fq<NL> d;
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t t = (uint64_t)a.v[i] - b.v[i] - br;
        d.v[i] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    if (br) {  // a < b: add p back (the carry out cancels the borrow)
        uint32_t c = 0;
#pragma unroll
        for (int i = 0; i < NL; i++) {
            uint64_t t = (uint64_t)d.v[i] + F.p[i] + c;
            d.v[i] = (uint32_t)t;
            c = (uint32_t)(t >> 32);
        }
    }
    return d;
}

// CIOS Montgomery product a*b*R^-1 mod p, R = 2^(32 NL).  Needs a*b < R p,
// which holds for canonical operands and for one raw operand < R times a
// canonical one (Field.rand reduces raw limbs that way).
template <int NL>
ZK_HD Fq<NL> fq_mul(const Fq<NL>& a, const Fq<NL>& b, const FieldParams<NL>& F) {
    uint32_t t[NL + 2];
#pragma unroll
    for (int i = 0; i < NL + 2; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t C = 0;
#pragma unroll
        for (int j = 0; j < NL; j++) {
            uint64_t uv = (uint64_t)a.v[j] * b.v[i] + t[j] + C;
            t[j] = (uint32_t)uv;
            C = uv >> 32;
        }
        uint64_t uv = (uint64_t)t[NL] + C;
        t[NL] = (uint32_t)uv;
        t[NL + 1] = (uint32_t)(uv >> 32);
        uint32_t m = t[0] * F.n0;
        uv = (uint64_t)m * F.p[0] + t[0];
        C = uv >> 32;
#pragma unroll
        for (int j = 1; j < NL; j++) {
            uv = (uint64_t)m * F.p[j] + t[j] + C;
            t[j - 1] = (uint32_t)uv;
            C = uv >> 32;
        }
        uv = (uint64_t)t[NL] + C;
        t[NL - 1] = (uint32_t)uv;
        t[NL] = t[NL + 1] + (uint32_t)(uv >> 32);
    }
    Fq<NL> r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = t[i];
    return fq_reduce_once(r, t[NL], F);
}

// Fermat inverse a^(p-2) (zksaas_tpu/curves/fused.py::_finv_call): left to
// right over the exponent bits below the top one, one square and, for a set
// bit, one product each.  The exponent is the same for every thread, so the
// branch never diverges.  0 maps to 0.
template <int NL>
ZK_HD Fq<NL> fq_inv(const Fq<NL>& a, const FieldParams<NL>& F) {
    uint32_t e[NL];
    uint32_t br = 2;
    for (int i = 0; i < NL; i++) {  // e = p - 2
        uint64_t t = (uint64_t)F.p[i] - br;
        e[i] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    int top = 32 * NL - 1;
    while (!((e[top >> 5] >> (top & 31)) & 1u)) top--;
    Fq<NL> acc = a;
    for (int i = top - 1; i >= 0; i--) {
        acc = fq_mul(acc, acc, F);
        if ((e[i >> 5] >> (i & 31)) & 1u) acc = fq_mul(acc, a, F);
    }
    return acc;
}

// ---------------------------------------------------------------------------
// coordinate rings: Fq (G1) and Fq2 = Fq[u]/(u^2 - nr) (G2)
// ---------------------------------------------------------------------------

template <int N>
struct RingFq {
    static constexpr int NL = N;
    static constexpr int NEG_NR = 1;  // no non-residue: Fq has one coordinate
    typedef Fq<N> E;
    typedef FieldParams<N> P;
    static constexpr int LIMBS16 = 2 * N;  // 16-bit limbs per coordinate
    static ZK_HD E add(const E& a, const E& b, const P& F) { return fq_add(a, b, F); }
    static ZK_HD E sub(const E& a, const E& b, const P& F) { return fq_sub(a, b, F); }
    static ZK_HD E dbl(const E& a, const P& F) { return fq_dbl(a, F); }
    static ZK_HD E mul(const E& a, const E& b, const P& F) { return fq_mul(a, b, F); }
    static ZK_HD E sqr(const E& a, const P& F) { return fq_mul(a, a, F); }
    static ZK_HD E inv(const E& a, const P& F) { return fq_inv(a, F); }
    static ZK_HD bool is_zero(const E& a) { return fq_is_zero(a); }
    static ZK_HD E one(const P& F) { return fq_one(F); }
    static ZK_HD E zero() { return fq_zero<N>(); }
};

template <int NL>
struct Fq2 {
    Fq<NL> c0, c1;
};

// Fq2 with u^2 = nr = -NR: NR = 1 for BN254 and BLS12-381, 5 for BLS12-377.
template <int N, int NR>
struct RingFq2 {
    static_assert(NR == 1 || NR == 5, "Fq2 is built for nr = -1 and nr = -5");
    static constexpr int NL = N;
    static constexpr int NEG_NR = NR;
    typedef Fq2<N> E;
    typedef FieldParams<N> P;
    static constexpr int LIMBS16 = 4 * N;
    static ZK_HD E add(const E& a, const E& b, const P& F) {
        return E{fq_add(a.c0, b.c0, F), fq_add(a.c1, b.c1, F)};
    }
    static ZK_HD E sub(const E& a, const E& b, const P& F) {
        return E{fq_sub(a.c0, b.c0, F), fq_sub(a.c1, b.c1, F)};
    }
    static ZK_HD E dbl(const E& a, const P& F) { return E{fq_dbl(a.c0, F), fq_dbl(a.c1, F)}; }
    // -nr * x: x itself, or 4x + x by doublings (fused.py's muli)
    static ZK_HD Fq<N> neg_nr(const Fq<N>& x, const P& F) {
        if constexpr (NR == 1) {
            return x;
        } else {
            return fq_add(fq_dbl(fq_dbl(x, F), F), x, F);
        }
    }
    // Karatsuba: (t0 + nr t1, (a0 + a1)(b0 + b1) - t0 - t1)
    static ZK_HD E mul(const E& a, const E& b, const P& F) {
        Fq<N> t0 = fq_mul(a.c0, b.c0, F);
        Fq<N> t1 = fq_mul(a.c1, b.c1, F);
        Fq<N> t2 = fq_mul(fq_add(a.c0, a.c1, F), fq_add(b.c0, b.c1, F), F);
        return E{fq_sub(t0, neg_nr(t1, F), F), fq_sub(fq_sub(t2, t0, F), t1, F)};
    }
    static ZK_HD E sqr(const E& a, const P& F) { return mul(a, a, F); }
    // through the norm: (c0 + c1 u)^-1 = (c0 - c1 u) / (c0^2 - nr c1^2)
    static ZK_HD E inv(const E& a, const P& F) {
        Fq<N> norm = fq_add(fq_mul(a.c0, a.c0, F), neg_nr(fq_mul(a.c1, a.c1, F), F), F);
        Fq<N> ninv = fq_inv(norm, F);
        return E{fq_mul(a.c0, ninv, F), fq_sub(fq_zero<N>(), fq_mul(a.c1, ninv, F), F)};
    }
    static ZK_HD bool is_zero(const E& a) { return fq_is_zero(a.c0) && fq_is_zero(a.c1); }
    static ZK_HD E one(const P& F) { return E{fq_one(F), fq_zero<N>()}; }
    static ZK_HD E zero() { return E{fq_zero<N>(), fq_zero<N>()}; }
};

// ---------------------------------------------------------------------------
// a = 0 Jacobian point formulas of the mixed add (zksaas_tpu/curves/
// fused.py::_madd_core, with ::_double_core for its P == Q case; the complete
// add, the k-fold double and the affine+affine add are the grouped programs
// of add_group.cuh); the special cases are branches here instead of selects
// ---------------------------------------------------------------------------

template <class R>
ZK_HD void pt_double(typename R::E& X, typename R::E& Y, typename R::E& Z,
                     const typename R::P& F) {
    typedef typename R::E E;
    E A = R::sqr(X, F);
    E B = R::sqr(Y, F);
    E C = R::sqr(B, F);
    E D = R::dbl(R::sub(R::sub(R::sqr(R::add(X, B, F), F), A, F), C, F), F);
    E E3 = R::add(R::dbl(A, F), A, F);
    E F2 = R::sqr(E3, F);
    E X3 = R::sub(F2, R::dbl(D, F), F);
    E C8 = R::dbl(R::dbl(R::dbl(C, F), F), F);
    E Y3 = R::sub(R::mul(E3, R::sub(D, X3, F), F), C8, F);
    E Z3 = R::dbl(R::mul(Y, Z, F), F);
    X = X3;
    Y = Y3;
    Z = Z3;
}

// The mixed add's chord, from H = U2 - U1 and rr = 2 (S2 - S1):
// I = (2H)^2, J = H I, V = U1 I, X3 = rr^2 - J - 2V, Y3 = rr (V - X3) - 2 S1 J.
template <class R>
ZK_HD void pt_chord(const typename R::E& H, const typename R::E& rr, const typename R::E& U1,
                    const typename R::E& S1, typename R::E& X3, typename R::E& Y3,
                    const typename R::P& F) {
    typedef typename R::E E;
    E I = R::sqr(R::dbl(H, F), F);
    E J = R::mul(H, I, F);
    E V = R::mul(U1, I, F);
    X3 = R::sub(R::sub(R::sqr(rr, F), J, F), R::dbl(V, F), F);
    Y3 = R::sub(R::mul(rr, R::sub(V, X3, F), F), R::dbl(R::mul(S1, J, F), F), F);
}

// (X1, Y1, Z1) += affine (x2, y2), complete, Q never at infinity
// (zksaas_tpu/curves/fused.py::_madd_core): P at infinity gives (x2, y2, 1),
// P == Q doubles (x2, y2, 1), P == -Q gives (one, one, zero).
template <class R>
ZK_HD void pt_madd(typename R::E& X1, typename R::E& Y1, typename R::E& Z1,
                   const typename R::E& x2, const typename R::E& y2, const typename R::P& F) {
    typedef typename R::E E;
    if (R::is_zero(Z1)) {
        X1 = x2;
        Y1 = y2;
        Z1 = R::one(F);
        return;
    }
    E Z1Z1 = R::sqr(Z1, F);
    E U2 = R::mul(x2, Z1Z1, F);
    E S2 = R::mul(R::mul(y2, Z1, F), Z1Z1, F);
    E H = R::sub(U2, X1, F);
    E rr = R::dbl(R::sub(S2, Y1, F), F);
    if (R::is_zero(H)) {
        if (R::is_zero(rr)) {
            X1 = x2;
            Y1 = y2;
            Z1 = R::one(F);
            pt_double<R>(X1, Y1, Z1, F);
        } else {
            X1 = R::one(F);
            Y1 = R::one(F);
            Z1 = R::zero();
        }
        return;
    }
    E X3, Y3;
    pt_chord<R>(H, rr, X1, Y1, X3, Y3, F);
    Z1 = R::mul(R::dbl(Z1, F), H, F);
    X1 = X3;
    Y1 = Y3;
}

// ---------------------------------------------------------------------------
// LSD radix sort of each row of n keys ascending as unsigned 32-bit values
// (zksaas_tpu/fields/sortperm.py): RADIX_PASSES stable passes over 8-bit
// digits, least significant first.  A row longer than one tile of
// RADIX_TILE keys runs each pass as per-tile digit counts, an exclusive
// scan of each row's counts in (digit, tile) order, which gives every
// tile's first place for each digit, and a stable scatter.  The counts and
// each row's digit totals for every pass live in the caller's scratch
// after a ping-pong copy of the keys; a row whose keys all share the
// pass's digit (one total is n) keeps its order, so its scatter is a copy.
// ---------------------------------------------------------------------------

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int RADIX_PASSES = 32 / RADIX_BITS;
constexpr long RADIX_TILE = 4096;

ZK_HD uint32_t radix_digit(uint32_t key, int pass) {
    return (key >> (RADIX_BITS * pass)) & (RADIX - 1);
}

// Index of (row, digit, tile) in the counts: digit-major within a row, so
// an exclusive scan over a row's entries in memory order is the scatter's
// offset table.
ZK_HD long radix_count_index(long row, uint32_t digit, long tiles, long tile) {
    return (row * RADIX + digit) * tiles + tile;
}

// 32-bit words of scratch a sort of `total` keys in rows of n needs: the
// ping-pong copy, RADIX counts per tile and RADIX totals per row and pass
// (none when a row fits in one tile and is sorted in shared memory).
ZK_HD long radix_scratch_words(long total, long n) {
    return n > RADIX_TILE ? total + total / RADIX_TILE * RADIX + RADIX_PASSES * (total / n) * RADIX
                          : 0;
}

// ---------------------------------------------------------------------------
// boundary layout: 16-bit limbs held in int32, little-endian; an Fq2
// element is c0's 2 NL limbs, then c1's
// ---------------------------------------------------------------------------

template <int NL>
ZK_HD void load16(const int32_t* src, Fq<NL>& a) {
#pragma unroll
    for (int i = 0; i < NL; i++)
        a.v[i] = ((uint32_t)src[2 * i] & 0xFFFFu) | ((uint32_t)src[2 * i + 1] << 16);
}

template <int NL>
ZK_HD void store16(int32_t* dst, const Fq<NL>& a) {
#pragma unroll
    for (int i = 0; i < NL; i++) {
        dst[2 * i] = (int32_t)(a.v[i] & 0xFFFFu);
        dst[2 * i + 1] = (int32_t)(a.v[i] >> 16);
    }
}

template <int NL>
ZK_HD void load16(const int32_t* src, Fq2<NL>& a) {
    load16(src, a.c0);
    load16(src + 2 * NL, a.c1);
}

template <int NL>
ZK_HD void store16(int32_t* dst, const Fq2<NL>& a) {
    store16(dst, a.c0);
    store16(dst + 2 * NL, a.c1);
}

// The host's params array, [p (NL limbs) | R mod p (NL limbs) | n0].
template <int NL>
ZK_HD FieldParams<NL> params_from(const uint32_t* host) {
    FieldParams<NL> F;
    for (int i = 0; i < NL; i++) {
        F.p[i] = host[i];
        F.one[i] = host[NL + i];
    }
    F.n0 = host[2 * NL];
    return F;
}

// The coordinate rings that are built, by the kernels' (limbs, nr, ncoord)
// arguments: G1 over 8- or 12-limb Fq (any nr), G2 over Fq2 with (8, -1)
// BN254, (12, -1) BLS12-381, (12, -5) BLS12-377.  -1 for any other.
enum RingId { G1_8, G1_12, G2_8_1, G2_12_1, G2_12_5, N_RINGS };

inline int ring_id(int nl, int nr, int ncoord) {
    if (ncoord == 1) return nl == 8 ? G1_8 : nl == 12 ? G1_12 : -1;
    if (ncoord != 2) return -1;
    if (nl == 8 && nr == -1) return G2_8_1;
    if (nl == 12 && nr == -1) return G2_12_1;
    if (nl == 12 && nr == -5) return G2_12_5;
    return -1;
}

// Returned by an entry point asked for a ring or limb count it was not built for.
constexpr int NOT_BUILT = -1;

}  // namespace zk
