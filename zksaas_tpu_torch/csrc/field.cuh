// Field and point arithmetic shared by the CUDA kernels (kernels.cuh) and
// the g++ host build used by the CPU tests (host_core.cpp).
//
// Replaces the in-kernel limb library of the JAX package
// (zksaas_tpu/fields/kernel_lib.py::KernelField), the Fermat inverse of
// zksaas_tpu/curves/fused.py (_finv_call; here Bernstein-Yang's safegcd,
// FqInverse) and the digit passes of the key sort
// (zksaas_tpu/fields/sortperm.py); the point cores of fused.py are the
// grouped programs of add_group.cuh.  Fq comes twice: a CIOS product in
// 64-bit C (fq_mul; montmul) and one on PTX carry chains (cc_mul and
// cc_add/cc_sub; the grouped programs, ring_mul, ring_inv).
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

// Signed 30-bit limbs of the inverse's state (FqInverse): 9 for 256-bit
// fields, 13 for 384-bit ones, room for values in (-2p, p).
constexpr ZK_HD int inv_limbs(int nl) { return (32 * nl + 29) / 30; }

// p, Montgomery one (R mod p) and n0 = -p^-1 mod 2^32, set by the host.
template <int NL>
struct FieldParams {
    uint32_t p[NL];
    uint32_t one[NL];
    uint32_t n0;
};

// The inverse's constants, set by the host: R^3 mod p, p in 30-bit limbs
// and p^-1 mod 2^30.  Kept out of FieldParams: every kernel takes that, and
// the grouped programs pass it by reference to the non-inlined cc_mul, so
// each of their threads copies it to its stack.
template <int NL>
struct InvParams {
    uint32_t r3[NL];
    int32_t p30[inv_limbs(NL)];
    uint32_t pinv30;
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

// ---------------------------------------------------------------------------
// carry-chain primitives: on the device one PTX instruction each, chained
// through the condition code's carry flag (asm volatile keeps their order);
// on the host the flag is the explicit `cf`
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)
#define ZK_CC_OP(name, ptx)                                                       \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t&) { \
        uint32_t r;                                                              \
        asm volatile(ptx " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));             \
        return r;                                                                \
    }
#define ZK_CC_MAD(name, ptx)                                                        \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c,    \
                                             uint32_t&) {                           \
        uint32_t r;                                                                \
        asm volatile(ptx " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));   \
        return r;                                                                  \
    }
ZK_CC_OP(add_cc, "add.cc.u32")
ZK_CC_OP(addc_cc, "addc.cc.u32")
ZK_CC_OP(addc, "addc.u32")
ZK_CC_OP(sub_cc, "sub.cc.u32")
ZK_CC_OP(subc_cc, "subc.cc.u32")
ZK_CC_OP(subc, "subc.u32")
ZK_CC_MAD(mad_lo_cc, "mad.lo.cc.u32")
ZK_CC_MAD(madc_lo_cc, "madc.lo.cc.u32")
ZK_CC_MAD(mad_hi_cc, "mad.hi.cc.u32")
ZK_CC_MAD(madc_hi_cc, "madc.hi.cc.u32")
ZK_CC_MAD(madc_hi, "madc.hi.u32")
#undef ZK_CC_OP
#undef ZK_CC_MAD
#else
inline uint32_t add_cc(uint32_t a, uint32_t b, uint32_t& cf) {
    uint64_t s = (uint64_t)a + b;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
inline uint32_t addc_cc(uint32_t a, uint32_t b, uint32_t& cf) {
    uint64_t s = (uint64_t)a + b + cf;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
inline uint32_t addc(uint32_t a, uint32_t b, uint32_t& cf) { return a + b + cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b, uint32_t& cf) {
    uint64_t d = (uint64_t)a - b;
    cf = (uint32_t)(d >> 63);  // borrow
    return (uint32_t)d;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b, uint32_t& cf) {
    uint64_t d = (uint64_t)a - b - cf;
    cf = (uint32_t)(d >> 63);
    return (uint32_t)d;
}
inline uint32_t subc(uint32_t a, uint32_t b, uint32_t& cf) { return a - b - cf; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
    return add_cc(a * b, c, cf);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
    return addc_cc(a * b, c, cf);
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
    return add_cc((uint32_t)(((uint64_t)a * b) >> 32), c, cf);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
    return addc_cc((uint32_t)(((uint64_t)a * b) >> 32), c, cf);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
    return addc((uint32_t)(((uint64_t)a * b) >> 32), c, cf);
}
#endif

// ---------------------------------------------------------------------------
// Fq on carry chains.  Operands are canonical (< p) and p < 2^(32 NL - 2)
// (BN254: 254 bits of 256; BLS12-381/377: 381/377 of 384), which bounds
// every sum below and lets each result be picked by a borrow mask instead
// of a branch.
// ---------------------------------------------------------------------------

// x - p if x >= p, else x, for x < 2p: the borrow of x - p as a mask
template <int NL>
ZK_HD Fq<NL> cc_reduce(const Fq<NL>& x, const FieldParams<NL>& F) {
    uint32_t cf = 0;
    Fq<NL> d;
    d.v[0] = sub_cc(x.v[0], F.p[0], cf);
#pragma unroll
    for (int i = 1; i < NL; i++) d.v[i] = subc_cc(x.v[i], F.p[i], cf);
    const uint32_t keep = subc(0u, 0u, cf);  // all ones iff x < p
#pragma unroll
    for (int i = 0; i < NL; i++) d.v[i] = (x.v[i] & keep) | (d.v[i] & ~keep);
    return d;
}

template <int NL>
ZK_HD Fq<NL> cc_add(const Fq<NL>& a, const Fq<NL>& b, const FieldParams<NL>& F) {
    uint32_t cf = 0;
    Fq<NL> s;
    s.v[0] = add_cc(a.v[0], b.v[0], cf);
#pragma unroll
    for (int i = 1; i < NL - 1; i++) s.v[i] = addc_cc(a.v[i], b.v[i], cf);
    s.v[NL - 1] = addc(a.v[NL - 1], b.v[NL - 1], cf);  // a + b < 2p: no carry out
    return cc_reduce(s, F);
}

template <int NL>
ZK_HD Fq<NL> cc_dbl(const Fq<NL>& a, const FieldParams<NL>& F) {
    return cc_add(a, a, F);
}

template <int NL>
ZK_HD Fq<NL> cc_sub(const Fq<NL>& a, const Fq<NL>& b, const FieldParams<NL>& F) {
    uint32_t cf = 0;
    Fq<NL> d;
    d.v[0] = sub_cc(a.v[0], b.v[0], cf);
#pragma unroll
    for (int i = 1; i < NL; i++) d.v[i] = subc_cc(a.v[i], b.v[i], cf);
    const uint32_t back = subc(0u, 0u, cf);  // all ones iff a < b: add p back
    d.v[0] = add_cc(d.v[0], F.p[0] & back, cf);
#pragma unroll
    for (int i = 1; i < NL - 1; i++) d.v[i] = addc_cc(d.v[i], F.p[i] & back, cf);
    d.v[NL - 1] = addc(d.v[NL - 1], F.p[NL - 1] & back, cf);
    return d;
}

// CIOS Montgomery product a b R^-1 mod p, R = 2^(32 NL), a < p, b < R.
// Row i adds a b_i as two chains (the low words of the products at their
// column, the high words one column up), then m p with m = t_0 n0 the same
// way, and drops the zero low word.  The accumulator t stays below 2p
// between rows and below 2^(32 (NL + 1)) inside one, so NL + 1 words hold
// it and no chain carries out of the top word; one masked subtraction of p
// leaves the canonical residue.
template <int NL>
ZK_HD Fq<NL> cc_mont(const Fq<NL>& a, const Fq<NL>& b, const FieldParams<NL>& F) {
    uint32_t t[NL + 1];
#pragma unroll
    for (int j = 0; j <= NL; j++) t[j] = 0;
    uint32_t cf = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        const uint32_t bi = b.v[i];
        t[0] = mad_lo_cc(a.v[0], bi, t[0], cf);
#pragma unroll
        for (int j = 1; j < NL; j++) t[j] = madc_lo_cc(a.v[j], bi, t[j], cf);
        t[NL] = addc(t[NL], 0u, cf);
        t[1] = mad_hi_cc(a.v[0], bi, t[1], cf);
#pragma unroll
        for (int j = 1; j < NL - 1; j++) t[j + 1] = madc_hi_cc(a.v[j], bi, t[j + 1], cf);
        t[NL] = madc_hi(a.v[NL - 1], bi, t[NL], cf);

        const uint32_t m = t[0] * F.n0;
        t[0] = mad_lo_cc(m, F.p[0], t[0], cf);  // 0, with its carry
#pragma unroll
        for (int j = 1; j < NL; j++) t[j] = madc_lo_cc(m, F.p[j], t[j], cf);
        t[NL] = addc(t[NL], 0u, cf);
        t[1] = mad_hi_cc(m, F.p[0], t[1], cf);
#pragma unroll
        for (int j = 1; j < NL - 1; j++) t[j + 1] = madc_hi_cc(m, F.p[j], t[j + 1], cf);
        t[NL] = madc_hi(m, F.p[NL - 1], t[NL], cf);
#pragma unroll
        for (int j = 0; j < NL; j++) t[j] = t[j + 1];
        t[NL] = 0;
    }
    Fq<NL> r;
#pragma unroll
    for (int j = 0; j < NL; j++) r.v[j] = t[j];
    return cc_reduce(r, F);
}

// cc_mont as one non-inlined copy on the device: the add's program calls it
// from 9 places, and that many inlined copies of its 4 NL^2 chained
// instructions (about 600 at 12 limbs) leave the kernel's code larger than
// the instruction cache; one copy, its operands passed by value, runs
// faster at every batch size.
#if defined(__CUDACC__)
#define ZK_MUL_HD __host__ __device__ __noinline__
#else
#define ZK_MUL_HD inline
#endif
template <int NL>
ZK_MUL_HD Fq<NL> cc_mul(const Fq<NL> a, const Fq<NL> b, const FieldParams<NL>& F) {
    return cc_mont(a, b, F);
}

// -nr x for Fq2 = Fq[u]/(u^2 - nr), nr = -NR: x itself, or 4x + x by
// doublings (fused.py's muli)
template <int NR, int NL>
ZK_HD Fq<NL> cc_neg_nr(const Fq<NL>& x, const FieldParams<NL>& F) {
    if constexpr (NR == 1) {
        return x;
    } else {
        return cc_add(cc_dbl(cc_dbl(x, F), F), x, F);
    }
}

// ---------------------------------------------------------------------------
// Inversion by Bernstein and Yang's safegcd ("Fast constant-time gcd
// computation and modular inversion", 2019), laid out as libsecp256k1's
// modinv32: divsteps in batches of 30 on the low words of f and g, each
// batch's 2x2 transition matrix (scaled by 2^30) applied to f, g and to d,
// e mod p, all held as signed 30-bit limbs.  It starts from f = p, g = x,
// d = 0, e = 1 and keeps d x = f (mod p) up to sign, so when g reaches 0,
// f = +-1 and +-d is x^-1: the plain integer inverse of x.  For a
// Montgomery residue x = a R that is a^-1 R^-1, and one Montgomery product
// by R^3 mod p turns it into a^-1 R.  x = 0 stays at g = 0 and d = 0, so
// 0 maps to 0.
//
// A batch is branch-free, so the lanes of a warp never diverge; the caller
// stops when every lane's g is 0 (a warp vote on the device, a loop over
// the lanes on the host).  A lane whose g is already 0 goes on stepping
// unchanged: f and g stay, and d only gains multiples of p.  Each batch
// applies the previous batch's matrix to d and e, which nothing in the
// batch's own divsteps reads, so the compiler can interleave the two.
// ---------------------------------------------------------------------------

constexpr int32_t M30 = 0x3FFFFFFF;

template <int NL>
struct FqInverse {
    static constexpr int NS = inv_limbs(NL);
    // Bernstein-Yang's bound on the divsteps of 32 NL-bit inputs
    // ((49 d + 57) / 17, their Theorem 11.2), in batches: a guard against
    // a runaway loop.  Random inputs need 18 batches over BN254's Fq and
    // 26-27 over the BLS12 fields.
    static constexpr int MAX_BATCHES = ((49 * 32 * NL + 57) / 17 + 29) / 30;

    int32_t f[NS], g[NS], d[NS], e[NS];
    int32_t zeta;  // -(delta + 1/2) of the half-delta divsteps
    int32_t t[4];  // the last batch's matrix (u, v, q, r), not yet applied to d, e

    ZK_HD FqInverse(const Fq<NL>& x, const InvParams<NL>& I) : zeta(-1) {
#pragma unroll
        for (int i = 0; i < NS; i++) {  // x in 30-bit limbs
            const int k = 30 * i / 32, s = 30 * i % 32;
            uint32_t w = x.v[k] >> s;
            if (s > 2 && k + 1 < NL) w |= x.v[k + 1] << (32 - s);
            g[i] = (int32_t)(w & M30);
            f[i] = I.p30[i];
            d[i] = 0;
            e[i] = i == 0;
        }
        t[0] = t[3] = 1 << 30;  // the identity, scaled
        t[1] = t[2] = 0;
    }

    ZK_HD bool done() const {
        int32_t acc = 0;
#pragma unroll
        for (int i = 0; i < NS; i++) acc |= g[i];
        return acc == 0;
    }

    // 30 divsteps of (zeta, f, g) on their low words (modinv32_divsteps_30):
    // the matrix into m, so that [f, g] 2^30 = m [f0, g0]
    static ZK_HD int32_t divsteps(int32_t zeta, uint32_t f, uint32_t g, int32_t m[4]) {
        uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
        for (int i = 0; i < 30; i++) {
            const uint32_t neg = (uint32_t)(zeta >> 31);  // zeta < 0
            const uint32_t odd = 0u - (g & 1u);
            // g odd: g += f, or g -= f when zeta < 0, which also swaps
            g += ((f ^ neg) - neg) & odd;
            q += ((u ^ neg) - neg) & odd;
            r += ((v ^ neg) - neg) & odd;
            const uint32_t swap = neg & odd;
            zeta = (zeta ^ (int32_t)swap) - 1;
            f += g & swap;
            u += q & swap;
            v += r & swap;
            g >>= 1;
            u <<= 1;
            v <<= 1;
        }
        m[0] = (int32_t)u;
        m[1] = (int32_t)v;
        m[2] = (int32_t)q;
        m[3] = (int32_t)r;
        return zeta;
    }

    // [a, b] = m [a, b] / 2^30 exactly (modinv32_update_fg_30)
    static ZK_HD void apply(int32_t* a, int32_t* b, const int32_t m[4]) {
        int64_t ca = (int64_t)m[0] * a[0] + (int64_t)m[1] * b[0];
        int64_t cb = (int64_t)m[2] * a[0] + (int64_t)m[3] * b[0];
        ca >>= 30;
        cb >>= 30;
#pragma unroll
        for (int i = 1; i < NS; i++) {
            ca += (int64_t)m[0] * a[i] + (int64_t)m[1] * b[i];
            cb += (int64_t)m[2] * a[i] + (int64_t)m[3] * b[i];
            a[i - 1] = (int32_t)ca & M30;
            b[i - 1] = (int32_t)cb & M30;
            ca >>= 30;
            cb >>= 30;
        }
        a[NS - 1] = (int32_t)ca;
        b[NS - 1] = (int32_t)cb;
    }

    // [d, e] = (m [d, e] + p [md, me]) / 2^30 with md, me chosen so that the
    // division is exact and d, e stay in (-2p, p) (modinv32_update_de_30)
    ZK_HD void apply_de(const int32_t m[4], const InvParams<NL>& I) {
        const int32_t sd = d[NS - 1] >> 31, se = e[NS - 1] >> 31;
        int32_t md = (m[0] & sd) + (m[1] & se);
        int32_t me = (m[2] & sd) + (m[3] & se);
        int64_t cd = (int64_t)m[0] * d[0] + (int64_t)m[1] * e[0];
        int64_t ce = (int64_t)m[2] * d[0] + (int64_t)m[3] * e[0];
        md -= (int32_t)((I.pinv30 * (uint32_t)cd + (uint32_t)md) & M30);
        me -= (int32_t)((I.pinv30 * (uint32_t)ce + (uint32_t)me) & M30);
        cd += (int64_t)I.p30[0] * md;
        ce += (int64_t)I.p30[0] * me;
        cd >>= 30;
        ce >>= 30;
#pragma unroll
        for (int i = 1; i < NS; i++) {
            cd += (int64_t)m[0] * d[i] + (int64_t)m[1] * e[i] + (int64_t)I.p30[i] * md;
            ce += (int64_t)m[2] * d[i] + (int64_t)m[3] * e[i] + (int64_t)I.p30[i] * me;
            d[i - 1] = (int32_t)cd & M30;
            e[i - 1] = (int32_t)ce & M30;
            cd >>= 30;
            ce >>= 30;
        }
        d[NS - 1] = (int32_t)cd;
        e[NS - 1] = (int32_t)ce;
    }

    // one batch: 30 divsteps and f, g by their matrix; d, e by the previous one
    ZK_HD void step(const InvParams<NL>& I) {
        int32_t m[4];
        zeta = divsteps(zeta, (uint32_t)f[0], (uint32_t)g[0], m);
        apply_de(t, I);
        apply(f, g, m);
#pragma unroll
        for (int i = 0; i < 4; i++) t[i] = m[i];
    }

    // d's limbs carried into [0, 2^30), the top one signed
    ZK_HD void carry() {
#pragma unroll
        for (int i = 0; i < NS - 1; i++) {
            d[i + 1] += d[i] >> 30;
            d[i] &= M30;
        }
    }

    // x^-1 R^3 R^-1 once every lane's g is 0: d, by the pending matrix, into
    // [0, p) with f's sign (modinv32_normalize_30), times R^3 mod p
    ZK_HD Fq<NL> result(const FieldParams<NL>& F, const InvParams<NL>& I) {
        apply_de(t, I);
        const int32_t neg = d[NS - 1] >> 31, flip = f[NS - 1] >> 31;
#pragma unroll
        for (int i = 0; i < NS; i++) d[i] = ((d[i] + (I.p30[i] & neg)) ^ flip) - flip;
        carry();  // d in (-p, p)
        const int32_t neg2 = d[NS - 1] >> 31;
#pragma unroll
        for (int i = 0; i < NS; i++) d[i] += I.p30[i] & neg2;
        carry();  // d in [0, p)
        Fq<NL> r;
#pragma unroll
        for (int j = 0; j < NL; j++) {  // back to 32-bit limbs
            const int k = 32 * j / 30, s = 32 * j % 30;
            uint32_t w = (uint32_t)d[k] >> s;
            if (k + 1 < NS) w |= (uint32_t)d[k + 1] << (30 - s);
            r.v[j] = w;
        }
        Fq<NL> r3;
#pragma unroll
        for (int j = 0; j < NL; j++) r3.v[j] = I.r3[j];
        return cc_mul(r, r3, F);
    }
};

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
    // ring_mul's product, on carry chains and inlined
    static ZK_HD E mul_cc(const E& a, const E& b, const P& F) { return cc_mont(a, b, F); }
    // the inverse (ring_inv): the Fq element that FqInverse inverts, and
    // the ring's inverse from that element's
    static ZK_HD Fq<N> inv_norm(const E& a, const P&) { return a; }
    static ZK_HD E inv_finish(const E&, const Fq<N>& ninv, const P&) { return ninv; }
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
    // ring_mul's Karatsuba product, on carry chains and inlined
    static ZK_HD E mul_cc(const E& a, const E& b, const P& F) {
        Fq<N> t0 = cc_mont(a.c0, b.c0, F);
        Fq<N> t1 = cc_mont(a.c1, b.c1, F);
        Fq<N> t2 = cc_mont(cc_add(a.c0, a.c1, F), cc_add(b.c0, b.c1, F), F);
        return E{cc_sub(t0, cc_neg_nr<NR>(t1, F), F), cc_sub(cc_sub(t2, t0, F), t1, F)};
    }
    // the inverse through the norm: (c0 + c1 u)^-1 = (c0 - c1 u) / (c0^2 - nr c1^2)
    static ZK_HD Fq<N> inv_norm(const E& a, const P& F) {
        return cc_add(cc_mul(a.c0, a.c0, F), cc_neg_nr<NR>(cc_mul(a.c1, a.c1, F), F), F);
    }
    static ZK_HD E inv_finish(const E& a, const Fq<N>& ninv, const P& F) {
        return E{cc_mul(a.c0, ninv, F), cc_sub(fq_zero<N>(), cc_mul(a.c1, ninv, F), F)};
    }
    static ZK_HD E zero() { return E{fq_zero<N>(), fq_zero<N>()}; }
};

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

// The host's params array, [p (NL limbs) | R mod p (NL) | n0 | R^3 mod p
// (NL) | p (inv_limbs(NL) 30-bit limbs) | p^-1 mod 2^30]: FieldParams,
// then InvParams.
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

template <int NL>
ZK_HD InvParams<NL> inv_params_from(const uint32_t* host) {
    InvParams<NL> I;
    constexpr int NS = inv_limbs(NL);
    for (int i = 0; i < NL; i++) I.r3[i] = host[2 * NL + 1 + i];
    for (int i = 0; i < NS; i++) I.p30[i] = (int32_t)host[3 * NL + 1 + i];
    I.pinv30 = host[3 * NL + 1 + NS];
    return I;
}

// ---------------------------------------------------------------------------
// Field.rand's elements (fields/field.py): the ChaCha20 block function
// (RFC 8439 section 2.3) with a 256-bit key drawn on the host, nonce 0 and
// block counter 0, 1, 2, ...; its keystream read as little-endian 32-bit
// words.  Element i takes words [2 NL i, 2 NL (i + 1)): lo the first NL,
// hi the next NL, each word a 32-bit limb (two 16-bit limbs, low half
// first), and is hi R + lo mod p = mont(hi, R^2 mod p) + mont(lo, R mod p).
// ---------------------------------------------------------------------------

struct ChaChaKey {
    uint32_t w[8];
};

ZK_HD uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

ZK_HD void chacha_quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
    a += b; d = rotl32(d ^ a, 16);
    c += d; b = rotl32(b ^ c, 12);
    a += b; d = rotl32(d ^ a, 8);
    c += d; b = rotl32(b ^ c, 7);
}

// The 16 keystream words of block `counter`.
ZK_HD void chacha20_block(const ChaChaKey& key, uint32_t counter, uint32_t* out) {
    uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u};
#pragma unroll
    for (int j = 0; j < 8; j++) s[4 + j] = key.w[j];
    s[12] = counter;
    s[13] = s[14] = s[15] = 0;
    uint32_t x[16];
#pragma unroll
    for (int j = 0; j < 16; j++) x[j] = s[j];
#pragma unroll
    for (int r = 0; r < 10; r++) {
        chacha_quarter(x[0], x[4], x[8], x[12]);
        chacha_quarter(x[1], x[5], x[9], x[13]);
        chacha_quarter(x[2], x[6], x[10], x[14]);
        chacha_quarter(x[3], x[7], x[11], x[15]);
        chacha_quarter(x[0], x[5], x[10], x[15]);
        chacha_quarter(x[1], x[6], x[11], x[12]);
        chacha_quarter(x[2], x[7], x[8], x[13]);
        chacha_quarter(x[3], x[4], x[9], x[14]);
    }
#pragma unroll
    for (int j = 0; j < 16; j++) out[j] = x[j] + s[j];
}

// R^2 mod p from the inverse's R^3 mod p: mont(R^3, 1).
template <int NL>
ZK_HD Fq<NL> r2_from(const FieldParams<NL>& F, const InvParams<NL>& I) {
    Fq<NL> r3, one = fq_zero<NL>();
#pragma unroll
    for (int i = 0; i < NL; i++) r3.v[i] = I.r3[i];
    one.v[0] = 1;
    return fq_mul(r3, one, F);
}

// Element i of the stream.  Its 2 NL words start at word 2 NL i, which is
// a multiple of 8, so they lie in one block at offset 0 (NL = 8) or in two
// blocks from offset 0 or 8 (NL = 12); both blocks are computed and the
// words picked with constant indices, so the keystream stays in registers.
template <int NL>
ZK_HD Fq<NL> rand_element(const ChaChaKey& key, long i, const FieldParams<NL>& F,
                          const Fq<NL>& r2) {
    constexpr int W = 2 * NL;
    static_assert(W % 8 == 0, "an element starts on a half block");
    constexpr int NB = W % 16 == 0 ? W / 16 : W / 16 + 1;
    uint32_t ks[16 * NB];
    const uint64_t w0 = (uint64_t)W * (uint64_t)i;
#pragma unroll
    for (int b = 0; b < NB; b++) chacha20_block(key, (uint32_t)(w0 / 16 + b), ks + 16 * b);
    Fq<NL> lo, hi;
    if constexpr (W % 16 == 0) {
#pragma unroll
        for (int j = 0; j < NL; j++) {
            lo.v[j] = ks[j];
            hi.v[j] = ks[NL + j];
        }
    } else {
        const bool half = (w0 % 16) != 0;  // the element starts at word 8 of its block
#pragma unroll
        for (int j = 0; j < NL; j++) {
            lo.v[j] = half ? ks[8 + j] : ks[j];
            hi.v[j] = half ? ks[8 + NL + j] : ks[NL + j];
        }
    }
    return cc_add(fq_mul(hi, r2, F), fq_mul(lo, fq_one(F), F), F);
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
