// The grouped point programs of kernels 2-4 and 7 (point_add / point_add_if,
// point_double(k), point_aadd): each runs on a group of G lanes that share
// one point, on the Fq arithmetic defined here, Montgomery products, adds
// and subs written as carry chains.
//
// Replaces the one-thread-per-point formulas of zksaas_tpu/curves/fused.py:
// _add_core (_add_call, _add_select_call), _double_core applied k times
// (_double_call) and _aadd_core (_aadd_call).  The main path adds and
// doubles 8-128 points a launch (the binary scalar muls of the king's
// mat-vecs and of the r/s shares, one double and one add-if per scalar
// bit; Pippenger's window fold, 8-128 points doubled 8-128 times), so such
// a launch costs the latency of one point's chain of dependent Fq products:
// 16 (add) or 7 (double) in G1, 48 or 21 in G2, in series on one thread.
// Here the G lanes of a group compute the independent products of each
// level of the formula's dependency graph at once (in G2 the three Fq
// products of each Karatsuba Fq2 product are separate items), so an add is
// 5 products deep in G1 and 8-10 in G2, a doubling and an affine+affine add
// 3.  Pippenger's tree level 1 runs the affine+affine add over 2^21-2^22
// pairs, where it is bound by throughput: there the lanes keep each
// thread's live state to one product's operands, so no instance needs the
// 255 registers and spills of a whole point per thread.  The lanes pass
// operands through shared memory (one slot array per group, synchronised
// with __syncwarp over the group's lanes).  A group decides the special
// cases (infinity operands and flags, cond false, P == Q, P == -Q) on
// values every lane reads, so it never diverges; P == Q runs the doubling
// program.
//
// On the host (g++, csrc/host_core.cpp) the same programs run with the
// lanes looped serially and the carry flag emulated in C, so the CPU tests
// check the device's algorithm step for step; only the mapping of each
// primitive below to its PTX instruction is not exercised there.

#pragma once
#include <stdint.h>

#include "field.cuh"

namespace zk {

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
//
// Not inlined on the device: the add's program calls it from 9 places, and
// that many inlined copies of its 4 NL^2 chained instructions (about 600
// at 12 limbs) leave the kernel's code larger than the instruction cache;
// one copy, its operands passed by value, runs faster at every batch size.
#if defined(__CUDACC__)
#define ZK_MUL_HD __host__ __device__ __noinline__
#else
#define ZK_MUL_HD inline
#endif
template <int NL>
ZK_MUL_HD Fq<NL> cc_mul(const Fq<NL> a, const Fq<NL> b, const FieldParams<NL>& F) {
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

// ---------------------------------------------------------------------------
// the grouped point programs
// ---------------------------------------------------------------------------

// Lanes per point of the complete add and the double: 4 in G1 (the widest
// level has 4 products in the add, 3 in the double), 8 in G2 (12 and 9 Fq
// products).
template <class R>
constexpr int point_lanes() {
    return R::LIMBS16 == 2 * R::NL ? 4 : 8;
}

// Lanes per point of the affine+affine add, whose levels are 2 ring
// products wide: 2 in G1, 8 in G2 (6 Fq products).
template <class R>
constexpr int aadd_lanes() {
    return R::LIMBS16 == 2 * R::NL ? 2 : 8;
}

// Ring slots of a group's shared array.  The inputs take 0-5 (P, then Q);
// later levels reuse the slots of values no longer read (a step never
// writes a slot that another item of the same step reads).  Every program
// leaves its result in (S_X1, S_Y1, S_Z1), or in (S_X2, S_Y2, S_Z2) when
// the result is Q.
enum Slot : int {
    S_X1, S_Y1, S_Z1, S_X2, S_Y2, S_Z2,
    S_A, S_B, S_C, S_D, S_U1, S_U2, S_S1, S_S2, S_H, S_R, S_H2,
    N_ADD_SLOTS,
    // add: later levels
    S_I = S_A, S_RSQ = S_B, S_ZZ = S_C, S_J = S_D, S_V = S_U2, S_ZH = S_S2,
    S_W = S_A, S_Y3A = S_B, S_SJ = S_H,
    // doubling: A = X^2, B = Y^2, YZ, X + B, E = 3A, C = B^2, (X + B)^2,
    // F = E^2, W = D - X3, E W
    S_DA = S_A, S_DB = S_B, S_DYZ = S_C, S_XB = S_D, S_E = S_U1, S_DC = S_U2,
    S_XB2 = S_S1, S_DF = S_S2, S_DW = S_D, S_EW = S_H,
    N_DBL_SLOTS,  // the doubling's last slot is S_EW
    // affine+affine: H = x2 - x1, r = 2 (y2 - y1), 2H, I = (2H)^2, r^2,
    // J = H I, V = x1 I, W = V - X3, r W, y1 J; its P == Q branch runs the
    // doubling, so it takes the doubling's slots
    S_AH = S_A, S_AR = S_B, S_AH2 = S_C, S_AI = S_D, S_ARSQ = S_U1, S_AJ = S_U2,
    S_AV = S_S1, S_AW = S_S2, S_AY3A = S_A, S_ASJ = S_C,
    N_AADD_SLOTS = N_DBL_SLOTS,
};

// G lanes sharing one point, over NS ring slots of shared memory.
template <class R, int G_, int NS>
struct Group {
    static constexpr int NL = R::NL;
    static constexpr int NC = R::LIMBS16 / (2 * NL);  // Fq coordinates per ring element
    static constexpr int G = G_;
    static constexpr int NR = R::NEG_NR;
    // Fq temporaries of the Karatsuba products, 3 per Fq2 product, 4 at once
    static constexpr int TMP = NS * NC;
    static constexpr int FQ_SLOTS = TMP + (NC == 2 ? 12 : 0);
    // words a group's array takes, padded so that the groups of a warp
    // start in different shared-memory banks
    static constexpr int WORDS = FQ_SLOTS * NL + ((FQ_SLOTS * NL) % 32 == 0 ? 4 : 0);
    typedef Fq<NL> E;
    typedef typename R::P P;

    uint32_t* s;  // FQ_SLOTS elements of NL words
    const P& F;
    int lane;       // this lane's place in the group (device)
    unsigned mask;  // the group's lanes in the warp (device)

    ZK_HD E ld(int f) const {
        E x;
#pragma unroll
        for (int i = 0; i < NL; i++) x.v[i] = s[f * NL + i];
        return x;
    }
    ZK_HD void st(int f, const E& x) {
#pragma unroll
        for (int i = 0; i < NL; i++) s[f * NL + i] = x.v[i];
    }
    // Fq component c of ring slot k
    ZK_HD E ld(int k, int c) const { return ld(k * NC + c); }
    ZK_HD void st(int k, int c, const E& x) { st(k * NC + c, x); }

    // n independent items, spread over the lanes (looped on the host), then
    // the group's barrier
    template <class Fn>
    ZK_HD void step(int n, Fn&& fn) {
#if defined(__CUDA_ARCH__)
        for (int q = lane; q < n; q += G) fn(q);
        __syncwarp(mask);
#else
        for (int q = 0; q < n; q++) fn(q);
#endif
    }

    // n component-wise ring ops: fn(op, component)
    template <class Fn>
    ZK_HD void lin(int n, Fn&& fn) {
        step(n * NC, [&](int q) { fn(q / NC, q % NC); });
    }

    ZK_HD E neg_nr(const E& x) const {
        if constexpr (NR == 1) {
            return x;
        } else {
            return cc_add(cc_dbl(cc_dbl(x, F), F), x, F);
        }
    }

    // d[k] = a[k] b[k], K independent ring products
    template <int K>
    ZK_HD void muls(const int (&a)[K], const int (&b)[K], const int (&d)[K]) {
        if constexpr (NC == 1) {
            step(K, [&](int q) { st(d[q], cc_mul(ld(a[q]), ld(b[q]), F)); });
        } else {
            static_assert(3 * K <= FQ_SLOTS - TMP, "too many Fq2 products in one step");
            // Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1)
            step(3 * K, [&](int q) {
                const int k = q / 3, part = q % 3;
                E x = ld(a[k], part == 1), y = ld(b[k], part == 1);
                if (part == 2) {
                    x = cc_add(x, ld(a[k], 1), F);
                    y = cc_add(y, ld(b[k], 1), F);
                }
                st(TMP + q, cc_mul(x, y, F));
            });
            // (t0 + nr t1, t2 - t0 - t1)
            step(2 * K, [&](int q) {
                const int k = q / 2;
                const E t0 = ld(TMP + 3 * k), t1 = ld(TMP + 3 * k + 1);
                if (q % 2 == 0) {
                    st(d[k], 0, cc_sub(t0, neg_nr(t1), F));
                } else {
                    st(d[k], 1, cc_sub(cc_sub(ld(TMP + 3 * k + 2), t0, F), t1, F));
                }
            });
        }
    }

    // every lane reads the whole slot, so the answer is the group's
    ZK_HD bool is_zero(int k) const {
        uint32_t acc = 0;
        for (int i = 0; i < NC * NL; i++) acc |= s[k * NC * NL + i];
        return acc == 0;
    }

    // the n ring slots from k on: the first `ones` of them one, the rest zero
    ZK_HD void set(int k, int n, int ones) {
        lin(n, [&](int op, int c) {
            st(k + op, c, c == 0 && op < ones ? fq_one(F) : fq_zero<NL>());
        });
    }

    // (S_X1, S_Y1, S_Z1) doubled in place: pt_double's dbl-2009-l, 3
    // products deep.  The input is read only by the first two steps, so the
    // later ones write the result over it.
    ZK_HD void dbl() {
        static_assert(NS >= N_DBL_SLOTS, "the doubling needs N_DBL_SLOTS slots");
        muls<3>({S_X1, S_Y1, S_Y1}, {S_X1, S_Y1, S_Z1}, {S_DA, S_DB, S_DYZ});
        lin(2, [&](int op, int c) {
            if (op == 0) {
                st(S_XB, c, cc_add(ld(S_X1, c), ld(S_DB, c), F));
            } else {
                const E a = ld(S_DA, c);
                st(S_E, c, cc_add(cc_dbl(a, F), a, F));
            }
        });
        muls<3>({S_DB, S_XB, S_E}, {S_DB, S_XB, S_E}, {S_DC, S_XB2, S_DF});
        lin(2, [&](int op, int c) {
            if (op == 0) {
                const E d = cc_dbl(
                    cc_sub(cc_sub(ld(S_XB2, c), ld(S_DA, c), F), ld(S_DC, c), F), F);
                const E x3 = cc_sub(ld(S_DF, c), cc_dbl(d, F), F);
                st(S_X1, c, x3);
                st(S_DW, c, cc_sub(d, x3, F));
            } else {
                st(S_Z1, c, cc_dbl(ld(S_DYZ, c), F));
            }
        });
        muls<1>({S_E}, {S_DW}, {S_EW});
        lin(1, [&](int, int c) {
            const E c8 = cc_dbl(cc_dbl(cc_dbl(ld(S_DC, c), F), F), F);
            st(S_Y1, c, cc_sub(ld(S_EW, c), c8, F));
        });
    }

    // P (slots 0-2) + Q (slots 3-5), complete, as fused.py::_add_core
    // computes it: Q at infinity keeps P, P at infinity gives Q, P == Q
    // doubles, P == -Q gives (one, one, zero).  Returns the slot of the
    // result's X.
    ZK_HD int add() {
        static_assert(NS >= N_ADD_SLOTS, "the add needs N_ADD_SLOTS slots");
        if (is_zero(S_Z2)) return S_X1;
        if (is_zero(S_Z1)) return S_X2;
        muls<4>({S_Z1, S_Z2, S_Y1, S_Y2}, {S_Z1, S_Z2, S_Z2, S_Z1}, {S_A, S_B, S_C, S_D});
        muls<4>({S_X1, S_X2, S_C, S_D}, {S_B, S_A, S_B, S_A}, {S_U1, S_U2, S_S1, S_S2});
        // H = U2 - U1, r = 2 (S2 - S1), 2H
        lin(3, [&](int op, int c) {
            if (op == 1) {
                st(S_R, c, cc_dbl(cc_sub(ld(S_S2, c), ld(S_S1, c), F), F));
            } else {
                const E h = cc_sub(ld(S_U2, c), ld(S_U1, c), F);
                st(op == 0 ? S_H : S_H2, c, op == 0 ? h : cc_dbl(h, F));
            }
        });
        if (is_zero(S_H)) {
            if (is_zero(S_R)) {
                dbl();
            } else {
                set(S_X1, 3, 2);
            }
            return S_X1;
        }
        // I = (2H)^2, r^2, Z1 Z2; J = H I, V = U1 I, Z1 Z2 H
        muls<3>({S_H2, S_R, S_Z1}, {S_H2, S_R, S_Z2}, {S_I, S_RSQ, S_ZZ});
        muls<3>({S_H, S_U1, S_ZZ}, {S_I, S_I, S_H}, {S_J, S_V, S_ZH});
        // X3 = r^2 - J - 2V, W = V - X3, Z3 = 2 Z1 Z2 H (P is read no more)
        lin(2, [&](int op, int c) {
            if (op == 0) {
                const E v = ld(S_V, c);
                const E x3 = cc_sub(cc_sub(ld(S_RSQ, c), ld(S_J, c), F), cc_dbl(v, F), F);
                st(S_X1, c, x3);
                st(S_W, c, cc_sub(v, x3, F));
            } else {
                st(S_Z1, c, cc_dbl(ld(S_ZH, c), F));
            }
        });
        // Y3 = r W - 2 S1 J
        muls<2>({S_R, S_S1}, {S_W, S_J}, {S_Y3A, S_SJ});
        lin(1, [&](int, int c) {
            st(S_Y1, c, cc_sub(ld(S_Y3A, c), cc_dbl(ld(S_SJ, c), F), F));
        });
        return S_X1;
    }

    // Affine P = (x1, y1) (slots S_X1, S_Y1) + affine Q = (x2, y2) (S_X2,
    // S_Y2) -> Jacobian, complete, mmadd-2007-bl as fused.py::_aadd_core
    // computes it: Q at infinity keeps P (Z = 0 if P is at infinity too),
    // P at infinity gives Q, P == Q doubles (x1, y1, 1), P == -Q gives
    // (one, one, zero).  Returns the slot of the result's X.
    ZK_HD int aadd(bool inf1, bool inf2) {
        static_assert(NS >= N_AADD_SLOTS, "the affine add needs N_AADD_SLOTS slots");
        if (inf2) {
            set(S_Z1, 1, inf1 ? 0 : 1);
            return S_X1;
        }
        if (inf1) {
            set(S_Z2, 1, 1);
            return S_X2;
        }
        // H = x2 - x1 and 2H, r = 2 (y2 - y1)
        lin(2, [&](int op, int c) {
            if (op == 0) {
                const E h = cc_sub(ld(S_X2, c), ld(S_X1, c), F);
                st(S_AH, c, h);
                st(S_AH2, c, cc_dbl(h, F));
            } else {
                st(S_AR, c, cc_dbl(cc_sub(ld(S_Y2, c), ld(S_Y1, c), F), F));
            }
        });
        if (is_zero(S_AH)) {
            if (is_zero(S_AR)) {
                set(S_Z1, 1, 1);
                dbl();
            } else {
                set(S_X1, 3, 2);
            }
            return S_X1;
        }
        // I = (2H)^2, r^2; J = H I, V = x1 I
        muls<2>({S_AH2, S_AR}, {S_AH2, S_AR}, {S_AI, S_ARSQ});
        muls<2>({S_AH, S_X1}, {S_AI, S_AI}, {S_AJ, S_AV});
        // X3 = r^2 - J - 2V, W = V - X3, Z3 = 2H (x1 is read no more)
        lin(2, [&](int op, int c) {
            if (op == 0) {
                const E v = ld(S_AV, c);
                const E x3 = cc_sub(cc_sub(ld(S_ARSQ, c), ld(S_AJ, c), F), cc_dbl(v, F), F);
                st(S_X1, c, x3);
                st(S_AW, c, cc_sub(v, x3, F));
            } else {
                st(S_Z1, c, ld(S_AH2, c));
            }
        });
        // Y3 = r W - 2 y1 J
        muls<2>({S_AR, S_Y1}, {S_AW, S_AJ}, {S_AY3A, S_ASJ});
        lin(1, [&](int, int c) {
            st(S_Y1, c, cc_sub(ld(S_AY3A, c), cc_dbl(ld(S_ASJ, c), F), F));
        });
        return S_X1;
    }

    // the coordinates x, y and, unless it is null, z of row i from the
    // 16-bit-limb boundary layout into ring slots k, k + 1 (, k + 2), two
    // 32-bit words per item
    ZK_HD void load(const int32_t* x, const int32_t* y, const int32_t* z, int k, long i) {
        constexpr int W = NC * NL;  // words per coordinate
        const long off = i * R::LIMBS16;
        step((z == nullptr ? 2 : 3) * W / 2, [&](int q) {
            const int c = q / (W / 2), w = 2 * (q % (W / 2));
            const int32_t* src = (c == 0 ? x : c == 1 ? y : z) + off + 2 * w;
            uint32_t* dst = s + (k + c) * W + w;
#if defined(__CUDA_ARCH__)
            const int4 v = *reinterpret_cast<const int4*>(src);
#else
            const struct { int32_t x, y, z, w; } v = {src[0], src[1], src[2], src[3]};
#endif
            dst[0] = ((uint32_t)v.x & 0xFFFFu) | ((uint32_t)v.y << 16);
            dst[1] = ((uint32_t)v.z & 0xFFFFu) | ((uint32_t)v.w << 16);
        });
    }

    // ring slots k, k + 1, k + 2 (a program's result) to row i of the outputs
    ZK_HD void store(int k, int32_t* ox, int32_t* oy, int32_t* oz, long i) {
        constexpr int W = NC * NL;
        const long off = i * R::LIMBS16;
        step(3 * W / 2, [&](int q) {
            const int c = q / (W / 2), w = 2 * (q % (W / 2));
            const uint32_t* src = s + (k + c) * W + w;
            int32_t* dst = (c == 0 ? ox : c == 1 ? oy : oz) + off + 2 * w;
#if defined(__CUDA_ARCH__)
            *reinterpret_cast<int4*>(dst) =
                make_int4((int32_t)(src[0] & 0xFFFFu), (int32_t)(src[0] >> 16),
                          (int32_t)(src[1] & 0xFFFFu), (int32_t)(src[1] >> 16));
#else
            dst[0] = (int32_t)(src[0] & 0xFFFFu);
            dst[1] = (int32_t)(src[0] >> 16);
            dst[2] = (int32_t)(src[1] & 0xFFFFu);
            dst[3] = (int32_t)(src[1] >> 16);
#endif
        });
    }

    // row i: cond ? P + Q : P (cond == nullptr: P + Q)
    ZK_HD void run_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                       const int32_t* x2, const int32_t* y2, const int32_t* z2,
                       const uint8_t* cond, int32_t* ox, int32_t* oy, int32_t* oz, long i) {
        const bool on = cond == nullptr || cond[i];
        load(x1, y1, z1, S_X1, i);
        if (on) load(x2, y2, z2, S_X2, i);
        store(on ? add() : S_X1, ox, oy, oz, i);
    }

    // row i doubled k times, kept in the slots between the doublings
    ZK_HD void run_double(const int32_t* x, const int32_t* y, const int32_t* z, int32_t* ox,
                          int32_t* oy, int32_t* oz, long i, int k) {
        load(x, y, z, S_X1, i);
        for (int j = 0; j < k; j++) dbl();
        store(S_X1, ox, oy, oz, i);
    }

    // row i: affine (x1, y1) + affine (x2, y2) with their infinity flags
    ZK_HD void run_aadd(const int32_t* x1, const int32_t* y1, const int32_t* x2,
                        const int32_t* y2, const uint8_t* inf1, const uint8_t* inf2,
                        int32_t* ox, int32_t* oy, int32_t* oz, long i) {
        load(x1, y1, nullptr, S_X1, i);
        load(x2, y2, nullptr, S_X2, i);
        store(aadd(inf1[i] != 0, inf2[i] != 0), ox, oy, oz, i);
    }
};

template <class R>
using AddGroup = Group<R, point_lanes<R>(), N_ADD_SLOTS>;
template <class R>
using DoubleGroup = Group<R, point_lanes<R>(), N_DBL_SLOTS>;
template <class R>
using AaddGroup = Group<R, aadd_lanes<R>(), N_AADD_SLOTS>;

}  // namespace zk
