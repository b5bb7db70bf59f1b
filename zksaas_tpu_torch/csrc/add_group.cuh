// The grouped point programs of kernels 2-4, 7 and 8 (point_add /
// point_add_if, point_double(k), point_aadd, point_madd_if): each runs on a
// group of G lanes that share one point, on the carry-chain Fq arithmetic of
// field.cuh (cc_mul, cc_add, cc_sub).  They are the port's only point
// arithmetic.
//
// Replaces the one-thread-per-point formulas of zksaas_tpu/curves/fused.py:
// _add_core (_add_call, _add_select_call), _double_core applied k times
// (_double_call), _aadd_core (_aadd_call) and _madd_core (_madd_select_call).
// The main path adds and doubles 8-128 points a launch (the binary scalar
// muls of the king's mat-vecs and of the r/s shares, one double and one
// add-if per scalar bit; Pippenger's window fold, 8-128 points doubled 8-128
// times), so such a launch costs the latency of one point's chain of
// dependent Fq products: 16 (add) or 7 (double) in G1, 48 or 21 in G2, in
// series on one thread.  Here the G lanes of a group compute the independent
// products of each level of the formula's dependency graph at once (in G2
// the three Fq products of each Karatsuba Fq2 product are separate items),
// so an add is 5 products deep in G1 and 8-10 in G2, a mixed add 5, a
// doubling and an affine+affine add 3.  Pippenger's tree level 1 runs the
// affine+affine add over 2^21-2^22 pairs, where it is bound by throughput:
// there the lanes keep each thread's live state to one product's operands,
// so no instance needs the 255 registers and spills of a whole point per
// thread.  The lanes pass operands through shared memory (one slot array
// per group, synchronised with __syncwarp over the group's lanes).  A group
// decides the special cases (infinity operands and flags, cond false,
// P == Q, P == -Q) on values every lane reads, so it never diverges; P == Q
// runs the doubling program.
//
// On the host (g++, csrc/host_core.cpp) the same programs run with the
// lanes looped serially and the carry flag emulated in C, so the CPU tests
// check the device's algorithm step for step; only the mapping of each
// carry-chain primitive to its PTX instruction is not exercised there.

#pragma once
#include <stdint.h>

#include "field.cuh"

namespace zk {

// ---------------------------------------------------------------------------
// the grouped point programs
// ---------------------------------------------------------------------------

// Lanes per point of the complete add, the double and the mixed add: 4 in
// G1 (the widest level has 4 products in the add, 3 in the double and the
// mixed add), 8 in G2 (12 and 9 Fq products).  (The mixed add with 2 lanes
// in G1 or 4 in G2 was slower on the main path's inputs: PERF.md.)
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
    // mixed: Z1Z1 = Z1^2, T = y2 Z1, U2 = x2 Z1Z1, S2 = T Z1Z1, H = U2 - X1,
    // r = 2 (S2 - Y1), 2H, I = (2H)^2, r^2, Z1 H, J = H I, V = X1 I,
    // W = V - X3, r W, Y1 J; its P == Q branch runs the doubling
    S_MZZ = S_A, S_MT = S_B, S_MU2 = S_C, S_MS2 = S_D, S_MH = S_U1, S_MR = S_U2,
    S_MH2 = S_S1, S_MI = S_A, S_MRSQ = S_B, S_MZH = S_C, S_MJ = S_D, S_MV = S_S2,
    S_MW = S_A, S_MY3A = S_B, S_MSJ = S_C,
    N_MADD_SLOTS = N_DBL_SLOTS,
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

    ZK_HD E neg_nr(const E& x) const { return cc_neg_nr<NR>(x, F); }

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

    // (S_X1, S_Y1, S_Z1) doubled in place: fused.py::_double_core's
    // dbl-2009-l, 3 products deep.  The input is read only by the first two
    // steps, so the later ones write the result over it.
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

    // Jacobian P (slots S_X1, S_Y1, S_Z1; Z1 != 0) + affine Q = (x2, y2)
    // (S_X2, S_Y2), complete, as fused.py::_madd_core computes it: P == Q
    // doubles Q lifted to (x2, y2, 1), P == -Q gives (one, one, zero).  (P
    // at infinity is run_madd_if's.)  11 ring products, 5 levels of 2-3.
    // Returns the slot of the result's X.
    ZK_HD int madd() {
        static_assert(NS >= N_MADD_SLOTS, "the mixed add needs N_MADD_SLOTS slots");
        // Z1Z1 = Z1^2, T = y2 Z1; U2 = x2 Z1Z1, S2 = T Z1Z1
        muls<2>({S_Z1, S_Y2}, {S_Z1, S_Z1}, {S_MZZ, S_MT});
        muls<2>({S_X2, S_MT}, {S_MZZ, S_MZZ}, {S_MU2, S_MS2});
        // H = U2 - X1, r = 2 (S2 - Y1), 2H
        lin(3, [&](int op, int c) {
            if (op == 1) {
                st(S_MR, c, cc_dbl(cc_sub(ld(S_MS2, c), ld(S_Y1, c), F), F));
            } else {
                const E h = cc_sub(ld(S_MU2, c), ld(S_X1, c), F);
                st(op == 0 ? S_MH : S_MH2, c, op == 0 ? h : cc_dbl(h, F));
            }
        });
        if (is_zero(S_MH)) {
            if (is_zero(S_MR)) {
                lin(3, [&](int op, int c) {  // Q lifted to (x2, y2, 1)
                    st(S_X1 + op, c,
                       op < 2 ? ld(S_X2 + op, c) : c == 0 ? fq_one(F) : fq_zero<NL>());
                });
                dbl();
            } else {
                set(S_X1, 3, 2);
            }
            return S_X1;
        }
        // I = (2H)^2, r^2, Z1 H; J = H I, V = X1 I
        muls<3>({S_MH2, S_MR, S_Z1}, {S_MH2, S_MR, S_MH}, {S_MI, S_MRSQ, S_MZH});
        muls<2>({S_MH, S_X1}, {S_MI, S_MI}, {S_MJ, S_MV});
        // X3 = r^2 - J - 2V, W = V - X3, Z3 = 2 Z1 H (X1 and Z1 are read no more)
        lin(2, [&](int op, int c) {
            if (op == 0) {
                const E v = ld(S_MV, c);
                const E x3 = cc_sub(cc_sub(ld(S_MRSQ, c), ld(S_MJ, c), F), cc_dbl(v, F), F);
                st(S_X1, c, x3);
                st(S_MW, c, cc_sub(v, x3, F));
            } else {
                st(S_Z1, c, cc_dbl(ld(S_MZH, c), F));
            }
        });
        // Y3 = r W - 2 Y1 J
        muls<2>({S_MR, S_Y1}, {S_MW, S_MJ}, {S_MY3A, S_MSJ});
        lin(1, [&](int, int c) {
            st(S_Y1, c, cc_sub(ld(S_MY3A, c), cc_dbl(ld(S_MSJ, c), F), F));
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

    // row i: cond ? P + Q : P, Q affine and never at infinity.  cond false
    // copies P and never reads Q; cond true reads Z1 with Q, and P at
    // infinity (the only case of Pippenger's level-0 queries, whose
    // accumulators start there) gives (x2, y2, 1) without reading X1, Y1.
    ZK_HD void run_madd_if(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                           const int32_t* x2, const int32_t* y2, const uint8_t* cond,
                           int32_t* ox, int32_t* oy, int32_t* oz, long i) {
        static_assert(S_X2 == S_Z1 + 1 && S_Y2 == S_Z1 + 2, "Z1, x2, y2 load as one");
        if (!cond[i]) {
            load(x1, y1, z1, S_X1, i);
            store(S_X1, ox, oy, oz, i);
            return;
        }
        load(z1, x2, y2, S_Z1, i);
        if (is_zero(S_Z1)) {
            set(S_Z2, 1, 1);
            store(S_X2, ox, oy, oz, i);
            return;
        }
        load(x1, y1, nullptr, S_X1, i);
        store(madd(), ox, oy, oz, i);
    }
};

template <class R>
using AddGroup = Group<R, point_lanes<R>(), N_ADD_SLOTS>;
template <class R>
using DoubleGroup = Group<R, point_lanes<R>(), N_DBL_SLOTS>;
template <class R>
using AaddGroup = Group<R, aadd_lanes<R>(), N_AADD_SLOTS>;
template <class R>
using MaddGroup = Group<R, point_lanes<R>(), N_MADD_SLOTS>;

}  // namespace zk
