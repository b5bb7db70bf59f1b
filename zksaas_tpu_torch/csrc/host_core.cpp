// Host build of the kernels' arithmetic (field.cuh) for the CPU tests:
// the same field and point code the CUDA kernels run, for the same rings
// and limb counts, looped over the batch on the CPU and exposed through the
// same C signatures as kernels.cu (prefix zkc_, no stream).  Built with plain g++ by
// zksaas_tpu_torch/kernels.py::host_core(); the tests hold it against the
// plain PyTorch versions, which are in turn held against the JAX package.

#include <stdint.h>

#include "field.cuh"

using namespace zk;

template <class R>
static void add_loop(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                     const int32_t* x2, const int32_t* y2, const int32_t* z2,
                     const uint8_t* cond, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                     const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    for (long i = 0; i < n; i++) {
        const long off = i * R::LIMBS16;
        typename R::E X, Y, Z, X2, Y2, Z2;
        load16(x1 + off, X);
        load16(y1 + off, Y);
        load16(z1 + off, Z);
        if (cond == nullptr || cond[i]) {
            load16(x2 + off, X2);
            load16(y2 + off, Y2);
            load16(z2 + off, Z2);
            pt_add<R>(X, Y, Z, X2, Y2, Z2, F);
        }
        store16(ox + off, X);
        store16(oy + off, Y);
        store16(oz + off, Z);
    }
}

template <class R>
static void double_loop(const int32_t* x, const int32_t* y, const int32_t* z, int32_t* ox,
                        int32_t* oy, int32_t* oz, long n, int k, const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    for (long i = 0; i < n; i++) {
        const long off = i * R::LIMBS16;
        typename R::E X, Y, Z;
        load16(x + off, X);
        load16(y + off, Y);
        load16(z + off, Z);
        for (int j = 0; j < k; j++) pt_double<R>(X, Y, Z, F);
        store16(ox + off, X);
        store16(oy + off, Y);
        store16(oz + off, Z);
    }
}

template <class R>
static void ring_loop(const int32_t* a, const int32_t* b, int32_t* out, long n,
                      const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    for (long i = 0; i < n; i++) {
        const long off = i * R::LIMBS16;
        typename R::E x, y;
        load16(a + off, x);
        if (b != nullptr) load16(b + off, y);
        store16(out + off, b != nullptr ? R::mul(x, y, F) : R::inv(x, F));
    }
}

template <class R>
static void aadd_loop(const int32_t* x1, const int32_t* y1, const int32_t* x2,
                      const int32_t* y2, const uint8_t* inf1, const uint8_t* inf2, int32_t* ox,
                      int32_t* oy, int32_t* oz, long n, const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    for (long i = 0; i < n; i++) {
        const long off = i * R::LIMBS16;
        typename R::E X1, Y1, X2, Y2, X3, Y3, Z3;
        load16(x1 + off, X1);
        load16(y1 + off, Y1);
        load16(x2 + off, X2);
        load16(y2 + off, Y2);
        pt_aadd<R>(X1, Y1, inf1[i] != 0, X2, Y2, inf2[i] != 0, X3, Y3, Z3, F);
        store16(ox + off, X3);
        store16(oy + off, Y3);
        store16(oz + off, Z3);
    }
}

template <class R>
static void madd_loop(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                      const int32_t* x2, const int32_t* y2, const uint8_t* cond, int32_t* ox,
                      int32_t* oy, int32_t* oz, long n, const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    for (long i = 0; i < n; i++) {
        const long off = i * R::LIMBS16;
        typename R::E X, Y, Z, X2, Y2;
        load16(x1 + off, X);
        load16(y1 + off, Y);
        load16(z1 + off, Z);
        if (cond[i]) {
            load16(x2 + off, X2);
            load16(y2 + off, Y2);
            pt_madd<R>(X, Y, Z, X2, Y2, F);
        }
        store16(ox + off, X);
        store16(oy + off, Y);
        store16(oz + off, Z);
    }
}

template <int NL>
static int montmul_loop(const int32_t* a, const int32_t* b, int32_t* out, long n,
                        const uint32_t* params) {
    FieldParams<NL> F = params_from<NL>(params);
    for (long i = 0; i < n; i++) {
        Fq<NL> x, y;
        load16(a + i * 2 * NL, x);
        load16(b + i * 2 * NL, y);
        store16(out + i * 2 * NL, fq_mul(x, y, F));
    }
    return 0;
}

// Calls fn with a value of the ring type that (nl, nr, ncoord) names.
template <class Fn>
static int with_ring(int nl, int nr, int ncoord, Fn&& fn) {
    switch (ring_id(nl, nr, ncoord)) {
        case G1_8: return fn(RingFq<8>{});
        case G1_12: return fn(RingFq<12>{});
        case G2_8_1: return fn(RingFq2<8, 1>{});
        case G2_12_1: return fn(RingFq2<12, 1>{});
        case G2_12_5: return fn(RingFq2<12, 5>{});
        default: return NOT_BUILT;
    }
}

extern "C" {

int zkc_montmul(int nl, const int32_t* a, const int32_t* b, int32_t* out, long n,
                const uint32_t* params) {
    if (nl == 8) return montmul_loop<8>(a, b, out, n, params);
    if (nl == 12) return montmul_loop<12>(a, b, out, n, params);
    return NOT_BUILT;
}

int zkc_point_add_if(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                     const int32_t* z1, const int32_t* x2, const int32_t* y2,
                     const int32_t* z2, const uint8_t* cond, int32_t* ox, int32_t* oy,
                     int32_t* oz, long n, const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        add_loop<decltype(r)>(x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, n, params);
        return 0;
    });
}

int zkc_point_double(int nl, int nr, int ncoord, const int32_t* x, const int32_t* y,
                     const int32_t* z, int32_t* ox, int32_t* oy, int32_t* oz, long n, int k,
                     const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        double_loop<decltype(r)>(x, y, z, ox, oy, oz, n, k, params);
        return 0;
    });
}

int zkc_ring_mul(int nl, int nr, int ncoord, const int32_t* a, const int32_t* b,
                 int32_t* out, long n, const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        ring_loop<decltype(r)>(a, b, out, n, params);
        return 0;
    });
}

int zkc_ring_inv(int nl, int nr, int ncoord, const int32_t* a, int32_t* out, long n,
                 const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        ring_loop<decltype(r)>(a, nullptr, out, n, params);
        return 0;
    });
}

int zkc_point_aadd(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                   const int32_t* x2, const int32_t* y2, const uint8_t* inf1,
                   const uint8_t* inf2, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                   const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        aadd_loop<decltype(r)>(x1, y1, x2, y2, inf1, inf2, ox, oy, oz, n, params);
        return 0;
    });
}

int zkc_point_madd_if(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                      const int32_t* z1, const int32_t* x2, const int32_t* y2,
                      const uint8_t* cond, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                      const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        madd_loop<decltype(r)>(x1, y1, z1, x2, y2, cond, ox, oy, oz, n, params);
        return 0;
    });
}

// The sort kernels' network, every substage as one loop over its pairs.
int zkc_sort_u32(int32_t* keys, long total, long n) {
    uint32_t* k = reinterpret_cast<uint32_t*>(keys);
    for (long kk = 2; kk <= n; kk <<= 1)
        for (long j = kk >> 1; j >= 1; j >>= 1)
            for (long t = 0; t < total / 2; t++) {
                const long lo = bitonic_lo(t, j);
                bitonic_cmpex(k[lo], k[lo + j], lo, n, kk);
            }
    return 0;
}

}  // extern "C"
