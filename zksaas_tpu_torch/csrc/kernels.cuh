// The point and ring kernels of the port (kernels 2-8 of kernels.cu), as
// templates over the coordinate ring, and the table of their launchers that
// each ring_*.cu source instantiates for one ring.  The rings are split
// over sources so that nvcc compiles them in parallel
// (zksaas_tpu_torch/kernels.py::cuda_lib).

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "add_group.cuh"
#include "field.cuh"

namespace zk {

inline unsigned blocks(long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// One coordinate row of 2 NL 16-bit limbs (4 NL bytes, a multiple of 16)
// as NL / 2 16-byte vector loads or stores.
template <int NL>
__device__ __forceinline__ void vload(const int32_t* src, Fq<NL>& a) {
    const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int q = 0; q < NL / 2; q++) {
        int4 w = s[q];
        a.v[2 * q] = ((uint32_t)w.x & 0xFFFFu) | ((uint32_t)w.y << 16);
        a.v[2 * q + 1] = ((uint32_t)w.z & 0xFFFFu) | ((uint32_t)w.w << 16);
    }
}

template <int NL>
__device__ __forceinline__ void vstore(int32_t* dst, const Fq<NL>& a) {
    int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int q = 0; q < NL / 2; q++) {
        int4 w;
        w.x = (int32_t)(a.v[2 * q] & 0xFFFFu);
        w.y = (int32_t)(a.v[2 * q] >> 16);
        w.z = (int32_t)(a.v[2 * q + 1] & 0xFFFFu);
        w.w = (int32_t)(a.v[2 * q + 1] >> 16);
        d[q] = w;
    }
}

template <int NL>
__device__ __forceinline__ void vload(const int32_t* src, Fq2<NL>& a) {
    vload(src, a.c0);
    vload(src + 2 * NL, a.c1);
}

template <int NL>
__device__ __forceinline__ void vstore(int32_t* dst, const Fq2<NL>& a) {
    vstore(dst, a.c0);
    vstore(dst + 2 * NL, a.c1);
}

// Kernels 2-4, 7 and 8, the grouped point programs of add_group.cuh: one group
// of Grp::G lanes per point (row); each group's slots are its part of the
// block's dynamic shared memory.
constexpr int GROUP_THREADS = 128;

// This thread's group and the row it works on (i >= n: none).
template <class Grp>
__device__ __forceinline__ Grp block_group(const typename Grp::P& F, long& i) {
    extern __shared__ int4 group_smem[];
    constexpr int G = Grp::G;
    const int grp = threadIdx.x / G, lane = threadIdx.x % G;
    i = (long)blockIdx.x * (GROUP_THREADS / G) + grp;
    const unsigned mask = ((G == 32 ? 0u : 1u << G) - 1u) << ((threadIdx.x & 31) / G * G);
    return Grp{reinterpret_cast<uint32_t*>(group_smem) + grp * Grp::WORDS, F, lane, mask};
}

// Kernels 2-3: cond ? P + Q : P (cond == nullptr: P + Q).
template <class R>
__global__ void __launch_bounds__(GROUP_THREADS)
add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
           const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
           const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
           const uint8_t* __restrict__ cond, int32_t* __restrict__ ox,
           int32_t* __restrict__ oy, int32_t* __restrict__ oz, long n, typename R::P F) {
    long i;
    AddGroup<R> g = block_group<AddGroup<R>>(F, i);
    if (i >= n) return;  // the whole group: the others' barriers do not wait on it
    g.run_add(x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, i);
}

// Kernel 4: k doublings.
template <class R>
__global__ void __launch_bounds__(GROUP_THREADS)
double_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
              const int32_t* __restrict__ z, int32_t* __restrict__ ox,
              int32_t* __restrict__ oy, int32_t* __restrict__ oz, long n, int k,
              typename R::P F) {
    long i;
    DoubleGroup<R> g = block_group<DoubleGroup<R>>(F, i);
    if (i >= n) return;
    g.run_double(x, y, z, ox, oy, oz, i, k);
}

// Kernel 7: affine + affine -> Jacobian, with infinity flags.
template <class R>
__global__ void __launch_bounds__(GROUP_THREADS)
aadd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
            const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
            const uint8_t* __restrict__ inf1, const uint8_t* __restrict__ inf2,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
            long n, typename R::P F) {
    long i;
    AaddGroup<R> g = block_group<AaddGroup<R>>(F, i);
    if (i >= n) return;
    g.run_aadd(x1, y1, x2, y2, inf1, inf2, ox, oy, oz, i);
}

// Kernel 8: cond ? P + Q_affine : P.
template <class R>
__global__ void __launch_bounds__(GROUP_THREADS)
madd_if_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const uint8_t* __restrict__ cond,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               long n, typename R::P F) {
    long i;
    MaddGroup<R> g = block_group<MaddGroup<R>>(F, i);
    if (i >= n) return;
    g.run_madd_if(x1, y1, z1, x2, y2, cond, ox, oy, oz, i);
}

// Kernel 5: ring_mul, on carry chains, by the width and the ring
// (launch_ring_mul; the crossovers are kernel_ab's, PERF.md):
// - the tiled kernel: a block copies its tile of RING_ROWS rows of a and b
//   into shared memory, consecutive threads on consecutive 16 bytes
//   (cp.async, no registers), so every warp load is whole sectors; the
//   products are written over the tile's rows of a, and the block copies
//   the tile out the same way.  A row takes CHUNKS + 1 16-byte chunks of
//   shared memory: with that odd stride the 8 threads of each phase of a
//   warp's 16-byte row reads and writes fall in distinct banks.  Several
//   blocks a SM overlap one block's copies with another's products.
//   PARTS threads a row: 1, each the row's whole product; or, for Fq2 up
//   to RING_SPLIT_MAX rows, where a launch costs one row's latency more
//   than its bytes, 3, one Karatsuba Fq product each (a0 b0, a1 b1,
//   (a0 + a1)(b0 + b1)) into the row's three slots, then two combine;
// - the direct kernel, for Fq up to RING_DIRECT_MAX rows: one thread a
//   row, reading it with 16-byte loads straight from device memory (or
//   from L2, where the inversion tree's previous level left it), which
//   saves the tile's round trip and barriers.
constexpr int RING_ROWS = 64;
constexpr long RING_SPLIT_MAX = 1 << 16;
constexpr long RING_DIRECT_MAX = 1 << 17;

template <class R, int PARTS>
struct RingTile {
    static constexpr int CHUNKS = R::LIMBS16 / 4;  // 16 bytes of int32 limbs
    static constexpr int STRIDE = CHUNKS + 1;
    static constexpr int H = R::NL / 2;  // chunks of one Fq coordinate
    static constexpr int SLOTS = PARTS == 3 ? 3 * (H + 1) : 0;  // a row's products
    static constexpr int SMEM = (2 * STRIDE + SLOTS) * RING_ROWS * 16;
    static_assert(PARTS == 1 || (PARTS == 3 && CHUNKS == 2 * H), "3 parts only in Fq2");
    static_assert(SMEM <= 48 * 1024, "a block's tiles must fit the default shared memory");
};

__device__ __forceinline__ void cp_async16(int4* dst, const int4* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

template <int NL>
__device__ __forceinline__ void sload(const int4* s, Fq<NL>& a) {
    vload(reinterpret_cast<const int32_t*>(s), a);
}

template <int NL>
__device__ __forceinline__ void sload(const int4* s, Fq2<NL>& a) {
    sload(s, a.c0);
    sload(s + NL / 2, a.c1);
}

template <int NL>
__device__ __forceinline__ void sstore(int4* s, const Fq<NL>& a) {
    vstore(reinterpret_cast<int32_t*>(s), a);
}

template <int NL>
__device__ __forceinline__ void sstore(int4* s, const Fq2<NL>& a) {
    sstore(s, a.c0);
    sstore(s + NL / 2, a.c1);
}

template <class R, int PARTS>
__global__ void __launch_bounds__(PARTS * RING_ROWS)
ring_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long n, typename R::P F) {
    typedef RingTile<R, PARTS> T;
    constexpr int BLOCK = PARTS * RING_ROWS;
    extern __shared__ int4 tile[];
    int4* ta = tile;
    int4* tb = tile + RING_ROWS * T::STRIDE;
    const long row0 = (long)blockIdx.x * RING_ROWS;
    const int chunks = (n - row0 < RING_ROWS ? (int)(n - row0) : RING_ROWS) * T::CHUNKS;
    const int4* ga = reinterpret_cast<const int4*>(a) + row0 * T::CHUNKS;
    const int4* gb = reinterpret_cast<const int4*>(b) + row0 * T::CHUNKS;
    int4* go = reinterpret_cast<int4*>(out) + row0 * T::CHUNKS;
    for (int c = (int)threadIdx.x; c < chunks; c += BLOCK) {
        const int at = c + c / T::CHUNKS;  // row c / CHUNKS, chunk c % CHUNKS
        cp_async16(ta + at, ga + c);
        cp_async16(tb + at, gb + c);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const int row = (int)threadIdx.x / PARTS, part = (int)threadIdx.x % PARTS;
    const bool live = row * T::CHUNKS < chunks;
    int4* ra = ta + row * T::STRIDE;
    const int4* rb = tb + row * T::STRIDE;
    if constexpr (PARTS == 1) {
        if (live) {
            typename R::E x, y;
            sload(ra, x);
            sload(rb, y);
            sstore(ra, R::mul_cc(x, y, F));
        }
    } else {
        constexpr int H = T::H;
        int4* slot = tb + RING_ROWS * T::STRIDE + (int)threadIdx.x * (H + 1);
        if (live) {
            Fq<R::NL> x, y;
            if (part < 2) {
                sload(ra + part * H, x);
                sload(rb + part * H, y);
            } else {
                Fq<R::NL> x1, y1;
                sload(ra, x);
                sload(ra + H, x1);
                sload(rb, y);
                sload(rb + H, y1);
                x = cc_add(x, x1, F);
                y = cc_add(y, y1, F);
            }
            sstore(slot, cc_mont(x, y, F));
        }
        __syncthreads();
        if (live && part < 2) {  // c0 = t0 - nr t1, c1 = t2 - t0 - t1
            const int4* t = slot - part * (H + 1);
            Fq<R::NL> t0, t1, r;
            sload(t, t0);
            sload(t + H + 1, t1);
            if (part == 0) {
                r = cc_sub(t0, cc_neg_nr<R::NEG_NR>(t1, F), F);
            } else {
                Fq<R::NL> t2;
                sload(t + 2 * (H + 1), t2);
                r = cc_sub(cc_sub(t2, t0, F), t1, F);
            }
            sstore(ra + part * H, r);
        }
    }
    __syncthreads();
    for (int c = (int)threadIdx.x; c < chunks; c += BLOCK) go[c] = ta[c + c / T::CHUNKS];
}

template <class R>
__global__ void __launch_bounds__(RING_ROWS)
ring_mul_direct_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                       int32_t* __restrict__ out, long n, typename R::P F) {
    const long i = (long)blockIdx.x * RING_ROWS + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E x, y;
    vload(a + off, x);
    vload(b + off, y);
    vstore(out + off, R::mul_cc(x, y, F));
}

// Kernel 6: ring_inv, one thread an element, the safegcd batches of a warp
// in lockstep until the vote finds every lane's g at 0.  Lanes past n
// invert 0, which is done from the start, so every warp is whole for the
// vote.
constexpr int INV_THREADS = 32;

template <class R>
__global__ void __launch_bounds__(INV_THREADS)
ring_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, long n,
                typename R::P F, InvParams<R::NL> I) {
    const long i = (long)blockIdx.x * INV_THREADS + threadIdx.x;
    const long off = i * R::LIMBS16;
    typename R::E x = R::zero();
    if (i < n) vload(a + off, x);
    FqInverse<R::NL> s(R::inv_norm(x, F), I);
    for (int b = 0; b < FqInverse<R::NL>::MAX_BATCHES && !__all_sync(0xffffffffu, s.done()); b++)
        s.step(I);
    if (i < n) vstore(out + off, R::inv_finish(x, s.result(F, I), F));
}

// ---------------------------------------------------------------------------
// launchers: on the caller's stream, allocating nothing, returning
// cudaGetLastError()
// ---------------------------------------------------------------------------

// A grouped kernel over n rows: GROUP_THREADS / G rows a block.
template <class Grp, class... KA, class... A>
int launch_groups(void (*kernel)(KA...), long n, cudaStream_t s, A... args) {
    constexpr int per_block = GROUP_THREADS / Grp::G;
    constexpr size_t smem = per_block * Grp::WORDS * sizeof(uint32_t);
    static_assert(smem <= 48 * 1024, "a block's slots must fit the default shared memory");
    kernel<<<blocks(n, per_block), GROUP_THREADS, smem, s>>>(args...);
    return (int)cudaGetLastError();
}

template <class R>
int launch_add(const int32_t* x1, const int32_t* y1, const int32_t* z1, const int32_t* x2,
               const int32_t* y2, const int32_t* z2, const uint8_t* cond, int32_t* ox,
               int32_t* oy, int32_t* oz, long n, const uint32_t* params, cudaStream_t s) {
    return launch_groups<AddGroup<R>>(&add_kernel<R>, n, s, x1, y1, z1, x2, y2, z2, cond, ox,
                                      oy, oz, n, params_from<R::NL>(params));
}

template <class R>
int launch_double(const int32_t* x, const int32_t* y, const int32_t* z, int32_t* ox,
                  int32_t* oy, int32_t* oz, long n, int k, const uint32_t* params,
                  cudaStream_t s) {
    return launch_groups<DoubleGroup<R>>(&double_kernel<R>, n, s, x, y, z, ox, oy, oz, n, k,
                                         params_from<R::NL>(params));
}

template <class R, int PARTS>
int launch_ring_mul_parts(const int32_t* a, const int32_t* b, int32_t* out, long n,
                          const uint32_t* params, cudaStream_t s) {
    ring_mul_kernel<R, PARTS><<<blocks(n, RING_ROWS), PARTS * RING_ROWS,
                                RingTile<R, PARTS>::SMEM, s>>>(a, b, out, n,
                                                               params_from<R::NL>(params));
    return (int)cudaGetLastError();
}

template <class R>
int launch_ring_mul(const int32_t* a, const int32_t* b, int32_t* out, long n,
                    const uint32_t* params, cudaStream_t s) {
    if constexpr (R::LIMBS16 == 2 * R::NL) {  // Fq
        if (n <= RING_DIRECT_MAX) {
            ring_mul_direct_kernel<R><<<blocks(n, RING_ROWS), RING_ROWS, 0, s>>>(
                a, b, out, n, params_from<R::NL>(params));
            return (int)cudaGetLastError();
        }
    } else if (n <= RING_SPLIT_MAX) {
        return launch_ring_mul_parts<R, 3>(a, b, out, n, params, s);
    }
    return launch_ring_mul_parts<R, 1>(a, b, out, n, params, s);
}

template <class R>
int launch_ring_inv(const int32_t* a, int32_t* out, long n, const uint32_t* params,
                    cudaStream_t s) {
    ring_inv_kernel<R><<<blocks(n, INV_THREADS), INV_THREADS, 0, s>>>(
        a, out, n, params_from<R::NL>(params), inv_params_from<R::NL>(params));
    return (int)cudaGetLastError();
}

template <class R>
int launch_aadd(const int32_t* x1, const int32_t* y1, const int32_t* x2, const int32_t* y2,
                const uint8_t* inf1, const uint8_t* inf2, int32_t* ox, int32_t* oy,
                int32_t* oz, long n, const uint32_t* params, cudaStream_t s) {
    return launch_groups<AaddGroup<R>>(&aadd_kernel<R>, n, s, x1, y1, x2, y2, inf1, inf2, ox,
                                       oy, oz, n, params_from<R::NL>(params));
}

template <class R>
int launch_madd_if(const int32_t* x1, const int32_t* y1, const int32_t* z1, const int32_t* x2,
                   const int32_t* y2, const uint8_t* cond, int32_t* ox, int32_t* oy,
                   int32_t* oz, long n, const uint32_t* params, cudaStream_t s) {
    return launch_groups<MaddGroup<R>>(&madd_if_kernel<R>, n, s, x1, y1, z1, x2, y2, cond, ox,
                                       oy, oz, n, params_from<R::NL>(params));
}

// The launchers of one coordinate ring.  add_if with cond == nullptr is the
// plain add.
struct RingOps {
    int (*add_if)(const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                  const int32_t*, const int32_t*, const uint8_t*, int32_t*, int32_t*,
                  int32_t*, long, const uint32_t*, cudaStream_t);
    int (*dbl)(const int32_t*, const int32_t*, const int32_t*, int32_t*, int32_t*, int32_t*,
               long, int, const uint32_t*, cudaStream_t);
    int (*ring_mul)(const int32_t*, const int32_t*, int32_t*, long, const uint32_t*,
                    cudaStream_t);
    int (*ring_inv)(const int32_t*, int32_t*, long, const uint32_t*, cudaStream_t);
    int (*aadd)(const int32_t*, const int32_t*, const int32_t*, const int32_t*, const uint8_t*,
                const uint8_t*, int32_t*, int32_t*, int32_t*, long, const uint32_t*,
                cudaStream_t);
    int (*madd_if)(const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                   const int32_t*, const uint8_t*, int32_t*, int32_t*, int32_t*, long,
                   const uint32_t*, cudaStream_t);
};

template <class R>
RingOps ops_of() {
    return RingOps{&launch_add<R>,      &launch_double<R>, &launch_ring_mul<R>,
                   &launch_ring_inv<R>, &launch_aadd<R>,   &launch_madd_if<R>};
}

// Defined one per ring_*.cu source, indexed by RingId.
extern const RingOps OPS_G1_8, OPS_G1_12, OPS_G2_8_1, OPS_G2_12_1, OPS_G2_12_5;

}  // namespace zk
