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

constexpr int THREADS = 128;

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

// Kernels 2-4 and 7, the grouped point programs of add_group.cuh: one group
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

template <class R>
__global__ void __launch_bounds__(THREADS)
ring_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long n, typename R::P F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E x, y;
    vload(a + off, x);
    vload(b + off, y);
    vstore(out + off, R::mul(x, y, F));
}

template <class R>
__global__ void __launch_bounds__(THREADS)
ring_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, long n,
                typename R::P F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E x;
    vload(a + off, x);
    vstore(out + off, R::inv(x, F));
}

template <class R>
__global__ void __launch_bounds__(THREADS)
madd_if_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const uint8_t* __restrict__ cond,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               long n, typename R::P F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E X, Y, Z;
    vload(x1 + off, X);
    vload(y1 + off, Y);
    vload(z1 + off, Z);
    if (cond[i]) {
        typename R::E X2, Y2;
        vload(x2 + off, X2);
        vload(y2 + off, Y2);
        pt_madd<R>(X, Y, Z, X2, Y2, F);
    }
    vstore(ox + off, X);
    vstore(oy + off, Y);
    vstore(oz + off, Z);
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

template <class R>
int launch_ring_mul(const int32_t* a, const int32_t* b, int32_t* out, long n,
                    const uint32_t* params, cudaStream_t s) {
    ring_mul_kernel<R><<<blocks(n, THREADS), THREADS, 0, s>>>(a, b, out, n,
                                                              params_from<R::NL>(params));
    return (int)cudaGetLastError();
}

template <class R>
int launch_ring_inv(const int32_t* a, int32_t* out, long n, const uint32_t* params,
                    cudaStream_t s) {
    ring_inv_kernel<R><<<blocks(n, THREADS), THREADS, 0, s>>>(a, out, n,
                                                              params_from<R::NL>(params));
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
    madd_if_kernel<R><<<blocks(n, THREADS), THREADS, 0, s>>>(x1, y1, z1, x2, y2, cond, ox, oy,
                                                             oz, n, params_from<R::NL>(params));
    return (int)cudaGetLastError();
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
