// Hand-written Hopper (sm_90a) kernels of the PyTorch port, with a plain C
// interface for ctypes (zksaas_tpu_torch/kernels.py builds and loads it).
//
// Kernel 1, montmul: replaces zksaas_tpu/fields/pallas_mul.py::_mul_call
// (montmul_pallas), the TPU path of Field.mul.
//   Bound: 3 x 16 int32 limbs = 192 B moved per element against ~130
//   32-bit multiply-adds, so at large batches the card's 3.35 TB/s
//   memory, not its integer units, sets the floor.
//   Design: one thread per element, CIOS over 8 32-bit limbs held in
//   registers; each thread reads its two 64 B rows with 16 B vector loads
//   and writes one row the same way, so a warp touches whole sectors.
//
// Kernels 2-4, point_add / point_add_if / point_double(k): replace
// zksaas_tpu/curves/fused.py::_add_call (fused_add), ::_add_select_call
// (fused_add_select) and ::_double_call (fused_double).
//   Bound: 12-25 Montgomery products per element (x3 in G2) against
//   192-576 B moved, so these are bound by 32-bit integer multiply
//   throughput, not memory.
//   Design: one thread per point, the whole formula in registers; the
//   special cases (infinity operands, P == Q, P == -Q, cond false) are
//   branches, which diverge only on the rare lanes that take them, so the
//   doubling inside the complete add is not paid on every lane as the
//   TPU's selects pay it.  __launch_bounds__(128) lets the G2 formulas,
//   which keep ~30 Fq2 temporaries live, spill to L1 instead of failing.
//
// Kernels 5-9 run the bucket-Pippenger MSM (curves/pippenger.py):
//
// Kernel 5, ring_mul: replaces zksaas_tpu/curves/fused.py::_fmul_call
//   (pfmul), the product of the batch-inversion tree and the affine
//   conversion.  Bound: memory (192 B against one Montgomery product in
//   Fq, as montmul; 384 B against three in Fq2).  Design: as montmul, one
//   thread per element; the Fq2 Karatsuba product is one launch instead
//   of three montmuls and the add/sub glue between them.
//
// Kernel 6, ring_inv: replaces fused.py::_finv_call (pfinv), the root of
//   the inversion tree (at most 1,024 elements).  Bound: the serial chain
//   of ~380 Montgomery products per element; at 1,024 elements only 8
//   blocks run, so its time is that chain's latency, not a rate.  Design:
//   one thread per element; the exponent p - 2 comes from the field's
//   params in registers (the TPU read its bits from SMEM).
//
// Kernel 7, point_aadd: replaces fused.py::_aadd_call (paddaa), tree level
//   1 over the sorted affine leaves.  Bound: memory by count (4
//   coordinates and 2 flags in, 3 out, against 6 products per lane, x3
//   in G2), though the formula's dependent products keep it well above
//   that.  Design: as the complete add, the special cases (infinity flags,
//   P == Q, P == -Q) are branches taken only by the lanes that need them.
//
// Kernel 8, point_madd_if: replaces fused.py::_madd_select_call
//   (pmadd_if), the level-0 suffix queries.  Bound and design as the
//   add-if: a lane whose cond is false reads and writes P only.
//
// Kernel 9, sort_u32: replaces zksaas_tpu/fields/sortperm.py::_stage_call
//   (one bitonic k-stage, launched in sequence by _sort_call), the
//   (window | digit | slot) key sort.  Bound: the n/2 x log2(n)(log2(n)+1)/2
//   compare-exchanges (the keys are read and written once), in practice
//   one pass over the keys per substage.  Design: the TPU kept the whole
//   array in VMEM and ran a stage per launch; the card has no such memory,
//   so every substage with a distance j >= TILE is one launch over device
//   memory (at the flagship's 2^23 keys, 32 MB, which stays in the 50 MB
//   L2), and one launch with TILE keys per block in shared memory finishes
//   the substages j < TILE of a stage (the first launch runs all stages
//   k <= TILE).  Rows of n keys are sorted independently, so a batch of
//   parties is one call.  Keys compare as unsigned 32-bit values.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() so the wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace zk;

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void vload(const int32_t* src, Fq& a) {
    const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int q = 0; q < NL / 2; q++) {
        int4 w = s[q];
        a.v[2 * q] = ((uint32_t)w.x & 0xFFFFu) | ((uint32_t)w.y << 16);
        a.v[2 * q + 1] = ((uint32_t)w.z & 0xFFFFu) | ((uint32_t)w.w << 16);
    }
}

__device__ __forceinline__ void vstore(int32_t* dst, const Fq& a) {
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

__device__ __forceinline__ void vload(const int32_t* src, Fq2& a) {
    vload(src, a.c0);
    vload(src + 2 * NL, a.c1);
}

__device__ __forceinline__ void vstore(int32_t* dst, const Fq2& a) {
    vstore(dst, a.c0);
    vstore(dst + 2 * NL, a.c1);
}

__global__ void __launch_bounds__(256)
montmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long n, FieldParams F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fq x, y;
    vload(a + i * 2 * NL, x);
    vload(b + i * 2 * NL, y);
    vstore(out + i * 2 * NL, fq_mul(x, y, F));
}

template <class R>
__global__ void __launch_bounds__(THREADS)
add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
           const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
           const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
           const uint8_t* __restrict__ cond, int32_t* __restrict__ ox,
           int32_t* __restrict__ oy, int32_t* __restrict__ oz, long n, FieldParams F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E X, Y, Z;
    vload(x1 + off, X);
    vload(y1 + off, Y);
    vload(z1 + off, Z);
    if (cond == nullptr || cond[i]) {
        typename R::E X2, Y2, Z2;
        vload(x2 + off, X2);
        vload(y2 + off, Y2);
        vload(z2 + off, Z2);
        pt_add<R>(X, Y, Z, X2, Y2, Z2, F);
    }
    vstore(ox + off, X);
    vstore(oy + off, Y);
    vstore(oz + off, Z);
}

template <class R>
__global__ void __launch_bounds__(THREADS)
double_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
              const int32_t* __restrict__ z, int32_t* __restrict__ ox,
              int32_t* __restrict__ oy, int32_t* __restrict__ oz, long n, int k,
              FieldParams F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E X, Y, Z;
    vload(x + off, X);
    vload(y + off, Y);
    vload(z + off, Z);
    for (int j = 0; j < k; j++) pt_double<R>(X, Y, Z, F);
    vstore(ox + off, X);
    vstore(oy + off, Y);
    vstore(oz + off, Z);
}

template <class R>
__global__ void __launch_bounds__(THREADS)
ring_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long n, FieldParams F) {
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
                FieldParams F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E x;
    vload(a + off, x);
    vstore(out + off, R::inv(x, F));
}

template <class R>
__global__ void __launch_bounds__(THREADS)
aadd_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
            const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
            const uint8_t* __restrict__ inf1, const uint8_t* __restrict__ inf2,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
            long n, FieldParams F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long off = i * R::LIMBS16;
    typename R::E X1, Y1, X2, Y2, X3, Y3, Z3;
    vload(x1 + off, X1);
    vload(y1 + off, Y1);
    vload(x2 + off, X2);
    vload(y2 + off, Y2);
    pt_aadd<R>(X1, Y1, inf1[i] != 0, X2, Y2, inf2[i] != 0, X3, Y3, Z3, F);
    vstore(ox + off, X3);
    vstore(oy + off, Y3);
    vstore(oz + off, Z3);
}

template <class R>
__global__ void __launch_bounds__(THREADS)
madd_if_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const uint8_t* __restrict__ cond,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               long n, FieldParams F) {
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

constexpr long SORT_TILE = 2048;  // keys per block in shared memory
constexpr int SORT_THREADS = SORT_TILE / 2;

// Stages k0..k1 (k0 <= k1), each over its substages j < SORT_TILE, on one
// tile of SORT_TILE keys in shared memory; one thread per pair.
__global__ void __launch_bounds__(SORT_THREADS)
sort_tile_kernel(uint32_t* __restrict__ keys, long total, long n, long k0, long k1) {
    __shared__ uint32_t s[SORT_TILE];
    const long base = (long)blockIdx.x * SORT_TILE;
    const int t = threadIdx.x;
    for (int q = t; q < SORT_TILE; q += SORT_THREADS)
        if (base + q < total) s[q] = keys[base + q];
    __syncthreads();
    for (long k = k0; k <= k1; k <<= 1) {
        for (long j = (k >> 1) < SORT_TILE / 2 ? (k >> 1) : SORT_TILE / 2; j >= 1; j >>= 1) {
            const long lo = bitonic_lo(t, j);
            if (base + lo < total) bitonic_cmpex(s[lo], s[lo + j], base + lo, n, k);
            __syncthreads();
        }
    }
    for (int q = t; q < SORT_TILE; q += SORT_THREADS)
        if (base + q < total) keys[base + q] = s[q];
}

// One substage (k, j), j >= SORT_TILE, over device memory; one thread per pair.
__global__ void __launch_bounds__(256)
sort_step_kernel(uint32_t* __restrict__ keys, long total, long n, long k, long j) {
    const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total / 2) return;
    const long lo = bitonic_lo(t, j);
    uint32_t a = keys[lo], b = keys[lo + j];
    bitonic_cmpex(a, b, lo, n, k);
    keys[lo] = a;
    keys[lo + j] = b;
}

inline unsigned blocks(long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <class R>
int launch_add(const int32_t* x1, const int32_t* y1, const int32_t* z1, const int32_t* x2,
               const int32_t* y2, const int32_t* z2, const uint8_t* cond, int32_t* ox,
               int32_t* oy, int32_t* oz, long n, const uint32_t* params, void* stream) {
    add_kernel<R><<<blocks(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, n, params_from(params));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int zk_montmul(const int32_t* a, const int32_t* b, int32_t* out, long n,
               const uint32_t* params, void* stream) {
    montmul_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(a, b, out, n,
                                                                      params_from(params));
    return (int)cudaGetLastError();
}

int zk_point_add(int ncoord, const int32_t* x1, const int32_t* y1, const int32_t* z1,
                 const int32_t* x2, const int32_t* y2, const int32_t* z2, int32_t* ox,
                 int32_t* oy, int32_t* oz, long n, const uint32_t* params, void* stream) {
    if (ncoord == 1)
        return launch_add<RingFq>(x1, y1, z1, x2, y2, z2, nullptr, ox, oy, oz, n, params, stream);
    return launch_add<RingFq2>(x1, y1, z1, x2, y2, z2, nullptr, ox, oy, oz, n, params, stream);
}

int zk_point_add_if(int ncoord, const int32_t* x1, const int32_t* y1, const int32_t* z1,
                    const int32_t* x2, const int32_t* y2, const int32_t* z2,
                    const uint8_t* cond, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                    const uint32_t* params, void* stream) {
    if (ncoord == 1)
        return launch_add<RingFq>(x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, n, params, stream);
    return launch_add<RingFq2>(x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, n, params, stream);
}

int zk_point_double(int ncoord, const int32_t* x, const int32_t* y, const int32_t* z,
                    int32_t* ox, int32_t* oy, int32_t* oz, long n, int k,
                    const uint32_t* params, void* stream) {
    FieldParams F = params_from(params);
    cudaStream_t s = (cudaStream_t)stream;
    if (ncoord == 1)
        double_kernel<RingFq><<<blocks(n, THREADS), THREADS, 0, s>>>(x, y, z, ox, oy, oz, n, k, F);
    else
        double_kernel<RingFq2><<<blocks(n, THREADS), THREADS, 0, s>>>(x, y, z, ox, oy, oz, n, k, F);
    return (int)cudaGetLastError();
}

int zk_ring_mul(int ncoord, const int32_t* a, const int32_t* b, int32_t* out, long n,
                const uint32_t* params, void* stream) {
    FieldParams F = params_from(params);
    cudaStream_t s = (cudaStream_t)stream;
    if (ncoord == 1)
        ring_mul_kernel<RingFq><<<blocks(n, THREADS), THREADS, 0, s>>>(a, b, out, n, F);
    else
        ring_mul_kernel<RingFq2><<<blocks(n, THREADS), THREADS, 0, s>>>(a, b, out, n, F);
    return (int)cudaGetLastError();
}

int zk_ring_inv(int ncoord, const int32_t* a, int32_t* out, long n, const uint32_t* params,
                void* stream) {
    FieldParams F = params_from(params);
    cudaStream_t s = (cudaStream_t)stream;
    if (ncoord == 1)
        ring_inv_kernel<RingFq><<<blocks(n, THREADS), THREADS, 0, s>>>(a, out, n, F);
    else
        ring_inv_kernel<RingFq2><<<blocks(n, THREADS), THREADS, 0, s>>>(a, out, n, F);
    return (int)cudaGetLastError();
}

int zk_point_aadd(int ncoord, const int32_t* x1, const int32_t* y1, const int32_t* x2,
                  const int32_t* y2, const uint8_t* inf1, const uint8_t* inf2, int32_t* ox,
                  int32_t* oy, int32_t* oz, long n, const uint32_t* params, void* stream) {
    FieldParams F = params_from(params);
    cudaStream_t s = (cudaStream_t)stream;
    if (ncoord == 1)
        aadd_kernel<RingFq><<<blocks(n, THREADS), THREADS, 0, s>>>(x1, y1, x2, y2, inf1, inf2,
                                                                   ox, oy, oz, n, F);
    else
        aadd_kernel<RingFq2><<<blocks(n, THREADS), THREADS, 0, s>>>(x1, y1, x2, y2, inf1, inf2,
                                                                    ox, oy, oz, n, F);
    return (int)cudaGetLastError();
}

int zk_point_madd_if(int ncoord, const int32_t* x1, const int32_t* y1, const int32_t* z1,
                     const int32_t* x2, const int32_t* y2, const uint8_t* cond, int32_t* ox,
                     int32_t* oy, int32_t* oz, long n, const uint32_t* params, void* stream) {
    FieldParams F = params_from(params);
    cudaStream_t s = (cudaStream_t)stream;
    if (ncoord == 1)
        madd_if_kernel<RingFq><<<blocks(n, THREADS), THREADS, 0, s>>>(x1, y1, z1, x2, y2, cond,
                                                                      ox, oy, oz, n, F);
    else
        madd_if_kernel<RingFq2><<<blocks(n, THREADS), THREADS, 0, s>>>(x1, y1, z1, x2, y2, cond,
                                                                       ox, oy, oz, n, F);
    return (int)cudaGetLastError();
}

// Sorts each of the total / n rows of n keys (n a power of two) in place.
int zk_sort_u32(int32_t* keys, long total, long n, void* stream) {
    if (n < 2 || total < n) return 0;
    uint32_t* k = reinterpret_cast<uint32_t*>(keys);
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned tiles = blocks(total, SORT_TILE);
    sort_tile_kernel<<<tiles, SORT_THREADS, 0, s>>>(k, total, n, 2, n < SORT_TILE ? n : SORT_TILE);
    cudaError_t err = cudaGetLastError();
    for (long kk = 2 * SORT_TILE; kk <= n && err == cudaSuccess; kk <<= 1) {
        for (long j = kk >> 1; j >= SORT_TILE && err == cudaSuccess; j >>= 1) {
            sort_step_kernel<<<blocks(total / 2, 256), 256, 0, s>>>(k, total, n, kk, j);
            err = cudaGetLastError();
        }
        if (err == cudaSuccess) {
            sort_tile_kernel<<<tiles, SORT_THREADS, 0, s>>>(k, total, n, kk, kk);
            err = cudaGetLastError();
        }
    }
    return (int)err;
}

}  // extern "C"
