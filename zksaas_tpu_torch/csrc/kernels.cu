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

}  // extern "C"
