// Hand-written Hopper (sm_90a) kernels of the PyTorch port, with a plain C
// interface for ctypes (zksaas_tpu_torch/kernels.py builds and loads it).
//
// Every field-taking kernel is built for the coordinate fields of the
// three curves: BN254 (8 32-bit limbs, Fq2 nr = -1), BLS12-381 (12 limbs,
// nr = -1) and BLS12-377 (12 limbs, nr = -5); montmul for 8 limbs (BN254 Fq
// and every curve's Fr) and 12 (the BLS12 Fq).  The entry points take the
// limb count `nl` and the non-residue `nr` and return NOT_BUILT (-1) for a
// combination that was not built.  The point and ring kernels are templates
// in kernels.cuh, instantiated one ring per ring_*.cu source.
//
// Kernel 1, montmul: replaces zksaas_tpu/fields/pallas_mul.py::_mul_call
// (montmul_pallas), the TPU path of Field.mul.
//   Bound: 3 x 2 NL int32 limbs (192 B at 8 limbs, 288 B at 12) moved per
//   element against 2 NL^2 + NL 32-bit multiplies (136, 300), so at large
//   batches the card's 3.35 TB/s memory, not its integer units, sets the
//   floor.
//   Design: one thread per element, CIOS over NL 32-bit limbs held in
//   registers; each thread reads its two rows with 16 B vector loads and
//   writes one row the same way, so a warp touches whole sectors.
//
// Kernels 2-4, point_add / point_add_if / point_double(k): replace
// zksaas_tpu/curves/fused.py::_add_call (fused_add), ::_add_select_call
// (fused_add_select) and ::_double_call (fused_double).
//   Bound: 12-25 Montgomery products per element (x3 in G2) against
//   6-9 coordinates moved, so these are bound by 32-bit integer multiply
//   throughput, not memory.
//   Design: one thread per point, the whole formula in registers; the
//   special cases (infinity operands, P == Q, P == -Q, cond false) are
//   branches, which diverge only on the rare lanes that take them, so the
//   doubling inside the complete add is not paid on every lane as the
//   TPU's selects pay it.  __launch_bounds__(128) lets the G2 formulas,
//   which keep ~30 Fq2 temporaries live (72 words a point at 12 limbs),
//   spill to L1 instead of failing.
//
// Kernels 5-9 run the bucket-Pippenger MSM (curves/pippenger.py):
//
// Kernel 5, ring_mul: replaces zksaas_tpu/curves/fused.py::_fmul_call
//   (pfmul), the product of the batch-inversion tree and the affine
//   conversion.  Bound: memory (3 coordinates against one Montgomery
//   product in Fq, as montmul; three products in Fq2).  Design: as
//   montmul, one thread per element; the Fq2 Karatsuba product is one
//   launch instead of three montmuls and the add/sub glue between them.
//
// Kernel 6, ring_inv: replaces fused.py::_finv_call (pfinv), the root of
//   the inversion tree (at most 1,024 elements).  Bound: the serial chain
//   of ~380 (BN254) or ~570 (BLS12) Montgomery products per element; at
//   1,024 elements only 8 blocks run, so its time is that chain's
//   latency, not a rate.  Design: one thread per element; the exponent
//   p - 2 comes from the field's params in registers (the TPU read its
//   bits from SMEM).
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
//   (window | digit | slot) key sort; it does not depend on the field.
//   Bound: the n/2 x log2(n)(log2(n)+1)/2
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

#include "kernels.cuh"

using namespace zk;

namespace {

template <int NL>
__global__ void __launch_bounds__(256)
montmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long n, FieldParams<NL> F) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fq<NL> x, y;
    vload(a + i * 2 * NL, x);
    vload(b + i * 2 * NL, y);
    vstore(out + i * 2 * NL, fq_mul(x, y, F));
}

template <int NL>
int launch_montmul(const int32_t* a, const int32_t* b, int32_t* out, long n,
                   const uint32_t* params, cudaStream_t s) {
    montmul_kernel<NL><<<blocks(n, 256), 256, 0, s>>>(a, b, out, n, params_from<NL>(params));
    return (int)cudaGetLastError();
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

const RingOps* ring_ops(int nl, int nr, int ncoord) {
    static const RingOps* const table[N_RINGS] = {&OPS_G1_8, &OPS_G1_12, &OPS_G2_8_1,
                                                  &OPS_G2_12_1, &OPS_G2_12_5};
    const int id = ring_id(nl, nr, ncoord);
    return id < 0 ? nullptr : table[id];
}

}  // namespace

extern "C" {

int zk_montmul(int nl, const int32_t* a, const int32_t* b, int32_t* out, long n,
               const uint32_t* params, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nl == 8) return launch_montmul<8>(a, b, out, n, params, s);
    if (nl == 12) return launch_montmul<12>(a, b, out, n, params, s);
    return NOT_BUILT;
}

int zk_point_add(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                 const int32_t* z1, const int32_t* x2, const int32_t* y2, const int32_t* z2,
                 int32_t* ox, int32_t* oy, int32_t* oz, long n, const uint32_t* params,
                 void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->add_if(x1, y1, z1, x2, y2, z2, nullptr, ox, oy, oz, n, params,
                         (cudaStream_t)stream)
             : NOT_BUILT;
}

int zk_point_add_if(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                    const int32_t* z1, const int32_t* x2, const int32_t* y2,
                    const int32_t* z2, const uint8_t* cond, int32_t* ox, int32_t* oy,
                    int32_t* oz, long n, const uint32_t* params, void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->add_if(x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, n, params,
                         (cudaStream_t)stream)
             : NOT_BUILT;
}

int zk_point_double(int nl, int nr, int ncoord, const int32_t* x, const int32_t* y,
                    const int32_t* z, int32_t* ox, int32_t* oy, int32_t* oz, long n, int k,
                    const uint32_t* params, void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->dbl(x, y, z, ox, oy, oz, n, k, params, (cudaStream_t)stream) : NOT_BUILT;
}

int zk_ring_mul(int nl, int nr, int ncoord, const int32_t* a, const int32_t* b,
                int32_t* out, long n, const uint32_t* params, void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->ring_mul(a, b, out, n, params, (cudaStream_t)stream) : NOT_BUILT;
}

int zk_ring_inv(int nl, int nr, int ncoord, const int32_t* a, int32_t* out, long n,
                const uint32_t* params, void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->ring_inv(a, out, n, params, (cudaStream_t)stream) : NOT_BUILT;
}

int zk_point_aadd(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                  const int32_t* x2, const int32_t* y2, const uint8_t* inf1,
                  const uint8_t* inf2, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                  const uint32_t* params, void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->aadd(x1, y1, x2, y2, inf1, inf2, ox, oy, oz, n, params,
                       (cudaStream_t)stream)
             : NOT_BUILT;
}

int zk_point_madd_if(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                     const int32_t* z1, const int32_t* x2, const int32_t* y2,
                     const uint8_t* cond, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                     const uint32_t* params, void* stream) {
    const RingOps* R = ring_ops(nl, nr, ncoord);
    return R ? R->madd_if(x1, y1, z1, x2, y2, cond, ox, oy, oz, n, params,
                          (cudaStream_t)stream)
             : NOT_BUILT;
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
