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
//   Design (the grouped programs of add_group.cuh): the main path adds
//   and doubles 8-128 points a launch (the binary scalar muls; the window
//   fold doubles 8-128 points 8-128 times), so a launch costs one point's
//   latency; a group of 4 lanes (G1) or 8 (G2) shares each point and
//   computes the independent Montgomery products of each level of the
//   formula at once, on PTX carry chains, passing operands through shared
//   memory; each lane holds one product's operands, so no instance
//   spills.  The special cases are decided once per group, so a group
//   never diverges.  The double keeps its point in the group's slots over
//   its k doublings, 3 product levels each.
//
// Kernels 5-9 run the bucket-Pippenger MSM (curves/pippenger.py):
//
// Kernel 5, ring_mul: replaces zksaas_tpu/curves/fused.py::_fmul_call
//   (pfmul), the product of the batch-inversion tree and the affine
//   conversion, 1,024-2^18 elements a launch.  Bound: memory (3
//   coordinates against one Montgomery product in Fq, as montmul; three
//   products in Fq2) from 2^14 elements up, one element's latency below.
//   Design (kernels.cuh): the products on PTX carry chains (cc_mont,
//   inlined); above 2^17 rows in Fq and 2^16 in Fq2 a block stages its
//   tile of 64 rows of a and b in shared memory with coalesced cp.async
//   copies and writes the products out through it, so every warp access
//   to device memory is whole sectors, and several blocks a SM overlap
//   copies with products.  Below, where the rows come from L2 and a
//   launch costs one row's latency, Fq reads each row straight into its
//   thread, and Fq2 splits a row's three Karatsuba Fq products over three
//   threads of the tiled kernel.  The Fq2 product is one launch instead
//   of three montmuls and the add/sub glue between them.
//
// Kernel 6, ring_inv: replaces fused.py::_finv_call (pfinv), the root of
//   the inversion tree (at most 1,024 elements).  Bound: one element's
//   chain of dependent steps, since 1,024 elements fill only 32 warps;
//   the TPU's Fermat chain a^(p-2) is ~380 (BN254) or ~570 (BLS12)
//   dependent Montgomery products.  Design: Bernstein-Yang's safegcd
//   (field.cuh::FqInverse), one thread an element in warps of their own
//   (32 blocks of 32 threads): branch-free batches of 30 divsteps on
//   32-bit words, each batch's matrix applied to 30-bit limbs, until a
//   warp vote finds every lane done (18 batches over BN254's Fq, 26-27
//   over the BLS12 fields, on random inputs), then one carry-chain
//   product by R^3 mod p; Fq2 through the norm.
//
// Kernel 7, point_aadd: replaces fused.py::_aadd_call (paddaa), tree level
//   1 over the sorted affine leaves.  Bound: memory by count (4
//   coordinates and 2 flags in, 3 out, against 6 products per lane, x3
//   in G2), though the formula's dependent products keep it well above
//   that.  Design: the grouped affine+affine add of add_group.cuh, 3
//   product levels of 2 ring products, 2 lanes a point in G1 and 8 in G2
//   (one Fq product each a level), so a thread holds one product's
//   operands instead of a whole point (255 registers and spills at 12
//   limbs before); the special cases (infinity flags, P == Q, P == -Q)
//   are decided once per group.
//
// Kernel 8, point_madd_if: replaces fused.py::_madd_select_call
//   (pmadd_if), the level-0 suffix queries.  Bound: 11 products a lane
//   (x3 in G2) against 6 coordinates moved in the general case; on the
//   main path every accumulator is at infinity, and then the bytes alone
//   (Z1, x2, y2 in, 3 coordinates out).  Design: the grouped mixed add of
//   add_group.cuh, 5 product levels of 2-3 ring products, 4 lanes a point
//   in G1 and 8 in G2, no spill (the one-thread kernel it replaces took
//   128-255 registers and spilled up to 776 B in G2); rows go to groups
//   in order, as in the add; a group whose cond is false copies P and
//   never reads Q, and one whose P is at infinity reads Z1 with Q and
//   writes (x2, y2, 1).
//
// Kernel 9, sort_u32: replaces zksaas_tpu/fields/sortperm.py::_stage_call
//   (one bitonic k-stage, launched in sequence by _sort_call), the
//   (window | digit | slot) key sort; it does not depend on the field.
//   Bound: the bytes, each key read once and written once (the same
//   whatever algorithm sorts).  Design: the TPU ran a bitonic network
//   with the whole array in VMEM; here an LSD radix sort of four stable
//   8-bit digit passes, each three launches over device memory (per-tile
//   digit counts, one scan per row, a scatter that orders each tile in
//   shared memory and writes runs of one digit together), ping-ponging
//   between the keys and a scratch copy the wrapper allocates.  A pass
//   whose digit is the same for every key of a row copies that row (a
//   flag the scan sets on the device, so no host synchronisation).  Rows
//   of at most one tile are sorted in shared memory by one launch.  Rows
//   are sorted independently, so a batch of parties is one call.  Keys
//   compare as unsigned 32-bit values.
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

// ---------------------------------------------------------------------------
// kernel 9: LSD radix sort (field.cuh: RADIX_*), one block of RADIX_THREADS
// threads per tile of RADIX_TILE keys
// ---------------------------------------------------------------------------

constexpr int RADIX_THREADS = 256;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int RADIX_KPW = RADIX_TILE / RADIX_WARPS;  // keys per warp
constexpr int RADIX_STEPS = RADIX_KPW / 32;
static_assert(RADIX_THREADS == RADIX, "one thread per digit in the digit scans");

// Exclusive scan of one value per thread over a block of 32 k threads;
// `sums` holds 32 words of shared memory.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* sums) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    uint32_t inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += o;
    }
    if (lane == 31) sums[w] = inc;
    __syncthreads();
    if (w == 0) {
        uint32_t s = lane < nw ? sums[lane] : 0, si = s;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t o = __shfl_up_sync(0xffffffffu, si, d);
            if (lane >= d) si += o;
        }
        sums[lane] = si - s;  // exclusive
    }
    __syncthreads();
    const uint32_t r = sums[w] + inc - v;
    __syncthreads();  // sums may be reused at once
    return r;
}

// Stable order of one tile's RADIX_TILE keys by their digit of `pass`:
// key q (in(q)) goes to out[start[d] + (its rank among the tile's keys of
// digit d)], start[d] being the tile's exclusive digit scan.  Warp w ranks
// keys w * RADIX_KPW .. in steps of 32: lanes of one digit find each other
// with __match_any_sync, a key's rank is the warp's earlier keys of its
// digit (wcnt[w][d]) plus its peers in lower lanes, and the lowest peer
// moves wcnt on.  Then each digit's counts are scanned over the warps and
// the digits scanned over the tile.
template <class In>
__device__ __forceinline__ void tile_order(In in, uint32_t* out, uint32_t (*wcnt)[RADIX],
                                           uint32_t* start, uint32_t* sums, int pass) {
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    for (int q = tid; q < RADIX_WARPS * RADIX; q += RADIX_THREADS) (&wcnt[0][0])[q] = 0;
    __syncthreads();
    uint32_t key[RADIX_STEPS], rank[RADIX_STEPS];
    const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
    for (int s = 0; s < RADIX_STEPS; s++) {
        key[s] = in(w * RADIX_KPW + s * 32 + lane);
        const uint32_t d = radix_digit(key[s], pass);
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const uint32_t below = __popc(peers & below_me);
        rank[s] = wcnt[w][d] + below;
        __syncwarp();
        if (below == 0) wcnt[w][d] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    uint32_t run = 0;  // thread tid is digit tid: its counts over the warps
#pragma unroll
    for (int v = 0; v < RADIX_WARPS; v++) {
        const uint32_t c = wcnt[v][tid];
        wcnt[v][tid] = run;
        run += c;
    }
    start[tid] = block_exclusive_scan(run, sums);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < RADIX_STEPS; s++) {
        const uint32_t d = radix_digit(key[s], pass);
        out[start[d] + wcnt[w][d] + rank[s]] = key[s];
    }
    __syncthreads();
}

// Each row's digit totals for every pass (totals do not depend on the
// keys' order, so one read of the input gives all four) into rowhist,
// which the wrapper's scratch holds zeroed, and the tile counts of pass 0.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_rowhist_kernel(const uint32_t* __restrict__ keys, uint32_t* __restrict__ counts,
                     uint32_t* __restrict__ rowhist, long tiles, long rows) {
    __shared__ uint32_t h[RADIX_PASSES][RADIX];
    const long b = blockIdx.x, row = b / tiles;
    for (int p = 0; p < RADIX_PASSES; p++) h[p][threadIdx.x] = 0;
    __syncthreads();
    const uint4* k4 = reinterpret_cast<const uint4*>(keys + b * RADIX_TILE);
    for (int q = threadIdx.x; q < RADIX_TILE / 4; q += RADIX_THREADS) {
        const uint4 v = k4[q];
        const uint32_t ks[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; j++)
#pragma unroll
            for (int p = 0; p < RADIX_PASSES; p++) atomicAdd(&h[p][radix_digit(ks[j], p)], 1u);
    }
    __syncthreads();
    counts[radix_count_index(row, threadIdx.x, tiles, b % tiles)] = h[0][threadIdx.x];
    for (int p = 0; p < RADIX_PASSES; p++)
        if (h[p][threadIdx.x])
            atomicAdd(&rowhist[(p * rows + row) * RADIX + threadIdx.x], h[p][threadIdx.x]);
}

// Whether the row's keys all share their digit of this pass (its totals
// hist, RADIX of them, hold one n): such a row keeps its order.
__device__ __forceinline__ bool radix_row_fixed(const uint32_t* hist, uint32_t key, int pass,
                                                long n) {
    return hist[radix_digit(key, pass)] == (uint32_t)n;
}

// counts[row, d, tile] = the tile's keys of digit d (passes after the
// first; a row that keeps its order is skipped).
__global__ void __launch_bounds__(RADIX_THREADS)
radix_hist_kernel(const uint32_t* __restrict__ keys, uint32_t* __restrict__ counts,
                  const uint32_t* __restrict__ rowhist, long tiles, long rows, long n,
                  int pass) {
    __shared__ uint32_t h[RADIX];
    const long b = blockIdx.x, row = b / tiles;
    const uint32_t* hist = rowhist + (pass * rows + row) * RADIX;
    if (radix_row_fixed(hist, keys[b * RADIX_TILE], pass, n)) return;
    h[threadIdx.x] = 0;
    __syncthreads();
    const uint4* k4 = reinterpret_cast<const uint4*>(keys + b * RADIX_TILE);
    for (int q = threadIdx.x; q < RADIX_TILE / 4; q += RADIX_THREADS) {
        const uint4 v = k4[q];
        atomicAdd(&h[radix_digit(v.x, pass)], 1u);
        atomicAdd(&h[radix_digit(v.y, pass)], 1u);
        atomicAdd(&h[radix_digit(v.z, pass)], 1u);
        atomicAdd(&h[radix_digit(v.w, pass)], 1u);
    }
    __syncthreads();
    counts[radix_count_index(row, threadIdx.x, tiles, b % tiles)] = h[threadIdx.x];
}

// One warp per (row, digit d): the row's counts of d over its tiles to
// their exclusive scan in place, offset by the row's keys of smaller
// digits, which gives each tile's first place in the row for d.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_scan_kernel(uint32_t* __restrict__ counts, const uint32_t* __restrict__ rowhist,
                  long tiles, long rows, long n, int pass) {
    const int lane = threadIdx.x & 31;
    const long gw = (long)blockIdx.x * RADIX_WARPS + (threadIdx.x >> 5);
    const long row = gw / RADIX;
    const uint32_t d = gw % RADIX;
    const uint32_t* hist = rowhist + (pass * rows + row) * RADIX;
    uint32_t below = 0;
    bool fixed = false;
    for (int j = lane; j < RADIX; j += 32) {
        below += j < (int)d ? hist[j] : 0;
        fixed |= hist[j] == (uint32_t)n;
    }
    if (__any_sync(0xffffffffu, fixed)) return;  // the scatter copies this row
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
    uint32_t* c = counts + radix_count_index(row, d, tiles, 0);
    uint32_t run = below;
    for (long t0 = 0; t0 < tiles; t0 += 32) {
        const long t = t0 + lane;
        const uint32_t v = t < tiles ? c[t] : 0;
        uint32_t inc = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t u = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += u;
        }
        if (t < tiles) c[t] = run + inc - v;
        run += __shfl_sync(0xffffffffu, inc, 31);
    }
}

// One block per tile: the tile's keys in stable digit order in shared
// memory, then each key to its row's offset for (digit, tile) plus its
// place in the tile's run of that digit, so neighbouring threads write
// neighbouring places.  A row whose keys share this pass's digit is
// copied as it is.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_scatter_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                     const uint32_t* __restrict__ offs, const uint32_t* __restrict__ rowhist,
                     long tiles, long rows, long n, int pass) {
    __shared__ uint32_t sorted[RADIX_TILE];
    __shared__ uint32_t wcnt[RADIX_WARPS][RADIX];
    __shared__ uint32_t start[RADIX], goff[RADIX], sums[32];
    const long b = blockIdx.x, row = b / tiles, base = b * RADIX_TILE;
    if (radix_row_fixed(rowhist + (pass * rows + row) * RADIX, src[base], pass, n)) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src + base);
        uint4* d4 = reinterpret_cast<uint4*>(dst + base);
        for (int q = threadIdx.x; q < RADIX_TILE / 4; q += RADIX_THREADS) d4[q] = s4[q];
        return;
    }
    tile_order([&](int q) { return src[base + q]; }, sorted, wcnt, start, sums, pass);
    goff[threadIdx.x] = offs[radix_count_index(row, threadIdx.x, tiles, b % tiles)];
    __syncthreads();
    uint32_t* out = dst + row * n;
    for (int q = threadIdx.x; q < RADIX_TILE; q += RADIX_THREADS) {
        const uint32_t key = sorted[q];
        const uint32_t d = radix_digit(key, pass);
        out[goff[d] + (q - start[d])] = key;
    }
}

// Rows of n <= RADIX_TILE keys, one block each: the row, padded with
// all-ones keys (which sort after it, stably), through every pass in
// shared memory.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_small_kernel(uint32_t* __restrict__ keys, long n) {
    __shared__ uint32_t buf[2][RADIX_TILE];
    __shared__ uint32_t wcnt[RADIX_WARPS][RADIX];
    __shared__ uint32_t start[RADIX], sums[32];
    uint32_t* row = keys + blockIdx.x * n;
    for (int q = threadIdx.x; q < RADIX_TILE; q += RADIX_THREADS)
        buf[0][q] = q < n ? row[q] : 0xFFFFFFFFu;
    __syncthreads();
    for (int pass = 0; pass < RADIX_PASSES; pass++) {
        const uint32_t* cur = buf[pass & 1];
        tile_order([&](int q) { return cur[q]; }, buf[(pass + 1) & 1], wcnt, start, sums, pass);
    }
    static_assert(RADIX_PASSES % 2 == 0, "the sorted row ends in buf[0]");
    for (int q = threadIdx.x; q < n; q += RADIX_THREADS) row[q] = buf[0][q];
}

// The launch floor chip_smoke.py prints beside the small adds.
__global__ void empty_kernel() {}

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

int zk_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

long zk_sort_u32_scratch_words(long total, long n) { return radix_scratch_words(total, n); }

// Sorts each of the total / n rows of n keys (n a power of two) in place;
// `scratch` holds zk_sort_u32_scratch_words(total, n) words.  One launch
// counts every pass's row totals (and pass 0's tile counts), then each
// pass is a scan and a scatter (and, after the first, a tile count), the
// result back in `keys` after the even count of ping-pong scatters; rows
// of at most one tile take one launch.
int zk_sort_u32(int32_t* keys, int32_t* scratch, long total, long n, void* stream) {
    if (n < 2 || total < n) return 0;
    uint32_t* k = reinterpret_cast<uint32_t*>(keys);
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= RADIX_TILE) {
        radix_small_kernel<<<(unsigned)(total / n), RADIX_THREADS, 0, s>>>(k, n);
        return (int)cudaGetLastError();
    }
    static_assert(RADIX_PASSES % 2 == 0, "the last scatter writes back into keys");
    const long tiles = n / RADIX_TILE, nblocks = total / RADIX_TILE, rows = total / n;
    uint32_t* alt = reinterpret_cast<uint32_t*>(scratch);
    uint32_t* counts = alt + total;
    uint32_t* rowhist = counts + nblocks * RADIX;
    cudaError_t err = cudaMemsetAsync(rowhist, 0, RADIX_PASSES * rows * RADIX * sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
    radix_rowhist_kernel<<<(unsigned)nblocks, RADIX_THREADS, 0, s>>>(k, counts, rowhist, tiles,
                                                                     rows);
    err = cudaGetLastError();
    const unsigned scan_blocks = (unsigned)(rows * RADIX / RADIX_WARPS);
    for (int pass = 0; pass < RADIX_PASSES && err == cudaSuccess; pass++) {
        const uint32_t* src = pass % 2 ? alt : k;
        uint32_t* dst = pass % 2 ? k : alt;
        if (pass > 0)
            radix_hist_kernel<<<(unsigned)nblocks, RADIX_THREADS, 0, s>>>(src, counts, rowhist,
                                                                          tiles, rows, n, pass);
        radix_scan_kernel<<<scan_blocks, RADIX_THREADS, 0, s>>>(counts, rowhist, tiles, rows, n,
                                                               pass);
        radix_scatter_kernel<<<(unsigned)nblocks, RADIX_THREADS, 0, s>>>(src, dst, counts, rowhist,
                                                                         tiles, rows, n, pass);
        err = cudaGetLastError();
    }
    return (int)err;
}

}  // extern "C"
