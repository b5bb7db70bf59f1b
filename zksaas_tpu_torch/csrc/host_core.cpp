// Host build of the kernels' arithmetic (field.cuh) for the CPU tests:
// the same field and point code the CUDA kernels run, for the same rings
// and limb counts, looped over the batch on the CPU and exposed through the
// same C signatures as kernels.cu (prefix zkc_, no stream).  Built with plain g++ by
// zksaas_tpu_torch/kernels.py::host_core(); the tests hold it against the
// plain PyTorch versions, which are in turn held against the JAX package.

#include <stdint.h>

#include <vector>

#include "add_group.cuh"
#include "field.cuh"

using namespace zk;

// A grouped program of add_group.cuh, one row after the other, each step's
// items (the lanes' work) in a serial loop: fn(group, row).
template <class Grp, class Fn>
static int group_loop(long n, const uint32_t* params, Fn&& fn) {
    typename Grp::P F = params_from<Grp::NL>(params);
    std::vector<uint32_t> slots(Grp::WORDS);
    Grp g{slots.data(), F, 0, 0};
    for (long i = 0; i < n; i++) fn(g, i);
    return 0;
}

template <class R>
static void ring_mul_loop(const int32_t* a, const int32_t* b, int32_t* out, long n,
                          const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    for (long i = 0; i < n; i++) {
        const long off = i * R::LIMBS16;
        typename R::E x, y;
        load16(a + off, x);
        load16(b + off, y);
        store16(out + off, R::mul_cc(x, y, F));
    }
}

// The n lanes as one warp: every lane steps its inverse's batches in
// lockstep until every lane's g is 0 (the device's warp vote), so lanes
// that finish early take the extra batches as they do on the card.
template <class R>
static void ring_inv_warp(const int32_t* a, int32_t* out, long n, const uint32_t* params) {
    typename R::P F = params_from<R::NL>(params);
    const InvParams<R::NL> I = inv_params_from<R::NL>(params);
    std::vector<typename R::E> x(n);
    std::vector<FqInverse<R::NL>> lanes;
    for (long i = 0; i < n; i++) {
        load16(a + i * R::LIMBS16, x[i]);
        lanes.emplace_back(R::inv_norm(x[i], F), I);
    }
    auto all_done = [&] {
        for (const auto& s : lanes)
            if (!s.done()) return false;
        return true;
    };
    for (int b = 0; b < FqInverse<R::NL>::MAX_BATCHES && !all_done(); b++)
        for (auto& s : lanes) s.step(I);
    for (long i = 0; i < n; i++)
        store16(out + i * R::LIMBS16, R::inv_finish(x[i], lanes[i].result(F, I), F));
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
        return group_loop<AddGroup<decltype(r)>>(n, params, [&](auto& g, long i) {
            g.run_add(x1, y1, z1, x2, y2, z2, cond, ox, oy, oz, i);
        });
    });
}

int zkc_point_double(int nl, int nr, int ncoord, const int32_t* x, const int32_t* y,
                     const int32_t* z, int32_t* ox, int32_t* oy, int32_t* oz, long n, int k,
                     const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        return group_loop<DoubleGroup<decltype(r)>>(n, params, [&](auto& g, long i) {
            g.run_double(x, y, z, ox, oy, oz, i, k);
        });
    });
}

int zkc_ring_mul(int nl, int nr, int ncoord, const int32_t* a, const int32_t* b,
                 int32_t* out, long n, const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        ring_mul_loop<decltype(r)>(a, b, out, n, params);
        return 0;
    });
}

int zkc_ring_inv(int nl, int nr, int ncoord, const int32_t* a, int32_t* out, long n,
                 const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        ring_inv_warp<decltype(r)>(a, out, n, params);
        return 0;
    });
}

int zkc_point_aadd(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                   const int32_t* x2, const int32_t* y2, const uint8_t* inf1,
                   const uint8_t* inf2, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                   const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        return group_loop<AaddGroup<decltype(r)>>(n, params, [&](auto& g, long i) {
            g.run_aadd(x1, y1, x2, y2, inf1, inf2, ox, oy, oz, i);
        });
    });
}

int zkc_point_madd_if(int nl, int nr, int ncoord, const int32_t* x1, const int32_t* y1,
                      const int32_t* z1, const int32_t* x2, const int32_t* y2,
                      const uint8_t* cond, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                      const uint32_t* params) {
    return with_ring(nl, nr, ncoord, [&](auto r) {
        return group_loop<MaddGroup<decltype(r)>>(n, params, [&](auto& g, long i) {
            g.run_madd_if(x1, y1, z1, x2, y2, cond, ox, oy, oz, i);
        });
    });
}

// The sort kernels' passes (kernels.cu::zk_sort_u32), each of their
// launches as a serial loop: every pass's row totals, then per pass the
// per-tile digit counts, the scan and the stable scatter (a copy for a row
// whose keys share the pass's digit), ping-ponging through a scratch copy; rows
// of at most one tile padded with all-ones keys and sorted by the same
// stable passes.
int zkc_sort_u32(int32_t* keys, long total, long n) {
    if (n < 2 || total < n) return 0;
    uint32_t* k = reinterpret_cast<uint32_t*>(keys);
    const long rows = total / n;
    if (n <= RADIX_TILE) {
        std::vector<uint32_t> a(RADIX_TILE), b(RADIX_TILE);
        for (long r = 0; r < rows; r++) {
            for (long q = 0; q < RADIX_TILE; q++) a[q] = q < n ? k[r * n + q] : 0xFFFFFFFFu;
            for (int pass = 0; pass < RADIX_PASSES; pass++) {
                uint32_t start[RADIX] = {0};
                for (long q = 0; q < RADIX_TILE; q++) start[radix_digit(a[q], pass)]++;
                for (uint32_t d = 0, run = 0; d < RADIX; d++) {
                    const uint32_t c = start[d];
                    start[d] = run;
                    run += c;
                }
                for (long q = 0; q < RADIX_TILE; q++) b[start[radix_digit(a[q], pass)]++] = a[q];
                a.swap(b);
            }
            for (long q = 0; q < n; q++) k[r * n + q] = a[q];
        }
        return 0;
    }
    const long tiles = n / RADIX_TILE, nblocks = total / RADIX_TILE;
    std::vector<uint32_t> scratch(radix_scratch_words(total, n));
    uint32_t* alt = scratch.data();
    uint32_t* counts = alt + total;
    uint32_t* rowhist = counts + nblocks * RADIX;  // zeroed
    for (long q = 0; q < total; q++)  // every pass's row totals
        for (int p = 0; p < RADIX_PASSES; p++)
            rowhist[(p * rows + q / n) * RADIX + radix_digit(k[q], p)]++;
    for (int pass = 0; pass < RADIX_PASSES; pass++) {
        const uint32_t* src = pass % 2 ? alt : k;
        uint32_t* dst = pass % 2 ? k : alt;
        auto fixed = [&](long row) {  // one digit holds the whole row
            return rowhist[(pass * rows + row) * RADIX + radix_digit(src[row * n], pass)] ==
                   (uint32_t)n;
        };
        for (long b = 0; b < nblocks; b++) {  // tile counts
            uint32_t h[RADIX] = {0};
            for (long q = 0; q < RADIX_TILE; q++) h[radix_digit(src[b * RADIX_TILE + q], pass)]++;
            for (uint32_t d = 0; d < RADIX; d++)
                counts[radix_count_index(b / tiles, d, tiles, b % tiles)] = h[d];
        }
        for (long r = 0; r < rows; r++) {  // scan: smaller digits' total, then the tiles
            if (fixed(r)) continue;
            uint32_t below = 0;
            for (uint32_t d = 0; d < RADIX; d++) {
                uint32_t run = below;
                for (long t = 0; t < tiles; t++) {
                    uint32_t& c = counts[radix_count_index(r, d, tiles, t)];
                    const uint32_t v = c;
                    c = run;
                    run += v;
                }
                below += rowhist[(pass * rows + r) * RADIX + d];
            }
        }
        for (long b = 0; b < nblocks; b++) {  // stable scatter
            const long row = b / tiles, base = b * RADIX_TILE;
            if (fixed(row)) {
                for (long q = 0; q < RADIX_TILE; q++) dst[base + q] = src[base + q];
                continue;
            }
            uint32_t seen[RADIX] = {0};
            for (long q = 0; q < RADIX_TILE; q++) {
                const uint32_t key = src[base + q], d = radix_digit(key, pass);
                dst[row * n + counts[radix_count_index(row, d, tiles, b % tiles)] + seen[d]++] =
                    key;
            }
        }
    }
    return 0;
}

}  // extern "C"
