// zkhost: native host-side bignum kernels (batch Montgomery encode/decode).
//
// Copy of native/zkhost.cpp from the JAX package, kept in the PyTorch port
// so that the port needs nothing of that package.
//
// The dealer/client role converts hundreds of thousands of field
// elements between Python integers and the device limb layout
// (Montgomery form, 16-bit limbs in uint32 lanes) per proof — a pure
// host-CPU job the reference does in Rust (arkworks MontBackend,
// used by secret-sharing/src/pss.rs and groth16/src/proving_key.rs).
// This file is its C++ analog: batch Montgomery encode/decode and
// batch modmul over moduli up to 512 bits, exposed through a plain C
// ABI loaded with ctypes (no pybind11 in the image).
//
// Layout contracts (all little-endian):
//   raw values:  n elements x (8*W64) bytes  (W64 64-bit words)
//   device limbs: n elements x K16 uint32    (16-bit values)
//
// Build: g++ -O2 -shared -fPIC -o libzkhost.so zkhost.cpp
// (done on demand by zksaas_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static const int MAXW = 8; // up to 512-bit moduli

struct Ctx {
    u64 p[MAXW];
    u64 r2[MAXW];   // R^2 mod p, R = 2^(64*W)
    u64 n0inv;      // -p^{-1} mod 2^64
    int W;          // 64-bit words
    int K16;        // 16-bit device limbs
};

// -- core Montgomery (CIOS, 64-bit words) -----------------------------------

static void mont_mul(const Ctx &c, const u64 *a, const u64 *b, u64 *out) {
    const int W = c.W;
    u64 t[MAXW + 2];
    std::memset(t, 0, sizeof(u64) * (W + 2));
    for (int i = 0; i < W; i++) {
        u128 carry = 0;
        for (int j = 0; j < W; j++) {
            u128 cur = (u128)a[i] * b[j] + t[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[W] + carry;
        t[W] = (u64)cur;
        t[W + 1] = (u64)(cur >> 64);

        u64 m = t[0] * c.n0inv;
        carry = 0;
        u128 first = (u128)m * c.p[0] + t[0];
        carry = first >> 64;
        for (int j = 1; j < W; j++) {
            u128 cur2 = (u128)m * c.p[j] + t[j] + carry;
            t[j - 1] = (u64)cur2;
            carry = cur2 >> 64;
        }
        u128 cur2 = (u128)t[W] + carry;
        t[W - 1] = (u64)cur2;
        u128 cur3 = (u128)t[W + 1] + (cur2 >> 64);
        t[W] = (u64)cur3;
        t[W + 1] = 0;
    }
    // conditional subtract p (t may be >= p, but < 2p given R > 4p)
    u64 borrow = 0;
    u64 sub[MAXW];
    for (int j = 0; j < W; j++) {
        u128 d = (u128)t[j] - c.p[j] - borrow;
        sub[j] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    bool ge = t[W] || !borrow;
    for (int j = 0; j < W; j++)
        out[j] = ge ? sub[j] : t[j];
}

static void limbs16_to_words(const u32 *in, int K16, u64 *out, int W) {
    std::memset(out, 0, sizeof(u64) * W);
    for (int k = 0; k < K16; k++) {
        int w = k / 4, s = (k % 4) * 16;
        if (w < W)
            out[w] |= (u64)(in[k] & 0xffffu) << s;
    }
}

static void words_to_limbs16(const u64 *in, int W, u32 *out, int K16) {
    for (int k = 0; k < K16; k++) {
        int w = k / 4, s = (k % 4) * 16;
        out[k] = (w < W) ? (u32)((in[w] >> s) & 0xffffu) : 0;
    }
}

extern "C" {

// Initialize a context. p_bytes/r2_bytes: little-endian 8*W-byte values.
void zk_ctx_init(Ctx *c, const uint8_t *p_bytes, const uint8_t *r2_bytes,
                 int W, int K16) {
    c->W = W;
    c->K16 = K16;
    std::memcpy(c->p, p_bytes, 8 * W);
    std::memcpy(c->r2, r2_bytes, 8 * W);
    for (int i = W; i < MAXW; i++) c->p[i] = c->r2[i] = 0;
    // n0inv = -p^{-1} mod 2^64 by Newton iteration
    u64 inv = 1;
    for (int i = 0; i < 6; i++)
        inv *= 2 - c->p[0] * inv;
    c->n0inv = (u64)(0 - inv);
}

int zk_ctx_size() { return (int)sizeof(Ctx); }

// raw (n x 8W bytes, values < p) -> Montgomery device limbs (n x K16 u32)
void zk_encode(const Ctx *c, const uint8_t *raw, u32 *out, long n) {
    const int W = c->W, K16 = c->K16;
    for (long i = 0; i < n; i++) {
        u64 a[MAXW], m[MAXW];
        std::memcpy(a, raw + (size_t)i * 8 * W, 8 * W);
        mont_mul(*c, a, c->r2, m); // a * R^2 * R^-1 = a*R
        words_to_limbs16(m, W, out + (size_t)i * K16, K16);
    }
}

// Montgomery device limbs -> raw integer bytes (n x 8W, little-endian)
void zk_decode(const Ctx *c, const u32 *limbs, uint8_t *out, long n) {
    const int W = c->W, K16 = c->K16;
    u64 one[MAXW];
    std::memset(one, 0, sizeof(one));
    one[0] = 1;
    for (long i = 0; i < n; i++) {
        u64 a[MAXW], m[MAXW];
        limbs16_to_words(limbs + (size_t)i * K16, K16, a, W);
        mont_mul(*c, a, one, m); // a * R^-1
        std::memcpy(out + (size_t)i * 8 * W, m, 8 * W);
    }
}

// batch modular multiply on raw values: out = a*b mod p (n elements)
void zk_modmul(const Ctx *c, const uint8_t *a_raw, const uint8_t *b_raw,
               uint8_t *out, long n) {
    const int W = c->W;
    for (long i = 0; i < n; i++) {
        u64 a[MAXW], b[MAXW], am[MAXW], r[MAXW], one[MAXW];
        std::memcpy(a, a_raw + (size_t)i * 8 * W, 8 * W);
        std::memcpy(b, b_raw + (size_t)i * 8 * W, 8 * W);
        mont_mul(*c, a, c->r2, am);  // aR
        mont_mul(*c, am, b, r);      // ab
        std::memcpy(out + (size_t)i * 8 * W, r, 8 * W);
    }
}

} // extern "C"
