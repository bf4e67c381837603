// hostcodec — native host-side codec utilities for polar_codes_tpu.
//
// The device compute path is JAX/XLA; this library covers the host-side work
// the reference implements in C++ (BitContainer packing/injection,
// src/polarcode/bitcontainer.cpp; CRC engines,
// src/polarcode/errordetection/*.cpp): packed-byte <-> bit conversions with
// information-position gather/scatter for the pypolar byte interfaces, and
// byte/bit-stream CRC engines for verifying large host-side result buffers
// without round-tripping through the device. Built as a plain shared
// library, loaded with ctypes (no pybind11 in this environment).
//
// All functions use C linkage and operate on caller-owned buffers.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include <dlfcn.h>

// ---------------------------------------------------------------------------
// AES-128-CMAC via the system libcrypto, dlopen'd at runtime (the image
// ships libcrypto.so.3 but no OpenSSL headers). This is the same approach
// as the reference's detector (src/polarcode/errordetection/cmac.cpp:10-111
// uses OpenSSL's CMAC/EVP engine); here the whole batch is MAC'd in one
// native call so the per-block cost is AES-NI speed, not Python dispatch.
// ---------------------------------------------------------------------------

namespace {

typedef void CMAC_CTX_t;
typedef void EVP_CIPHER_t;
typedef CMAC_CTX_t* (*cmac_ctx_new_fn)(void);
typedef void (*cmac_ctx_free_fn)(CMAC_CTX_t*);
typedef int (*cmac_init_fn)(CMAC_CTX_t*, const void*, size_t,
                            const EVP_CIPHER_t*, void*);
typedef int (*cmac_update_fn)(CMAC_CTX_t*, const void*, size_t);
typedef int (*cmac_final_fn)(CMAC_CTX_t*, unsigned char*, size_t*);
typedef const EVP_CIPHER_t* (*evp_aes_128_cbc_fn)(void);

struct Crypto {
    void* handle = nullptr;
    cmac_ctx_new_fn ctx_new = nullptr;
    cmac_ctx_free_fn ctx_free = nullptr;
    cmac_init_fn init = nullptr;
    cmac_update_fn update = nullptr;
    cmac_final_fn final_ = nullptr;
    evp_aes_128_cbc_fn aes128cbc = nullptr;
    bool ok = false;

    Crypto()
    {
        const char* names[] = {"libcrypto.so.3", "libcrypto.so.1.1",
                               "libcrypto.so"};
        for (const char* n : names) {
            handle = dlopen(n, RTLD_NOW | RTLD_LOCAL);
            if (handle)
                break;
        }
        if (!handle)
            return;
        ctx_new = (cmac_ctx_new_fn)dlsym(handle, "CMAC_CTX_new");
        ctx_free = (cmac_ctx_free_fn)dlsym(handle, "CMAC_CTX_free");
        init = (cmac_init_fn)dlsym(handle, "CMAC_Init");
        update = (cmac_update_fn)dlsym(handle, "CMAC_Update");
        final_ = (cmac_final_fn)dlsym(handle, "CMAC_Final");
        aes128cbc = (evp_aes_128_cbc_fn)dlsym(handle, "EVP_aes_128_cbc");
        ok = ctx_new && ctx_free && init && update && final_ && aes128cbc;
    }
};

Crypto& crypto()
{
    static Crypto c;
    return c;
}

} // namespace

extern "C" {

// 1 when the system libcrypto CMAC engine is usable from this library.
int hc_cmac_available(void)
{
    return crypto().ok ? 1 : 0;
}

// Batched AES-128-CMAC: tags[r*16..] = CMAC(key, msgs[r*msg_bytes..]).
// Returns 0 on success, -1 if libcrypto is unavailable, -2 on engine error.
int hc_cmac_rows(const uint8_t* key,
                 const uint8_t* msgs,
                 size_t msg_bytes,
                 size_t n_rows,
                 uint8_t* tags)
{
    Crypto& c = crypto();
    if (!c.ok)
        return -1;
    CMAC_CTX_t* ctx = c.ctx_new();
    if (!ctx)
        return -2;
    const EVP_CIPHER_t* cipher = c.aes128cbc();
    int rc = 0;
    for (size_t r = 0; r < n_rows; ++r) {
        size_t outl = 0;
        if (c.init(ctx, key, 16, cipher, nullptr) != 1 ||
            c.update(ctx, msgs + r * msg_bytes, msg_bytes) != 1 ||
            c.final_(ctx, tags + 16 * r, &outl) != 1 || outl != 16) {
            rc = -2;
            break;
        }
    }
    c.ctx_free(ctx);
    return rc;
}

} // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Bit packing (np.packbits/np.unpackbits semantics: MSB-first)
// ---------------------------------------------------------------------------

void hc_pack_bits(const uint8_t* bits, size_t n_bits, uint8_t* bytes)
{
    size_t n_bytes = (n_bits + 7) / 8;
    std::memset(bytes, 0, n_bytes);
    for (size_t i = 0; i < n_bits; ++i) {
        bytes[i >> 3] |= (bits[i] & 1) << (7 - (i & 7));
    }
}

void hc_unpack_bits(const uint8_t* bytes, size_t n_bits, uint8_t* bits)
{
    for (size_t i = 0; i < n_bits; ++i) {
        bits[i] = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
    }
}

// Gather bits at positions (information extraction: BitContainer
// getPackedInformationBits analogue, batched over rows).
void hc_gather_bits(const uint8_t* bits,
                    size_t row_len,
                    size_t n_rows,
                    const int64_t* positions,
                    size_t n_pos,
                    uint8_t* out)
{
    for (size_t r = 0; r < n_rows; ++r) {
        const uint8_t* src = bits + r * row_len;
        uint8_t* dst = out + r * n_pos;
        for (size_t i = 0; i < n_pos; ++i) {
            dst[i] = src[positions[i]];
        }
    }
}

// Scatter bits into positions with zero fill (insertPackedInformationBits
// analogue).
void hc_scatter_bits(const uint8_t* info,
                     size_t n_pos,
                     size_t n_rows,
                     const int64_t* positions,
                     size_t row_len,
                     uint8_t* out)
{
    std::memset(out, 0, n_rows * row_len);
    for (size_t r = 0; r < n_rows; ++r) {
        const uint8_t* src = info + r * n_pos;
        uint8_t* dst = out + r * row_len;
        for (size_t i = 0; i < n_pos; ++i) {
            dst[positions[i]] = src[i];
        }
    }
}

// ---------------------------------------------------------------------------
// CRC engines (bit-level MSB-first; matches detectors.crc_msb_first)
// ---------------------------------------------------------------------------

uint64_t hc_crc_msb_first(const uint8_t* bits,
                          size_t n_bits,
                          uint64_t poly,
                          unsigned width,
                          uint64_t init)
{
    const uint64_t mask = (width >= 64) ? ~0ULL : ((1ULL << width) - 1);
    const uint64_t top = 1ULL << (width - 1);
    uint64_t reg = init & mask;
    for (size_t i = 0; i < n_bits; ++i) {
        uint64_t fb = ((reg & top) != 0) ^ (bits[i] & 1);
        reg = (reg << 1) & mask;
        if (fb)
            reg ^= poly;
    }
    return reg;
}

// Raw CRC-32C over bytes, init 0, no xor-out (reference crc32.cpp
// _mm_crc32_u32 chain semantics).
uint32_t hc_crc32c_bytes(const uint8_t* data, size_t n_bytes, uint32_t init)
{
    uint32_t reg = init;
    for (size_t i = 0; i < n_bytes; ++i) {
        reg ^= data[i];
        for (int b = 0; b < 8; ++b) {
            reg = (reg >> 1) ^ ((reg & 1u) ? 0x82F63B78u : 0u);
        }
    }
    return reg;
}

// Batched bit-level CRC over rows: out[r] = crc(bits[r * row_bits ...]).
void hc_crc_rows(const uint8_t* bits,
                 size_t row_bits,
                 size_t n_rows,
                 uint64_t poly,
                 unsigned width,
                 uint64_t init,
                 uint64_t* out)
{
    for (size_t r = 0; r < n_rows; ++r) {
        out[r] = hc_crc_msb_first(bits + r * row_bits, row_bits, poly, width,
                                  init);
    }
}

// ---------------------------------------------------------------------------
// Butterfly transform on packed rows (host-side golden encoder;
// butterfly_fip_packed.cpp semantics on one bit per uint8)
// ---------------------------------------------------------------------------

void hc_butterfly_rows(uint8_t* bits, size_t n, size_t n_rows)
{
    for (size_t r = 0; r < n_rows; ++r) {
        uint8_t* x = bits + r * n;
        for (size_t s = 1; s < n; s <<= 1) {
            for (size_t i = 0; i < n; i += 2 * s) {
                for (size_t j = 0; j < s; ++j) {
                    x[i + j] ^= x[i + s + j];
                }
            }
        }
    }
}

} // extern "C"
