// AES block encryption (FIPS-197) with the three modes the networking stack
// uses: CTR (RLPx frames, the ECIES body, discv5 header masking), ECB (the
// RLPx frame MAC's one-block seal) and GCM (NIST SP 800-38D; discv5
// messages). Keys of 128, 192 and 256 bits. No mode here needs the inverse
// cipher: CTR and GCM decrypt with the forward one, and the MAC only seals.
//
// A plain C interface for ctypes (net/_aes.py). Table-free byte-wise
// rounds: every call is a few blocks of a handshake, a frame header or a
// discovery packet, so clarity wins over speed. Built with g++ by
// ops/_build.py at first use.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

const uint8_t SBOX[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

inline uint8_t xtime(uint8_t x) { return static_cast<uint8_t>((x << 1) ^ ((x >> 7) * 0x1b)); }

// state s[16] in FIPS-197 column order: s[r + 4c]
void add_round_key(uint8_t* s, const uint8_t* rk) {
    for (int i = 0; i < 16; ++i) s[i] ^= rk[i];
}

void encrypt_block(const uint8_t* rk, int nr, const uint8_t* in, uint8_t* out) {
    uint8_t s[16], t[16];
    std::memcpy(s, in, 16);
    add_round_key(s, rk);
    for (int round = 1; round <= nr; ++round) {
        // SubBytes and ShiftRows together: row r rotates left by r
        for (int c = 0; c < 4; ++c)
            for (int r = 0; r < 4; ++r) t[r + 4 * c] = SBOX[s[r + 4 * ((c + r) & 3)]];
        if (round != nr) {  // MixColumns
            for (int c = 0; c < 4; ++c) {
                uint8_t* col = t + 4 * c;
                uint8_t a0 = col[0], a1 = col[1], a2 = col[2], a3 = col[3];
                uint8_t all = a0 ^ a1 ^ a2 ^ a3;
                col[0] = a0 ^ all ^ xtime(a0 ^ a1);
                col[1] = a1 ^ all ^ xtime(a1 ^ a2);
                col[2] = a2 ^ all ^ xtime(a2 ^ a3);
                col[3] = a3 ^ all ^ xtime(a3 ^ a0);
            }
        }
        std::memcpy(s, t, 16);
        add_round_key(s, rk + 16 * round);
    }
    std::memcpy(out, s, 16);
}

// big-endian increment of the last `width` bytes of a 16-byte block
void increment(uint8_t* block, int width) {
    for (int i = 15; i >= 16 - width; --i)
        if (++block[i] != 0) break;
}

// GF(2^128) product in GCM's bit order (SP 800-38D, Algorithm 1)
void gf_mul(const uint8_t* x, const uint8_t* y, uint8_t* out) {
    uint8_t z[16] = {0}, v[16];
    std::memcpy(v, y, 16);
    for (int i = 0; i < 128; ++i) {
        if ((x[i >> 3] >> (7 - (i & 7))) & 1)
            for (int j = 0; j < 16; ++j) z[j] ^= v[j];
        bool lsb = v[15] & 1;
        for (int j = 15; j > 0; --j) v[j] = static_cast<uint8_t>((v[j] >> 1) | (v[j - 1] << 7));
        v[0] >>= 1;
        if (lsb) v[0] ^= 0xe1;
    }
    std::memcpy(out, z, 16);
}

// y <- (y ^ data) * h over data's 16-byte blocks, the last one zero-padded
void ghash(const uint8_t* h, uint8_t* y, const uint8_t* data, size_t len) {
    for (size_t off = 0; off < len; off += 16) {
        size_t n = len - off < 16 ? len - off : 16;
        for (size_t j = 0; j < n; ++j) y[j] ^= data[off + j];
        gf_mul(y, h, y);
    }
}

void put_be64(uint8_t* p, uint64_t v) {
    for (int i = 7; i >= 0; --i) {
        p[i] = static_cast<uint8_t>(v);
        v >>= 8;
    }
}

}  // namespace

extern "C" {

// Expands a 16-, 24- or 32-byte key into `rk` (240 bytes: (nr + 1) round
// keys of 16 bytes). Returns the number of rounds, or -1 for another length.
int rtaes_expand(const uint8_t* key, int keylen, uint8_t* rk) {
    int nk = keylen / 4;
    if (keylen != 16 && keylen != 24 && keylen != 32) return -1;
    int nr = nk + 6;
    int words = 4 * (nr + 1);
    std::memcpy(rk, key, keylen);
    uint8_t rcon = 1;
    for (int i = nk; i < words; ++i) {
        uint8_t t[4];
        std::memcpy(t, rk + 4 * (i - 1), 4);
        if (i % nk == 0) {
            uint8_t first = t[0];
            t[0] = SBOX[t[1]] ^ rcon;
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[first];
            rcon = xtime(rcon);
        } else if (nk > 6 && i % nk == 4) {
            for (int j = 0; j < 4; ++j) t[j] = SBOX[t[j]];
        }
        for (int j = 0; j < 4; ++j) rk[4 * i + j] = rk[4 * (i - nk) + j] ^ t[j];
    }
    return nr;
}

// ECB encryption of `blocks` whole blocks, in place allowed.
void rtaes_ecb(const uint8_t* rk, int nr, const uint8_t* in, uint8_t* out, uint64_t blocks) {
    for (uint64_t b = 0; b < blocks; ++b) encrypt_block(rk, nr, in + 16 * b, out + 16 * b);
}

// CTR as a stream: `ctr` is the next counter block (a 128-bit big-endian
// counter), `ks` the current keystream block of which `*used` bytes are
// spent (16: none left). XORs `len` bytes of `in` into `out` and advances
// the three, so consecutive calls continue one keystream.
void rtaes_ctr(const uint8_t* rk, int nr, uint8_t* ctr, uint8_t* ks, uint32_t* used,
               const uint8_t* in, uint8_t* out, uint64_t len) {
    uint32_t u = *used;
    for (uint64_t i = 0; i < len; ++i) {
        if (u == 16) {
            encrypt_block(rk, nr, ctr, ks);
            increment(ctr, 16);
            u = 0;
        }
        out[i] = in[i] ^ ks[u++];
    }
    *used = u;
}

// GCM (SP 800-38D) with a 16-byte tag. Encrypt: `out` gets the ciphertext
// and `tag` the tag; returns 0. Decrypt: `in` is the ciphertext, `tag` the
// received tag; `out` gets the plaintext and the call returns 0 when the tag
// matches, 1 when it does not (then `out` is zeroed).
int rtaes_gcm(const uint8_t* rk, int nr, int decrypt, const uint8_t* iv, uint64_t ivlen,
              const uint8_t* aad, uint64_t aadlen, const uint8_t* in, uint64_t len,
              uint8_t* out, uint8_t* tag) {
    uint8_t h[16] = {0}, j0[16] = {0}, lens[16];
    encrypt_block(rk, nr, h, h);
    if (ivlen == 12) {
        std::memcpy(j0, iv, 12);
        j0[15] = 1;
    } else {
        ghash(h, j0, iv, ivlen);
        std::memset(lens, 0, 8);
        put_be64(lens + 8, ivlen * 8);
        ghash(h, j0, lens, 16);
    }
    uint8_t ctr[16], ks[16];
    std::memcpy(ctr, j0, 16);
    increment(ctr, 4);
    uint8_t s[16] = {0};
    ghash(h, s, aad, aadlen);
    if (decrypt) ghash(h, s, in, len);
    for (uint64_t off = 0; off < len; off += 16) {
        encrypt_block(rk, nr, ctr, ks);
        increment(ctr, 4);
        uint64_t n = len - off < 16 ? len - off : 16;
        for (uint64_t j = 0; j < n; ++j) out[off + j] = in[off + j] ^ ks[j];
    }
    if (!decrypt) ghash(h, s, out, len);
    put_be64(lens, aadlen * 8);
    put_be64(lens + 8, len * 8);
    ghash(h, s, lens, 16);
    uint8_t ek[16];
    encrypt_block(rk, nr, j0, ek);
    for (int j = 0; j < 16; ++j) s[j] ^= ek[j];
    if (!decrypt) {
        std::memcpy(tag, s, 16);
        return 0;
    }
    uint8_t diff = 0;
    for (int j = 0; j < 16; ++j) diff |= static_cast<uint8_t>(s[j] ^ tag[j]);
    if (diff) {
        std::memset(out, 0, len);
        return 1;
    }
    return 0;
}

}  // extern "C"
