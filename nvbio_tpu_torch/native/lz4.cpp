// LZ4 block-format codec (compressor + decompressor), self-contained.
//
// A copy of nvbio_tpu/native/lz4.cpp. The reference writes LZ4-compressed
// BWT streams through liblz4 (nvbio/sufsort/file_bwt_lz4.cu,
// file_bwt.cpp:61-80); the port links no liblz4, so it carries its own
// implementation of the PUBLIC LZ4 block format (token = [lit_len:4 |
// match_len-4:4], 255-extension bytes, little-endian u16 match offsets,
// 64 KB window). Greedy single-probe hash matcher, same end-of-block
// rules as the spec: the last 5 bytes are literals and no match starts
// within the last 12 bytes.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> 19; }  // 13-bit

constexpr int kHashBits = 13;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;

}  // namespace

extern "C" {

// worst-case compressed size for n input bytes
int64_t nvb_lz4_bound(int64_t n) { return n + n / 255 + 16; }

// returns compressed size, or -1 if dst too small
int64_t nvb_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap) {
    uint32_t table[kHashSize];
    std::memset(table, 0, sizeof(table));
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    const uint8_t* const mflimit = iend - kMfLimit;
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;

    if (n >= kMfLimit) {
        table[hash4(read32(ip))] = 0;
        ++ip;
        while (ip < mflimit) {
            // single-probe greedy match find (64 KB window)
            const uint8_t* match = nullptr;
            uint32_t h = hash4(read32(ip));
            uint32_t cand = table[h];
            table[h] = (uint32_t)(ip - src);
            const uint8_t* cp = src + cand;
            if (cp < ip && (ip - cp) <= 0xFFFF && read32(cp) == read32(ip))
                match = cp;
            if (!match) {
                ++ip;
                continue;
            }
            // extend backward over equal bytes still in the literal run
            while (ip > anchor && match > src && ip[-1] == match[-1]) {
                --ip;
                --match;
            }
            // emit literal run + match
            int64_t lit = ip - anchor;
            // forward match length (bounded so the block ends in literals)
            const uint8_t* p = ip + kMinMatch;
            const uint8_t* m = match + kMinMatch;
            const uint8_t* limit = iend - kLastLiterals;
            while (p < limit && *p == *m) {
                ++p;
                ++m;
            }
            int64_t mlen = (p - ip) - kMinMatch;  // length beyond minmatch

            int64_t need = 1 + lit / 255 + lit + 2 + mlen / 255 + 1;
            if (op + need > oend) return -1;
            uint8_t* token = op++;
            if (lit >= 15) {
                *token = (uint8_t)(15 << 4);
                int64_t l = lit - 15;
                for (; l >= 255; l -= 255) *op++ = 255;
                *op++ = (uint8_t)l;
            } else {
                *token = (uint8_t)(lit << 4);
            }
            std::memcpy(op, anchor, (size_t)lit);
            op += lit;
            uint16_t off = (uint16_t)(ip - match);
            *op++ = (uint8_t)(off & 0xFF);
            *op++ = (uint8_t)(off >> 8);
            if (mlen >= 15) {
                *token |= 15;
                int64_t l = mlen - 15;
                for (; l >= 255; l -= 255) *op++ = 255;
                *op++ = (uint8_t)l;
            } else {
                *token |= (uint8_t)mlen;
            }
            ip += mlen + kMinMatch;
            anchor = ip;
            if (ip < mflimit) table[hash4(read32(ip))] = (uint32_t)(ip - src);
        }
    }
    // trailing literals
    int64_t lit = iend - anchor;
    int64_t need = 1 + lit / 255 + lit;
    if (op + need > oend) return -1;
    uint8_t* token = op++;
    if (lit >= 15) {
        *token = (uint8_t)(15 << 4);
        int64_t l = lit - 15;
        for (; l >= 255; l -= 255) *op++ = 255;
        *op++ = (uint8_t)l;
    } else {
        *token = (uint8_t)(lit << 4);
    }
    std::memcpy(op, anchor, (size_t)lit);
    op += lit;
    return op - dst;
}

// returns decompressed size, or -1 on malformed input / overflow
int64_t nvb_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, (size_t)lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // block ends with a literals-only token
        if (ip + 2 > iend) return -1;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = (token & 15) + kMinMatch;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return -1;
        const uint8_t* m = op - off;
        // overlapping copies are the spec's RLE mechanism: byte loop
        for (int64_t i = 0; i < mlen; ++i) op[i] = m[i];
        op += mlen;
    }
    return op - dst;
}

}  // extern "C"
