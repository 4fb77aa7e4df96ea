// Native LZ4-block + byte-shuffle codecs for the zarr/Blosc storage layer.
//
// The container logic (c-blosc1 frames, zarr chunk grid) stays in Python
// (gnn_pressure_estimation_tpu_torch/data/codecs.py); these are the per-stream
// hot loops, matching the reference stack's C codecs (numcodecs/c-blosc)
// with a plain C ABI — same pattern as simgen/solver/hydraulic.cpp.
//
// LZ4 block format (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md):
// sequences of [token | literal-LSIC | literals | 2B LE offset | match-LSIC],
// final sequence literals-only; encoder rules: last 5 bytes literal, no match
// starting within the last 12 bytes.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode one LZ4 block into exactly dst_len bytes. Returns bytes written
// or -1 on corrupt input.
int lz4_block_decompress(const uint8_t* src, int src_len,
                         uint8_t* dst, int dst_len) {
    int si = 0, di = 0;
    while (si < src_len) {
        const uint8_t token = src[si++];
        // literals
        int lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (si >= src_len) return -1;
                b = src[si++];
                lit += b;
            } while (b == 255);
        }
        if (lit) {
            if (si + lit > src_len || di + lit > dst_len) return -1;
            std::memcpy(dst + di, src + si, lit);
            si += lit;
            di += lit;
        }
        if (si >= src_len) break;  // last sequence: literals only
        // match
        if (si + 2 > src_len) return -1;
        const int offset = src[si] | (src[si + 1] << 8);
        si += 2;
        if (offset == 0) return -1;
        int mlen = (token & 0xF) + 4;
        if ((token & 0xF) == 15) {
            uint8_t b;
            do {
                if (si >= src_len) return -1;
                b = src[si++];
                mlen += b;
            } while (b == 255);
        }
        int ref = di - offset;
        if (ref < 0 || di + mlen > dst_len) return -1;
        if (offset >= mlen) {
            std::memcpy(dst + di, dst + ref, mlen);
            di += mlen;
        } else {
            for (int k = 0; k < mlen; ++k) dst[di++] = dst[ref++];
        }
    }
    return di == dst_len ? di : -1;
}

static void write_lsic(std::vector<uint8_t>& out, int value) {
    while (value >= 255) {
        out.push_back(255);
        value -= 255;
    }
    out.push_back(static_cast<uint8_t>(value));
}

// Greedy LZ4 block encoder (hash table over 4-byte prefixes). Returns
// compressed size, or -1 if dst_cap is too small.
int lz4_block_compress(const uint8_t* src, int n, uint8_t* dst, int dst_cap) {
    std::vector<uint8_t> out;
    out.reserve(n + n / 255 + 16);
    if (n == 0) {
        out.push_back(0);
    } else {
        constexpr int HASH_BITS = 16;
        std::vector<int32_t> table(1 << HASH_BITS, -1);
        auto hash4 = [&](int i) {
            uint32_t v;
            std::memcpy(&v, src + i, 4);
            return (v * 2654435761u) >> (32 - HASH_BITS);
        };
        auto emit = [&](int lit_start, int lit_end, int mlen, int moff) {
            const int lit = lit_end - lit_start;
            const int tok_lit = lit >= 15 ? 15 : lit;
            int tok_m = 0;
            if (mlen) tok_m = (mlen - 4) >= 15 ? 15 : (mlen - 4);
            out.push_back(static_cast<uint8_t>((tok_lit << 4) | tok_m));
            if (lit >= 15) write_lsic(out, lit - 15);
            out.insert(out.end(), src + lit_start, src + lit_end);
            if (mlen) {
                out.push_back(static_cast<uint8_t>(moff & 0xFF));
                out.push_back(static_cast<uint8_t>(moff >> 8));
                if (mlen - 4 >= 15) write_lsic(out, mlen - 19);
            }
        };
        const int match_limit = n - 5;   // last 5 bytes stay literal
        const int start_limit = n - 12;  // no match starts past here
        int anchor = 0, i = 0;
        while (i <= start_limit) {
            const uint32_t h = hash4(i);
            const int cand = table[h];
            table[h] = i;
            if (cand >= 0 && i - cand <= 0xFFFF &&
                std::memcmp(src + cand, src + i, 4) == 0) {
                int mlen = 4;
                while (i + mlen < match_limit && src[cand + mlen] == src[i + mlen])
                    ++mlen;
                emit(anchor, i, mlen, i - cand);
                i += mlen;
                anchor = i;
            } else {
                ++i;
            }
        }
        emit(anchor, n, 0, 0);
    }
    if (static_cast<int>(out.size()) > dst_cap) return -1;
    std::memcpy(dst, out.data(), out.size());
    return static_cast<int>(out.size());
}

// c-blosc byte shuffle: group byte k of every item together. Trailing
// n % typesize bytes are copied unshuffled (c-blosc convention).
void byte_shuffle(const uint8_t* src, uint8_t* dst, int n, int typesize) {
    if (typesize <= 1 || n < typesize) {
        std::memcpy(dst, src, n);
        return;
    }
    const int items = n / typesize;
    const int body = items * typesize;
    for (int k = 0; k < typesize; ++k) {
        const uint8_t* s = src + k;
        uint8_t* d = dst + k * items;
        for (int j = 0; j < items; ++j) d[j] = s[j * typesize];
    }
    std::memcpy(dst + body, src + body, n - body);
}

void byte_unshuffle(const uint8_t* src, uint8_t* dst, int n, int typesize) {
    if (typesize <= 1 || n < typesize) {
        std::memcpy(dst, src, n);
        return;
    }
    const int items = n / typesize;
    const int body = items * typesize;
    for (int k = 0; k < typesize; ++k) {
        const uint8_t* s = src + k * items;
        uint8_t* d = dst + k;
        for (int j = 0; j < items; ++j) d[j * typesize] = s[j];
    }
    std::memcpy(dst + body, src + body, n - body);
}

}  // extern "C"
