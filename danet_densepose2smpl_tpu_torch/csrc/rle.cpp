// COCO RLE mask codec — native core (pycocotools C replacement).
//
// The reference leans on pycocotools' C extension to decode the 14-part
// DensePose `dp_masks` RLEs (utils/segms.py:34-40). This implements the same
// subset with a plain C ABI for ctypes:
//   * uncompressed RLE counts -> column-major binary mask
//   * COCO LEB128-style compressed count strings <-> counts
//   * 14-part dp_masks decode -> 256x256 label image
// Build: g++ -O2 -shared -fPIC rle.cpp -o librle.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// counts (n) -> mask (h*w row-major). Returns 0 on success.
int rle_decode(const int64_t* counts, int n, int h, int w, uint8_t* mask_out) {
    // RLE runs are column-major; write directly with transposed indexing.
    std::memset(mask_out, 0, (size_t)h * w);
    int64_t pos = 0;
    uint8_t val = 0;
    const int64_t total = (int64_t)h * w;
    for (int i = 0; i < n; ++i) {
        int64_t c = counts[i];
        if (c < 0 || pos + c > total) return 1;
        if (val) {
            for (int64_t k = pos; k < pos + c; ++k) {
                // column-major flat index k -> (row, col)
                int64_t col = k / h;
                int64_t row = k % h;
                mask_out[row * w + col] = 1;
            }
        }
        pos += c;
        val ^= 1;
    }
    return pos == total ? 0 : 2;
}

// row-major mask -> counts. Returns number of counts (<= h*w+1).
int rle_encode(const uint8_t* mask, int h, int w, int64_t* counts_out) {
    int n = 0;
    uint8_t cur = 0;
    int64_t run = 0;
    for (int64_t k = 0; k < (int64_t)h * w; ++k) {
        int64_t col = k / h;
        int64_t row = k % h;
        uint8_t v = mask[row * w + col] ? 1 : 0;
        if (v == cur) {
            ++run;
        } else {
            counts_out[n++] = run;
            cur = v;
            run = 1;
        }
    }
    counts_out[n++] = run;
    return n;
}

// Compressed COCO count string -> counts. Returns count or -1 on error.
int rle_uncompress(const char* s, int len, int64_t* counts_out, int max_counts) {
    int n = 0;
    int i = 0;
    while (i < len) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= len) return -1;
            int64_t c = (int64_t)(s[i]) - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
        }
        if (n > 2) x += counts_out[n - 2];
        if (n >= max_counts) return -1;
        counts_out[n++] = x;
    }
    return n;
}

// counts -> compressed string. Returns length written (or -1 if too small).
int rle_compress(const int64_t* counts, int n, char* out, int max_len) {
    int p = 0;
    for (int i = 0; i < n; ++i) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        bool more = true;
        while (more) {
            int64_t chunk = x & 0x1f;
            x >>= 5;
            more = !((x == 0 && !(chunk & 0x10)) || (x == -1 && (chunk & 0x10)));
            if (more) chunk |= 0x20;
            if (p >= max_len) return -1;
            out[p++] = (char)(chunk + 48);
        }
    }
    return p;
}

// 14 dp_masks (given as a flat counts buffer + offsets) -> 256x256 labels.
// counts_all: concatenated counts; offsets: (15,) prefix offsets into it.
int dp_masks_decode(const int64_t* counts_all, const int64_t* offsets, uint8_t* label_out) {
    std::memset(label_out, 0, 256 * 256);
    std::vector<uint8_t> tmp(256 * 256);
    for (int part = 0; part < 14; ++part) {
        int64_t lo = offsets[part], hi = offsets[part + 1];
        if (hi <= lo) continue;
        if (rle_decode(counts_all + lo, (int)(hi - lo), 256, 256, tmp.data()) != 0) return 1;
        for (int k = 0; k < 256 * 256; ++k) {
            if (tmp[k]) label_out[k] = (uint8_t)(part + 1);
        }
    }
    return 0;
}

}  // extern "C"
