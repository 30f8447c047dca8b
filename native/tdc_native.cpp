// Native host runtime kernels for tudocomp-tpu.
//
// The device compute path is JAX/XLA/Pallas; these are the *host-side*
// sequential kernels where the reference's C++ runtime had tight loops a
// Python interpreter cannot match: BWT LF-walks, MTF table updates,
// canonical-Huffman bit walks, RLE/vbyte stream decoding and the LZ78
// hash-trie parse ((parent<<8)|char keys, reference
// lz78/squeeze_node.hpp:10-30). Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC tdc_native.cpp -o tdc_native.so

#include <cstdint>
#include <climits>
#include <cstring>
#include <vector>
#include <queue>
#include <algorithm>

extern "C" {

// ---- MTF --------------------------------------------------------------

void tdc_mtf_encode(const uint8_t* in, uint8_t* out, int64_t n) {
    uint8_t table[256];
    for (int i = 0; i < 256; i++) table[i] = uint8_t(i);
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        uint8_t j = 0;
        while (table[j] != c) j++;
        out[i] = j;
        memmove(table + 1, table, j);
        table[0] = c;
    }
}

void tdc_mtf_decode(const uint8_t* in, uint8_t* out, int64_t n) {
    uint8_t table[256];
    for (int i = 0; i < 256; i++) table[i] = uint8_t(i);
    for (int64_t i = 0; i < n; i++) {
        uint8_t j = in[i];
        uint8_t c = table[j];
        out[i] = c;
        memmove(table + 1, table, j);
        table[0] = c;
    }
}

// ---- BWT decode (LF walk) --------------------------------------------
// bwt: n bytes of the BWT of a 0-sentineled text (sentinel included).
// out receives n-1 bytes (text without sentinel). Returns 0 on success.

}  // extern "C"

template <typename I>
static void bwt_decode_impl(const uint8_t* bwt, uint8_t* out, int64_t n) {
    std::vector<I> counts(257, 0);
    for (int64_t i = 0; i < n; i++) counts[bwt[i] + 1]++;
    for (int i = 0; i < 256; i++) counts[i + 1] += counts[i];
    std::vector<I> lf(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) lf[size_t(i)] = counts[bwt[i]]++;
    I p = 0;
    for (int64_t j = 1; j < n; j++) {
        out[n - 1 - j] = bwt[p];
        p = lf[size_t(p)];
    }
}

extern "C" {

int tdc_bwt_decode(const uint8_t* bwt, uint8_t* out, int64_t n) {
    if (n <= 1) return 0;
    // int32 LF halves the decode working set for any real input
    if (n < (int64_t(1) << 31)) bwt_decode_impl<int32_t>(bwt, out, n);
    else bwt_decode_impl<int64_t>(bwt, out, n);
    return 0;
}

// ---- RLE decode -------------------------------------------------------
// Decodes the capped-run format (cc + vbyte(run-2+offset)). Returns the
// number of output bytes, or -1 if out_cap would be exceeded.

int64_t tdc_rle_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t out_cap, int64_t offset) {
    int64_t o = 0;
    int64_t i = 0;
    int prev = -1;
    while (i < n) {
        uint8_t c = in[i++];
        if (o >= out_cap) return -1;
        out[o++] = c;
        if (int(c) == prev) {
            uint64_t run = 0;
            int shift = 0;
            bool terminated = false;
            while (i < n) {
                uint8_t b = in[i++];
                if (shift > 63) return -2;  // malformed: vbyte continuation overflow
                if (shift == 63 && (b & 0x7F) > 1) return -2;
                run |= uint64_t(b & 0x7F) << shift;
                shift += 7;
                if (!(b & 0x80)) { terminated = true; break; }
            }
            // input ended mid-vbyte (continuation bit on the final
            // byte): reject instead of using the partial value
            if (!terminated) return -2;
            if (offset < 0 || run < uint64_t(offset)) return -2;  // malformed stream
            run -= uint64_t(offset);
            if (run > uint64_t(out_cap) || o + int64_t(run) > out_cap) return -1;
            memset(out + o, c, size_t(run));
            o += int64_t(run);
            prev = int(c);  // reference keeps prev armed after a run
        } else {
            prev = int(c);
        }
    }
    return o;
}

// ---- canonical Huffman decode ----------------------------------------
// MSB-first payload; lut_sym/lut_len are 2^k entries (full-depth LUT).
// Returns bits consumed, or -1 on error.

int64_t tdc_huffman_decode(const uint8_t* payload, int64_t payload_len,
                           int64_t count, const uint8_t* lut_sym,
                           const uint8_t* lut_len, int k,
                           uint8_t* out) {
    uint64_t window = 0;
    int have = 0;
    int64_t pos = 0;  // next payload byte
    int64_t bits_used = 0;
    for (int64_t i = 0; i < count; i++) {
        while (have < k && pos < payload_len) {
            window = (window << 8) | payload[pos++];
            have += 8;
        }
        if (have < k) {  // pad with zeros at stream end
            window <<= (k - have);
            have = k;
        }
        uint64_t idx = (window >> (have - k)) & ((1ULL << k) - 1);
        uint8_t len = lut_len[idx];
        if (len == 0 || len > have) return -1;
        out[i] = lut_sym[idx];
        have -= len;
        bits_used += len;
    }
    return bits_used;
}

// Count symbols decodable from the payload until bits are exhausted.
int64_t tdc_huffman_count(const uint8_t* payload, int64_t nbits,
                          const uint8_t* lut_len, int k) {
    int64_t pos = 0;
    int64_t count = 0;
    while (pos < nbits) {
        int64_t w = 0;
        for (int i = 0; i < k; i++) {
            int64_t b = (pos + i < nbits)
                ? ((payload[(pos + i) >> 3] >> (7 - ((pos + i) & 7))) & 1)
                : 0;
            w = (w << 1) | b;
        }
        uint8_t len = lut_len[w];
        if (len == 0) return -1;
        pos += len;
        count++;
    }
    return count;
}

// ---- LZ78/LZW hash-trie parse ----------------------------------------
// Parses `in` with an LZ78 dictionary backed by an open-addressing hash
// table keyed by (parent << 8) | char. Emits (ref, char) pairs for LZ78
// (lzw == 0) or running references for LZW (lzw == 1, roots preseeded).
// Returns the number of factors, or -1 if out buffers are too small.

static inline uint64_t mix(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33; return x;
}

int64_t tdc_lz78_parse(const uint8_t* in, int64_t n, int lzw,
                       int64_t dict_limit,
                       uint32_t* out_refs, uint8_t* out_chars,
                       int64_t out_cap) {
    int64_t cap = 64;
    while (cap < 4 * n + 1024) cap <<= 1;
    std::vector<uint64_t> keys(cap, ~0ULL);
    std::vector<uint32_t> vals(cap, 0);
    uint64_t mask = uint64_t(cap) - 1;

    auto find_or_insert = [&](uint32_t parent, uint8_t c,
                              uint32_t fresh) -> int64_t {
        uint64_t key = (uint64_t(parent) << 8) | c;
        uint64_t h = mix(key) & mask;
        while (true) {
            if (keys[h] == ~0ULL) {
                keys[h] = key;
                vals[h] = fresh;
                return -1;  // inserted
            }
            if (keys[h] == key) return int64_t(vals[h]);
            h = (h + 1) & mask;
        }
    };

    int64_t count = 0;       // factors emitted
    uint32_t next_id = 1;    // LZ78: ids start at 1 (0 = root)
    uint32_t lzw_next = 256; // LZW: roots 0..255 preseeded
    uint32_t node = 0;       // current node (LZ78: 0 = root)
    uint32_t parent = 0;     // node's parent (for the trailing factor)
    uint8_t last_c = 0;
    int lzw_active = 0;
    uint32_t lzw_node = 0;

    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        last_c = c;
        if (!lzw) {
            int64_t child = find_or_insert(node, c, next_id);
            if (child < 0) {
                if (count >= out_cap) return -1;
                out_refs[count] = node;
                out_chars[count] = c;
                count++;
                next_id++;
                parent = node = 0;
                if (dict_limit && next_id > uint32_t(dict_limit)) {
                    // dictionary reset (reference LZ78Compressor :110-116)
                    std::fill(keys.begin(), keys.end(), ~0ULL);
                    next_id = 1;
                }
            } else {
                parent = node;
                node = uint32_t(child);
            }
        } else {
            if (!lzw_active) { lzw_node = c; lzw_active = 1; continue; }
            int64_t child = find_or_insert(lzw_node, c, lzw_next);
            if (child < 0) {
                if (count >= out_cap) return -1;
                out_refs[count++] = lzw_node;
                lzw_next++;
                lzw_node = c;
                if (dict_limit && lzw_next > uint32_t(dict_limit) + 256) {
                    std::fill(keys.begin(), keys.end(), ~0ULL);
                    lzw_next = 256;
                }
            } else {
                lzw_node = uint32_t(child);
            }
        }
    }
    // trailing state: the partial phrase is (parent, last char)
    if (!lzw) {
        if (node != 0) {
            if (count >= out_cap) return -1;
            out_refs[count] = parent;
            out_chars[count] = last_c;
            count++;
        }
    } else if (lzw_active) {
        if (count >= out_cap) return -1;
        out_refs[count++] = lzw_node;
    }
    return count;
}

// ---- lzss_lcp factorization ------------------------------------------
// Naive PSV/NSV factorization over SA/ISA/LCP (mirrors the Python spec
// in compressors/lzss.py:factorize_lcp, reference
// LZSSLCPCompressor.hpp:60-115). Returns factor count or -1 on overflow.

}  // extern "C"

template <typename I>
static int64_t lzss_lcp_factorize_impl(const I* sa, const I* isa,
                                       const I* lcp, int64_t n,
                                       int64_t threshold,
                                       I* out_pos, I* out_src,
                                       I* out_len, int64_t cap) {
    int64_t count = 0;
    int64_t i = 0;
    while (i + 1 < n) {
        int64_t cur = isa[i];
        int64_t psv_lcp = lcp[cur];
        int64_t psv_pos = cur - 1;
        if (psv_lcp > 0) {
            while (psv_pos >= 0 && sa[psv_pos] > sa[cur]) {
                if (lcp[psv_pos] < psv_lcp) psv_lcp = lcp[psv_pos];
                psv_pos--;
            }
        }
        int64_t nsv_lcp = 0;
        int64_t nsv_pos = cur + 1;
        if (nsv_pos < n) {
            nsv_lcp = INT64_MAX;
            while (true) {
                if (lcp[nsv_pos] < nsv_lcp) nsv_lcp = lcp[nsv_pos];
                if (sa[nsv_pos] < sa[cur]) break;
                nsv_pos++;
                if (nsv_pos >= n) { nsv_lcp = 0; break; }
            }
        }
        int64_t max_lcp = psv_lcp > nsv_lcp ? psv_lcp : nsv_lcp;
        if (max_lcp >= threshold) {
            int64_t max_pos = (max_lcp == psv_lcp) ? psv_pos : nsv_pos;
            if (count >= cap) return -1;
            out_pos[count] = I(i);
            out_src[count] = sa[max_pos];
            out_len[count] = I(max_lcp);
            count++;
            i += max_lcp;
        } else {
            i++;
        }
    }
    return count;
}

extern "C" {

int64_t tdc_lzss_lcp_factorize(const int64_t* sa, const int64_t* isa,
                               const int64_t* lcp, int64_t n,
                               int64_t threshold,
                               int64_t* out_pos, int64_t* out_src,
                               int64_t* out_len, int64_t cap) {
    return lzss_lcp_factorize_impl<int64_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lzss_lcp_factorize32(const int32_t* sa, const int32_t* isa,
                                 const int32_t* lcp, int64_t n,
                                 int64_t threshold,
                                 int32_t* out_pos, int32_t* out_src,
                                 int32_t* out_len, int64_t cap) {
    return lzss_lcp_factorize_impl<int32_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

// ---- LZ78 phrase expansion -------------------------------------------
// Replays (ref, char) factors; refs are 1-based into prior factors,
// 0 = root. Returns output length or -1 if out_cap exceeded.

int64_t tdc_lz78_expand(const uint32_t* refs, const uint8_t* chars,
                        int64_t nfac, uint8_t* out, int64_t out_cap) {
    // factor end offsets in the output let us copy phrases directly
    std::vector<int64_t> ends(nfac);
    int64_t o = 0;
    for (int64_t f = 0; f < nfac; f++) {
        uint32_t r = refs[f];
        int64_t phrase_len = 1;
        if (r > uint64_t(f)) return -2;  // ref must point to an emitted factor
        if (r != 0) {
            int64_t prev_start = (r >= 2) ? ends[r - 2] : 0;
            int64_t prev_len = ends[r - 1] - prev_start;
            phrase_len += prev_len;
            if (o + phrase_len > out_cap) return -1;
            memcpy(out + o, out + prev_start, size_t(prev_len));
            o += prev_len;
        } else if (o + 1 > out_cap) {
            return -1;
        }
        out[o++] = chars[f];
        ends[f] = o;
    }
    return o;
}

// ---- LZW expansion ----------------------------------------------------
// Replays LZW codes (roots 0..255, entries learned one code late). A
// dictionary entry's content is a contiguous span of the output
// (previous phrase + first char of the next), so expansion is memcpy.
// Returns output length or -1 if out_cap exceeded.

int64_t tdc_lzw_expand(const uint32_t* codes, int64_t ncodes,
                       uint8_t* out, int64_t out_cap) {
    std::vector<int64_t> estart;
    std::vector<int64_t> elen;
    estart.reserve(ncodes);
    elen.reserve(ncodes);
    int64_t o = 0;
    int64_t prev_start = 0, prev_len = 0;
    for (int64_t j = 0; j < ncodes; j++) {
        uint32_t k = codes[j];
        int64_t cur_start = o, cur_len;
        if (k < 256) {
            if (o + 1 > out_cap) return -1;
            out[o++] = uint8_t(k);
            cur_len = 1;
        } else {
            uint32_t e = k - 256;
            int64_t src, len;
            if (e < estart.size()) {
                src = estart[e]; len = elen[e];
            } else if (e == estart.size() && j > 0) {
                // self-referential: prev phrase + its first char
                src = prev_start; len = prev_len + 1;
                if (o + len > out_cap) return -1;
                memcpy(out + o, out + prev_start, size_t(prev_len));
                out[o + prev_len] = out[prev_start];
                o += len;
                // register the entry being used
                estart.push_back(prev_start);
                elen.push_back(prev_len + 1);
                prev_start = cur_start; prev_len = len;
                continue;
            } else {
                return -2;  // invalid code
            }
            if (o + len > out_cap) return -1;
            memcpy(out + o, out + src, size_t(len));
            o += len;
            cur_len = len;
        }
        if (j > 0) {
            estart.push_back(prev_start);
            elen.push_back(prev_len + 1);
        }
        prev_start = cur_start;
        prev_len = cur_len;
    }
    return o;
}

// ---- SLP derivation ---------------------------------------------------
// Expands a binary SLP (terminals < 256; rule i: pairs[2i], pairs[2i+1])
// from `root` iteratively. Returns output length or -1 on overflow.

int64_t tdc_slp_derive(const int64_t* pairs, int64_t nrules,
                       int64_t root, uint8_t* out, int64_t out_cap) {
    std::vector<int64_t> stack;
    stack.push_back(root);
    int64_t o = 0;
    while (!stack.empty()) {
        int64_t x = stack.back();
        stack.pop_back();
        if (x < 256) {
            if (o >= out_cap) return -1;
            out[o++] = uint8_t(x);
        } else {
            int64_t r = x - 256;
            if (r >= nrules) return -2;
            stack.push_back(pairs[2 * r + 1]);
            stack.push_back(pairs[2 * r]);
        }
    }
    return o;
}

// ---- lcpcomp "arrays" factorization ----------------------------------
// Bucket array per LCP value with lazy decrease-key (reference
// lcpcomp/compress/ArraysComp.hpp; mirrors the Python spec in
// compressors/lcpcomp.py exactly). Returns factor count or -1.

}  // extern "C"

template <typename I>
static int64_t lcpcomp_arrays_impl(const I* sa, const I* isa,
                                   I* lcp, int64_t n, int64_t threshold,
                                   I* out_pos, I* out_src,
                                   I* out_len, int64_t cap) {
    int64_t maxlcp = 0;
    for (int64_t i = 0; i < n; i++)
        maxlcp = std::max<int64_t>(maxlcp, lcp[i]);
    if (maxlcp < threshold) return 0;
    // candidate buckets at index width I: english-class inputs push
    // ~0.6 entries/char here, the kernel's biggest allocation
    std::vector<std::vector<I>> cand(size_t(maxlcp + 1 - threshold));
    for (int64_t i = 0; i < n; i++) {
        if (lcp[i] >= threshold)
            cand[size_t(lcp[i] - threshold)].push_back(I(i));
    }
    int64_t count = 0;
    for (int64_t cur = maxlcp; cur >= threshold; cur--) {
        auto& col = cand[size_t(cur - threshold)];
        for (size_t ci = 0; ci < col.size(); ci++) {
            int64_t index = col[ci];
            int64_t lv = lcp[index];
            if (lv < cur) {
                if (lv >= threshold)
                    cand[size_t(lv - threshold)].push_back(I(index));
                continue;
            }
            int64_t pos = sa[index];
            int64_t src = sa[index - 1];
            int64_t len = lv;
            if (count >= cap) return -1;
            out_pos[count] = I(pos); out_src[count] = I(src);
            out_len[count] = I(len);
            count++;
            for (int64_t k = 0; k < len; k++) lcp[isa[pos + k]] = 0;
            int64_t max_affect = std::min(len, pos);
            for (int64_t k = 1; k <= max_affect; k++) {
                int64_t ind = isa[pos - k];
                if (k < lcp[ind]) lcp[ind] = I(k);
            }
        }
        col.clear();
        col.shrink_to_fit();
    }
    return count;
}

extern "C" {

int64_t tdc_lcpcomp_arrays(const int64_t* sa, const int64_t* isa,
                           int64_t* lcp, int64_t n, int64_t threshold,
                           int64_t* out_pos, int64_t* out_src,
                           int64_t* out_len, int64_t cap) {
    return lcpcomp_arrays_impl<int64_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lcpcomp_arrays32(const int32_t* sa, const int32_t* isa,
                             int32_t* lcp, int64_t n, int64_t threshold,
                             int32_t* out_pos, int32_t* out_src,
                             int32_t* out_len, int64_t cap) {
    return lcpcomp_arrays_impl<int32_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

// ---- PLCP (Karkkainen phi-algorithm) ---------------------------------
// Templated on the index width: the int32 instantiation (n < 2^31)
// halves the index-array footprint, the reference's IntVector /
// CompressMode role on this path (ds/TextDS.hpp:140-147).

}  // extern "C"

template <typename I>
static void tdc_plcp_impl(const uint8_t* text, const I* phi, int64_t n,
                          I* plcp) {
    int64_t l = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = phi[i];
        while (i + l < n && j + l < n && text[i + l] == text[j + l]) l++;
        plcp[i] = I(l);
        if (l) l--;
    }
}

extern "C" {

void tdc_plcp(const uint8_t* text, const int64_t* phi, int64_t n,
              int64_t* plcp) {
    tdc_plcp_impl<int64_t>(text, phi, n, plcp);
}

void tdc_plcp32(const uint8_t* text, const int32_t* phi, int64_t n,
                int32_t* plcp) {
    tdc_plcp_impl<int32_t>(text, phi, n, plcp);
}

// ---- suffix array (prefix doubling + radix sort) ---------------------
// O(n log n) counting-sort doubling; same output as any correct SA.

void tdc_suffix_array(const uint8_t* text, int64_t n, int64_t* sa) {
    if (n == 0) return;
    std::vector<int64_t> rank(n), tmp(n), cnt(std::max<int64_t>(256, n) + 1, 0), sa2(n);
    for (int64_t i = 0; i < n; i++) rank[i] = text[i];
    // initial counting sort by first byte
    for (int64_t i = 0; i < n; i++) cnt[rank[i] + 1]++;
    for (size_t i = 1; i < cnt.size(); i++) cnt[i] += cnt[i - 1];
    for (int64_t i = 0; i < n; i++) sa[cnt[rank[i]]++] = i;
    for (int64_t k = 1;; k <<= 1) {
        // sort by second key (rank[i+k], -1 past end): positions i >= n-k first
        int64_t p = 0;
        for (int64_t i = n - k; i < n; i++) sa2[p++] = i;
        for (int64_t i = 0; i < n; i++)
            if (sa[i] >= k) sa2[p++] = sa[i] - k;
        // stable counting sort by first key rank[]
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; i++) cnt[rank[i] + 1]++;
        for (size_t i = 1; i < cnt.size(); i++) cnt[i] += cnt[i - 1];
        for (int64_t i = 0; i < n; i++) sa[cnt[rank[sa2[i]]]++] = sa2[i];
        // re-rank
        tmp[sa[0]] = 0;
        int64_t r = 0;
        for (int64_t i = 1; i < n; i++) {
            int64_t a = sa[i - 1], b = sa[i];
            int64_t a2 = (a + k < n) ? rank[a + k] : -1;
            int64_t b2 = (b + k < n) ? rank[b + k] : -1;
            if (rank[a] != rank[b] || a2 != b2) r++;
            tmp[b] = r;
        }
        rank.swap(tmp);
        if (r == n - 1) break;
        if (k >= n) break;
    }
}

// ---- lzss factor-stream decode ---------------------------------------
// Decodes the shared factor stream (lzss/LZSSCoding.hpp format) given
// the bit offset after the 4 header fields. Literals decode with the
// canonical-huffman LUT when k > 0, plain 8-bit otherwise.
// mode 0: back-reference text reconstruction into out (returns length).
// mode 1: collect factors/literals only (for forward-capable lcpcomp):
//   out receives the literal bytes; fpos/fsrc/flen receive factors;
//   *nfac_out gets the count; returns literal count. Returns -1 on
//   overflow, -2 on malformed stream.

struct BitRd {
    const uint8_t* p;
    int64_t nbits;
    int64_t pos;
    inline int64_t read(int w) {
        if (w == 0) return 0;
        int64_t v = 0;
        for (int i = 0; i < w; i++) {
            int64_t b = (pos < nbits)
                ? ((p[pos >> 3] >> (7 - (pos & 7))) & 1) : 0;
            v = (v << 1) | b;
            pos++;
        }
        return v;
    }
    // variable-length integer codes (mirror io/bitio.py readers);
    // every reader returns -1 on a truncated/overlong code
    inline int64_t read_unary() {
        int64_t z = 0;
        while (pos < nbits &&
               !((p[pos >> 3] >> (7 - (pos & 7))) & 1)) { z++; pos++; }
        if (pos >= nbits) return -1;
        pos++;  // the terminating 1
        return z;
    }
    inline int64_t read_gamma() {
        int64_t m = read_unary();
        if (m < 0 || m > 62 || pos + m > nbits) return -1;
        return read(int(m));
    }
    inline int64_t read_delta() {
        int64_t m = read_gamma();
        if (m < 0 || m > 62 || pos + m > nbits) return -1;
        return read(int(m));
    }
    inline int64_t read_ternary() {
        if (pos + 2 > nbits) return -1;
        int64_t mod = read(2);
        int64_t v = 0;
        if (mod < 3) {
            int64_t b3 = 1;
            for (;;) {
                v += mod * b3;
                b3 *= 3;
                if (pos + 2 > nbits) return -1;
                mod = read(2);
                if (mod == 3) break;
                if (b3 > (int64_t(1) << 60)) return -1;
            }
            v += 1;
        }
        return v;
    }
    inline int64_t read_ascii_int() {
        // decimal digits then one terminator byte (ASCIICoder)
        int64_t v = 0;
        bool any = false;
        for (;;) {
            if (pos + 8 > nbits) return any ? v : -1;
            int64_t c = read(8);
            if (c < '0' || c > '9') break;
            any = true;
            if (v > (int64_t(1) << 55)) return -1;
            v = v * 10 + (c - '0');
        }
        return v;
    }
    // kind: 0 = fixed width w, 1 = gamma, 2 = delta, 3 = ternary,
    // 4 = ascii decimal
    inline int64_t read_code(int kind, int w) {
        switch (kind) {
            case 0: return read(w);
            case 1: return read_gamma();
            case 2: return read_delta();
            case 3: return read_ternary();
            default: return read_ascii_int();
        }
    }
    // the coders' BitRange: 1 bit, except ascii's '0'/'1' byte
    inline int64_t read_flag(int kind) {
        if (kind == 4) {
            if (pos + 8 > nbits) return -1;
            return read(8) == '0' ? 0 : 1;
        }
        return read(1);
    }
};

int64_t tdc_lzss_decode(const uint8_t* payload, int64_t nbits,
                        int64_t start_bit, int64_t n, int64_t flen_min,
                        int w_src, int w_len, int w_dist,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int k, int mode, int code_kind,
                        uint8_t* out, int64_t out_cap,
                        int64_t* fpos, int64_t* fsrc, int64_t* flen,
                        int64_t fcap, int64_t* nfac_out) {
    BitRd rd{payload, nbits, start_bit};
    int64_t cursor = 0;   // text position
    int64_t lits = 0;     // literal count (mode 1)
    int64_t nfac = 0;
    auto read_literal = [&]() -> int {
        if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
            int64_t v = rd.read_code(code_kind, 8);
            if (v < 0 || v > 255) return -1;
            return int(v);
        }
        if (k > 0) {
            // peek k bits (zero padded), LUT walk
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) return -1;
            rd.pos = save + len;
            return lut_sym[w];
        }
        return int(rd.read(8));
    };
    while (rd.pos < nbits) {
        int64_t flag = rd.read_flag(code_kind);
        if (flag < 0) return -2;
        if (flag) {
            if (rd.pos >= nbits) break;
            int64_t num = rd.read_code(code_kind, w_dist);
            if (num < 0) return -2;
            for (int64_t i = 0; i < num; i++) {
                int c = read_literal();
                if (c < 0) return -2;
                if (mode == 0) {
                    if (cursor >= out_cap) return -1;
                    out[cursor++] = uint8_t(c);
                } else {
                    if (lits >= out_cap) return -1;
                    out[lits++] = uint8_t(c);
                    cursor++;
                }
            }
        }
        if (rd.pos >= nbits) break;
        int64_t src = rd.read_code(code_kind, w_src);
        int64_t len0 = rd.read_code(code_kind, w_len);
        if (src < 0 || len0 < 0) return -2;
        // MinDistributedRange: the fixed-width coder stores v - min;
        // the VLC coders (gamma/delta/ternary/ascii) store v verbatim
        int64_t len = code_kind == 0 ? len0 + flen_min : len0;
        if (mode == 0) {
            if (cursor + len > out_cap || src + len > out_cap) return -1;
            if (src < 0 || src >= cursor) return -2;  // back-references only
            for (int64_t i = 0; i < len; i++)
                out[cursor + i] = out[src + i];  // overlap-safe fwd copy
            cursor += len;
        } else {
            if (nfac >= fcap) return -1;
            fpos[nfac] = cursor; fsrc[nfac] = src; flen[nfac] = len;
            nfac++;
            cursor += len;
        }
    }
    if (nfac_out) *nfac_out = nfac;
    return (mode == 0) ? cursor : lits;
}

// ---- lcpcomp "heap" factorization ------------------------------------
// Max-heap with lazy invalidation (mirrors compressors/lcpcomp.py
// MaxHeapStrategy exactly, including heapq tie order: ties on LCP pop
// the smaller SA index first).

}  // extern "C"

template <typename I>
static int64_t lcpcomp_heap_impl(const I* sa, const I* isa,
                                 I* lcp, int64_t n, int64_t threshold,
                                 I* out_pos, I* out_src,
                                 I* out_len, int64_t cap) {
    // packed entry: lcp in the high 32 bits, bit-inverted index low —
    // a max-heap on the u64 pops the largest LCP and, on ties, the
    // smallest index (same order as the pair-based formulation).
    auto pack = [](int64_t lv, int64_t i) -> uint64_t {
        return (uint64_t(lv) << 32) | uint64_t(~uint32_t(i));
    };
    std::vector<uint64_t> init;
    init.reserve(size_t(n) / 4);
    for (int64_t i = 0; i < n; i++)
        if (lcp[i] >= threshold) init.push_back(pack(lcp[i], i));
    std::priority_queue<uint64_t> heap(
        std::less<uint64_t>(), std::move(init));  // O(n) make_heap
    int64_t count = 0;
    while (!heap.empty()) {
        uint64_t key = heap.top();
        heap.pop();
        int64_t index = int64_t(~uint32_t(key & 0xFFFFFFFFu));
        int64_t lv = lcp[index];
        if (lv != int64_t(key >> 32)) {
            if (lv >= threshold) heap.push(pack(lv, index));
            continue;
        }
        int64_t pos = sa[index], src = sa[index - 1], len = lv;
        if (count >= cap) return -1;
        out_pos[count] = I(pos); out_src[count] = I(src);
        out_len[count] = I(len);
        count++;
        for (int64_t k = 0; k < len; k++) lcp[isa[pos + k]] = 0;
        int64_t max_affect = std::min(len, pos);
        for (int64_t k = 1; k <= max_affect; k++) {
            int64_t ind = isa[pos - k];
            if (k < lcp[ind]) lcp[ind] = I(k);
        }
    }
    return count;
}

extern "C" {

int64_t tdc_lcpcomp_heap(const int64_t* sa, const int64_t* isa,
                         int64_t* lcp, int64_t n, int64_t threshold,
                         int64_t* out_pos, int64_t* out_src,
                         int64_t* out_len, int64_t cap) {
    return lcpcomp_heap_impl<int64_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lcpcomp_heap32(const int32_t* sa, const int32_t* isa,
                           int32_t* lcp, int64_t n, int64_t threshold,
                           int32_t* out_pos, int32_t* out_src,
                           int32_t* out_len, int64_t cap) {
    return lcpcomp_heap_impl<int32_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

// ---- SLE literal-stream decode ---------------------------------------
// Decodes the SLE literal stream until bits are exhausted (flag 1:
// gamma k-mer rank; flag 0 + 1: gamma literal rank; else raw byte).
// Returns output length, -1 on overflow, -2 on malformed input.

int64_t tdc_sle_decode(const uint8_t* payload, int64_t nbits,
                       int64_t start_bit, const uint8_t* kmers,
                       int64_t n_kmers, int kk, const uint8_t* lits,
                       int64_t n_lits, uint8_t* out, int64_t out_cap) {
    BitRd rd{payload, nbits, start_bit};
    int64_t o = 0;
    auto read_gamma = [&]() -> int64_t {
        int zeros = 0;
        while (rd.pos < rd.nbits && rd.read(1) == 0) zeros++;
        return rd.read(zeros);
    };
    while (rd.pos < nbits) {
        if (rd.read(1)) {
            int64_t r = read_gamma();
            if (r >= n_kmers) return -2;
            if (o + kk > out_cap) return -1;
            memcpy(out + o, kmers + r * kk, size_t(kk));
            o += kk;
        } else if (rd.pos >= nbits) {
            break;
        } else if (rd.read(1)) {
            int64_t r = read_gamma();
            if (r >= n_lits) return -2;
            if (o >= out_cap) return -1;
            out[o++] = lits[r];
        } else {
            if (o >= out_cap) return -1;
            out[o++] = uint8_t(rd.read(8));
        }
    }
    return o;
}

// ---- suffix tree from SA+LCP (lcp-interval stack) --------------------
// Mirrors ds/suffix_tree.py exactly. Output arrays sized >= 2n+2.
// Returns the node count.

}  // extern "C"

template <typename I>
static int64_t suffix_tree_impl(const I* sa, const I* lcp, int64_t n,
                                I* parent, I* sdepth,
                                uint8_t* is_leaf, I* suffix,
                                I* leaf_of_rank) {
    int64_t m = 0;  // node count
    parent[0] = -1; sdepth[0] = 0; is_leaf[0] = 0; suffix[0] = -1; m = 1;
    std::vector<I> stack;
    stack.push_back(0);
    auto add = [&](int64_t d, bool leaf, int64_t suf) -> int64_t {
        parent[m] = I(-1); sdepth[m] = I(d);
        is_leaf[m] = leaf ? 1 : 0; suffix[m] = I(suf);
        return m++;
    };
    for (int64_t i = 0; i < n; i++) {
        int64_t l = i ? lcp[i] : 0;
        int64_t last = -1;
        while (sdepth[stack.back()] > l) {
            int64_t v = stack.back(); stack.pop_back();
            if (last != -1) parent[last] = I(v);
            last = v;
        }
        if (last != -1) {
            if (sdepth[stack.back()] == l) {
                parent[last] = stack.back();
            } else {
                int64_t u = add(l, false, -1);
                parent[last] = I(u);
                stack.push_back(I(u));
            }
        }
        int64_t leaf = add(n - sa[i], true, sa[i]);
        leaf_of_rank[i] = I(leaf);
        stack.push_back(I(leaf));
    }
    int64_t last = -1;
    while (!stack.empty()) {
        int64_t v = stack.back(); stack.pop_back();
        if (last != -1) parent[last] = I(v);
        last = v;
    }
    return m;
}

extern "C" {

int64_t tdc_suffix_tree(const int64_t* sa, const int64_t* lcp, int64_t n,
                        int64_t* parent, int64_t* sdepth,
                        uint8_t* is_leaf, int64_t* suffix,
                        int64_t* leaf_of_rank) {
    return suffix_tree_impl<int64_t>(
        sa, lcp, n, parent, sdepth, is_leaf, suffix, leaf_of_rank);
}

int64_t tdc_suffix_tree32(const int32_t* sa, const int32_t* lcp,
                          int64_t n, int32_t* parent, int32_t* sdepth,
                          uint8_t* is_leaf, int32_t* suffix,
                          int32_t* leaf_of_rank) {
    return suffix_tree_impl<int32_t>(
        sa, lcp, n, parent, sdepth, is_leaf, suffix, leaf_of_rank);
}

// ---- LFS2 two-layer longest-first substitution -------------------------
// Re-derivation of lfs/LFS2Compressor.hpp:36-330: enumerate lcp-interval
// tree nodes (stack algorithm over SA+LCP instead of sdsl cst_sct3),
// process them by string depth descending; per node, greedily pick
// non-overlapping occurrences that are either first-layer viable (both
// endpoints unsubstituted) or second-layer viable (inside an earlier
// NT's definition window); substitute when >=1 first-layer and >=2
// total. Outputs the reference's four position maps + the NT list.

struct Lfs2Node { int64_t depth, lb, rb; };

static int64_t lfs2_parse_impl(const int64_t* sa, const int64_t* lcp,
                       int64_t m, int64_t n, int64_t min_lrf,
                       uint32_t* fl_nts, uint32_t* fl_off,
                       uint32_t* sl_nts, uint8_t* sl_dead,
                       int64_t* nts_start, int64_t* nts_len,
                       int64_t nts_cap, int two_layer) {
    // lcp-interval nodes via the classic stack sweep (m = SA entries
    // incl. sentinel suffix, n = text length without sentinel)
    std::vector<Lfs2Node> nodes;
    {
        std::vector<Lfs2Node> stack;
        stack.push_back({0, 0, -1});
        for (int64_t i = 1; i <= m; i++) {
            int64_t l = (i < m) ? lcp[i] : 0;
            int64_t lb = i - 1;
            while (!stack.empty() && l < stack.back().depth) {
                Lfs2Node top = stack.back(); stack.pop_back();
                top.rb = i - 1;
                lb = top.lb;
                if (top.depth >= min_lrf && top.rb > top.lb)
                    nodes.push_back(top);
            }
            if (stack.empty() || l > stack.back().depth)
                stack.push_back({l, lb, -1});
        }
    }
    // depth-descending stable order
    std::stable_sort(nodes.begin(), nodes.end(),
                     [](const Lfs2Node& a, const Lfs2Node& b) {
                         return a.depth > b.depth;
                     });
    memset(fl_nts, 0, sizeof(uint32_t) * size_t(n));
    memset(fl_off, 0, sizeof(uint32_t) * size_t(n));
    memset(sl_nts, 0, sizeof(uint32_t) * size_t(n));
    memset(sl_dead, 0, size_t(n));
    int64_t count = 0;
    std::vector<int64_t> occs, fl_viable, sl_viable;
    for (const Lfs2Node& node : nodes) {
        int64_t i = node.depth;
        occs.assign(sa + node.lb, sa + node.rb + 1);
        std::sort(occs.begin(), occs.end());
        if (occs.back() - occs.front() < i) continue;  // all overlap
        fl_viable.clear();
        sl_viable.clear();
        int64_t last = -i;
        for (int64_t occ : occs) {
            if (last + i > occ) continue;
            if (occ >= n || occ + i > n) continue;
            if (fl_off[occ] == 0) {
                if (fl_off[occ + i - 1] == 0) {
                    fl_viable.push_back(occ);
                    last = occ;
                }
            } else if (two_layer) {
                uint32_t parent = fl_nts[occ - (fl_off[occ] - 1)];
                if (parent && nts_len[parent - 1] >= int64_t(fl_off[occ]) - 1 + i)
                    sl_viable.push_back(occ);
            }
        }
        if ((two_layer
                 ? (fl_viable.size() >= 1 &&
                    fl_viable.size() + sl_viable.size() >= 2)
                 : fl_viable.size() >= 2)) {
            if (count >= nts_cap) return -1;
            nts_start[count] = fl_viable.front();
            nts_len[count] = i;
            uint32_t id = uint32_t(++count);
            for (int64_t occ : fl_viable) {
                fl_nts[occ] = id;
                for (int64_t k = 0; k < i; k++)
                    fl_off[occ + k] = uint32_t(k + 1);
            }
            for (int64_t occ : sl_viable) {
                uint32_t parent = fl_nts[occ - (fl_off[occ] - 1)];
                int64_t pstart = nts_start[parent - 1];
                int64_t sl_start = pstart + fl_off[occ] - 1;
                int64_t sl_end = sl_start + i - 1;
                if (!sl_dead[sl_start] && !sl_dead[sl_end]) {
                    sl_nts[sl_start] = id;
                    for (int64_t d = sl_start; d <= sl_end; d++)
                        sl_dead[d] = 1;
                }
            }
        }
    }
    return count;
}

int64_t tdc_lfs2_parse(const int64_t* sa, const int64_t* lcp, int64_t m,
                       int64_t n, int64_t min_lrf,
                       uint32_t* fl_nts, uint32_t* fl_off,
                       uint32_t* sl_nts, uint8_t* sl_dead,
                       int64_t* nts_start, int64_t* nts_len,
                       int64_t nts_cap) {
    return lfs2_parse_impl(sa, lcp, m, n, min_lrf, fl_nts, fl_off,
                           sl_nts, sl_dead, nts_start, nts_len,
                           nts_cap, 1);
}

// Single-layer variant for the LFS st/esa strategies: no second-layer
// substitution, rules need >= 2 first-layer occurrences.
int64_t tdc_lfs_parse(const int64_t* sa, const int64_t* lcp, int64_t m,
                      int64_t n, int64_t min_lrf,
                      uint32_t* fl_nts, uint32_t* fl_off,
                      uint32_t* sl_nts, uint8_t* sl_dead,
                      int64_t* nts_start, int64_t* nts_len,
                      int64_t nts_cap) {
    return lfs2_parse_impl(sa, lcp, m, n, min_lrf, fl_nts, fl_off,
                           sl_nts, sl_dead, nts_start, nts_len,
                           nts_cap, 0);
}

// ---- lcpcomp "compact" decompression ----------------------------------
// Forward-bucket resolution (reference decompress/CompactDec.hpp:18-40):
// every position copied from source s registers a waiter on s; once a
// byte becomes known it propagates to its waiters (iterative stack
// instead of the reference's recursion). O(n + total factor length).

int64_t tdc_lcpcomp_compact(int64_t n, const uint8_t* lit_bytes,
                            const int64_t* lit_pos, int64_t nlit,
                            const int64_t* fpos, const int64_t* fsrc,
                            const int64_t* flen, int64_t nfac,
                            uint8_t* out) {
    // counting-sort waiters by source position
    std::vector<int64_t> cnt((size_t)n + 1, 0);
    int64_t total_w = 0;
    for (int64_t f = 0; f < nfac; f++) {
        if (fpos[f] < 0 || fsrc[f] < 0 || flen[f] < 0) return -2;
        if (fpos[f] + flen[f] > n || fsrc[f] + flen[f] > n) return -2;
        for (int64_t k = 0; k < flen[f]; k++) cnt[(size_t)(fsrc[f] + k)]++;
        total_w += flen[f];
    }
    std::vector<int64_t> start((size_t)n + 1, 0);
    for (int64_t i = 0; i < n; i++) start[(size_t)(i + 1)] = start[(size_t)i] + cnt[(size_t)i];
    std::vector<int64_t> waiters((size_t)total_w);
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t f = 0; f < nfac; f++)
        for (int64_t k = 0; k < flen[f]; k++)
            waiters[(size_t)fill[(size_t)(fsrc[f] + k)]++] = fpos[f] + k;
    std::vector<uint8_t> known((size_t)n, 0);
    std::vector<int64_t> stack;
    stack.reserve(1024);
    for (int64_t i = 0; i < nlit; i++) {
        int64_t p = lit_pos[i];
        if (p < 0 || p >= n) return -2;
        out[p] = lit_bytes[i];
        known[(size_t)p] = 1;
        stack.push_back(p);
        while (!stack.empty()) {
            int64_t q = stack.back(); stack.pop_back();
            for (int64_t w = start[(size_t)q]; w < start[(size_t)q + 1]; w++) {
                int64_t t = waiters[(size_t)w];
                if (!known[(size_t)t]) {
                    out[t] = out[q];
                    known[(size_t)t] = 1;
                    stack.push_back(t);
                }
            }
        }
    }
    for (int64_t i = 0; i < n; i++)
        if (!known[(size_t)i]) return -3;  // unresolved (cyclic/missing)
    return 0;
}

// ---- monotone subsequence decomposition (ESP "succinct" coding) -------
// Re-derivation of esp/MonotoneSubsequences.hpp create_dpi_and_b_...:
// repeatedly extract the longest monotone (increasing vs decreasing,
// tie -> increasing) subsequence of the remaining sorted-index sequence
// via patience piles with parent links. Dpi[rank] = subsequence id;
// b[id] = 0 increasing / 1 decreasing. Returns subsequence count.

static int64_t patience_lis(const int64_t* vals, int64_t m, int sign,
                            std::vector<int64_t>& tails,
                            std::vector<int64_t>& tails_idx,
                            std::vector<int64_t>& parent,
                            std::vector<int64_t>& out_idx) {
    tails.clear(); tails_idx.clear();
    parent.assign(size_t(m), -1);
    for (int64_t k = 0; k < m; k++) {
        int64_t v = sign * vals[k];
        // first pile with tail >= v (strictly increasing subsequence)
        size_t lo = 0, hi = tails.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (tails[mid] >= v) hi = mid; else lo = mid + 1;
        }
        if (lo > 0) parent[size_t(k)] = tails_idx[lo - 1];
        if (lo == tails.size()) {
            tails.push_back(v); tails_idx.push_back(k);
        } else {
            tails[lo] = v; tails_idx[lo] = k;
        }
    }
    out_idx.clear();
    int64_t cur = tails_idx.empty() ? -1 : tails_idx.back();
    while (cur != -1) { out_idx.push_back(cur); cur = parent[size_t(cur)]; }
    std::reverse(out_idx.begin(), out_idx.end());
    return int64_t(tails.size());
}

int64_t tdc_monotone_decompose(const int64_t* sis, int64_t n,
                               int64_t* Dpi, uint8_t* b, int64_t b_cap) {
    std::vector<int64_t> active((size_t)n);
    std::vector<int64_t> vals((size_t)n);
    for (int64_t i = 0; i < n; i++) active[size_t(i)] = i;
    std::vector<int64_t> tails, tails_idx, parent, inc, dec;
    int64_t rounds = 0;
    int64_t m = n;
    while (m > 0) {
        for (int64_t k = 0; k < m; k++)
            vals[size_t(k)] = sis[active[size_t(k)]];
        int64_t li = patience_lis(vals.data(), m, +1, tails, tails_idx,
                                  parent, inc);
        int64_t ld = patience_lis(vals.data(), m, -1, tails, tails_idx,
                                  parent, dec);
        const std::vector<int64_t>& take = (li >= ld) ? inc : dec;
        if (rounds >= b_cap) return -1;
        b[rounds] = (li >= ld) ? 0 : 1;
        // mark and compact
        int64_t t = 0;
        int64_t w = 0;
        for (int64_t k = 0; k < m; k++) {
            if (t < int64_t(take.size()) && take[size_t(t)] == k) {
                Dpi[active[size_t(k)]] = rounds;
                t++;
            } else {
                active[size_t(w++)] = active[size_t(k)];
            }
        }
        m = w;
        rounds++;
    }
    return rounds;
}

// ---- TBC2 container (models/blockcodec.py) ---------------------------
// Per-segment framing: vbyte(count<<2 | rle_raw<<1 | huff_raw),
// vbyte(payload_bytes), payload. Parse fills per-segment arrays; decode
// runs canonical-Huffman LUT walk + RLE expansion per segment (reference
// semantics: coders/HuffmanCoder.hpp:377-397, RunLengthEncoder.hpp).

static inline int64_t tbc2_read_vbyte(const uint8_t* d, int64_t n,
                                      int64_t* pos, uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < n) {
        uint8_t b = d[(*pos)++];
        if (shift > 63) return -2;
        v |= uint64_t(b & 0x7F) << shift;
        shift += 7;
        if (!(b & 0x80)) { *out = v; return 0; }
    }
    return -2;
}

int64_t tdc_tbc2_parse(const uint8_t* data, int64_t n, int64_t pos,
                       int64_t nseg, uint32_t* counts, uint8_t* flags,
                       int64_t* poff, int64_t* pbytes) {
    for (int64_t i = 0; i < nseg; i++) {
        uint64_t m1, m2;
        if (tbc2_read_vbyte(data, n, &pos, &m1) < 0) return -2;
        if (tbc2_read_vbyte(data, n, &pos, &m2) < 0) return -2;
        // malformed-container bounds: a count past 32 bits would
        // silently alias under the uint32_t store, and a payload
        // length >= 2^63 would wrap pos negative and bypass pos > n
        if ((m1 >> 2) > 0xFFFFFFFFull) return -2;
        if (m2 > uint64_t(n)) return -2;
        counts[i] = uint32_t(m1 >> 2);
        flags[i] = uint8_t(m1 & 3);
        poff[i] = pos;
        pbytes[i] = int64_t(m2);
        pos += int64_t(m2);
        if (pos > n) return -2;
    }
    return pos;
}

// Decode segments [lo, hi). out must hold orig_len bytes; segment i
// writes out[i*seg .. i*seg + min(seg, orig_len - i*seg)). Returns 0,
// or -2 on malformed input. GIL-free; callers shard [lo,hi) per thread.
int64_t tdc_tbc2_decode(const uint8_t* data, const uint32_t* counts,
                        const uint8_t* flags, const int64_t* poff,
                        const int64_t* pbytes, int64_t lo, int64_t hi,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int k, int64_t seg, int64_t orig_len,
                        int64_t offset, uint8_t* out) {
    std::vector<uint8_t> syms(size_t(2 * seg));
    for (int64_t i = lo; i < hi; i++) {
        int64_t n_out = orig_len - i * seg;
        if (n_out > seg) n_out = seg;
        if (n_out <= 0) break;
        int64_t cnt = int64_t(counts[i]);
        if (cnt > 2 * seg) return -2;
        const uint8_t* payload = data + poff[i];
        int64_t pb = pbytes[i];
        const uint8_t* sp;
        if (flags[i] & 1) {  // huff_raw: verbatim symbol bytes
            if (cnt > pb) return -2;
            sp = payload;
        } else {
            if (k <= 0) return -2;
            if (tdc_huffman_decode(payload, pb, cnt, lut_sym, lut_len,
                                   k, syms.data()) < 0)
                return -2;
            sp = syms.data();
        }
        uint8_t* dst = out + i * seg;
        if (flags[i] & 2) {  // rle_raw: symbols are output bytes
            if (cnt < n_out) return -2;
            memcpy(dst, sp, size_t(n_out));
        } else {
            int64_t got = tdc_rle_decode(sp, cnt, dst, n_out, offset);
            if (got != n_out) return -2;
        }
    }
    return 0;
}

}  // extern "C"

// ---- Re-Pair grammar construction -------------------------------------
// Larsson/Moffat-style near-linear Re-Pair (reference
// RePairCompressor.hpp:96-340 does O(n) rescan rounds; this replaces
// the rescans with neighbor links + per-digram occurrence lists + a
// lazy max-heap, so total work is O(n log n)).
//
// Structures over the symbol array:
//   sym[i]   current symbol at slot i (-1 = removed)
//   nxt/prv  doubly-linked active-slot list
//   od_nxt/od_prv  occurrence list links: slots holding the same digram
//   hash map digram(left<<32|right) -> {count, head, tail}
//   heap     lazy max-heap of (count, entry); stale tops are skipped
// Replacing digram D at slot i (right partner j=nxt[i]): the left
// neighbor digram at prv[i] and right digram at j are unlinked and
// decremented, slot j is removed, and the two digrams created around
// the fresh non-terminal are inserted. Occurrences are processed in
// slot order, each re-validated (overlaps like "aaa" self-destruct).

namespace repair_detail {

struct DigramEntry {
    uint64_t key;
    int64_t count;
    int32_t head, tail;
    int64_t best;   // high-water count already pushed into the heap
    int64_t epoch;  // last rule index that touched this entry
};

struct DigramMap {
    std::vector<DigramEntry> entries;
    std::vector<int32_t> table;  // open addressing -> entry idx, -1 empty
    uint64_t mask;

    explicit DigramMap(int64_t n) {
        uint64_t cap = 64;
        while (cap < uint64_t(2 * n)) cap <<= 1;
        table.assign(cap, -1);
        mask = cap - 1;
        entries.reserve(size_t(n / 2 + 16));
    }
    int32_t find_or_add(uint64_t key) {
        uint64_t h = key * 0x9E3779B97F4A7C15ull;
        uint64_t s = (h >> 32) & mask;
        while (true) {
            int32_t e = table[s];
            if (e < 0) {
                table[s] = int32_t(entries.size());
                entries.push_back({key, 0, -1, -1, 0, -1});
                return table[s];
            }
            if (entries[size_t(e)].key == key) return e;
            s = (s + 1) & mask;
        }
    }
};

}  // namespace repair_detail

extern "C" {

// Returns num_rules (>= 0), or -1 if rules_cap was exceeded.
// rules_out holds pairs (left, right); symbols >= 256 are rule ids + 256.
// start_out receives the compacted start sequence, *start_len_out its
// length.
int64_t tdc_repair(const uint8_t* text, int64_t n, int64_t max_rules,
                   int32_t* rules_out, int64_t rules_cap,
                   int32_t* start_out, int64_t* start_len_out) {
    using repair_detail::DigramMap;
    if (n <= 0) { *start_len_out = 0; return 0; }
    size_t un = size_t(n);
    // Interleaved per-position records: the replacement loop hops the
    // text list (sym/nxt/prv) and the occurrence list (od_*) at random
    // positions, so splitting these across six arrays cost ~6 cache
    // lines per hop; two 12-byte structs cost at most two. od_ent
    // memoizes the digram-map entry a position is linked under, so
    // occ_remove needs NO hash probe (the round-3 version re-hashed
    // the digram on every removal — ~3 probes per replacement).
    struct Node { int32_t sym, nxt, prv; };
    struct Occ { int32_t od_nxt, od_prv, od_ent; };
    std::vector<Node> nd(un);
    std::vector<Occ> oc(un, {-1, -1, -1});
    for (int64_t i = 0; i < n; i++) {
        nd[size_t(i)].sym = text[i];
        nd[size_t(i)].nxt = (i + 1 < n) ? int32_t(i + 1) : -1;
        nd[size_t(i)].prv = int32_t(i - 1);
    }
    DigramMap map(n);
    std::priority_queue<uint64_t> heap;  // count<<32 | entry idx

    auto key_at = [&](int64_t i) -> uint64_t {
        return (uint64_t(uint32_t(nd[size_t(i)].sym)) << 32) |
               uint32_t(nd[size_t(nd[size_t(i)].nxt)].sym);
    };
    auto link = [&](int64_t i, int32_t e) {
        auto& en = map.entries[size_t(e)];
        oc[size_t(i)] = {-1, en.tail, e};
        if (en.tail >= 0) oc[size_t(en.tail)].od_nxt = int32_t(i);
        else en.head = int32_t(i);
        en.tail = int32_t(i);
        en.count++;
    };
    // Deferred heap maintenance: pops only ever happen between rules
    // (the replacement loop never pops), so pushing intermediate
    // high-water counts during a rule is pure churn — the round-3
    // version pushed every increment and paid 31M stale pops on
    // english.10MB (97% of all pops, ~70% of total runtime). Instead,
    // each rule records the set of touched entries (epoch-deduped) and
    // pushes ONE key per entry whose live count exceeds its pushed
    // high-water after the rule completes. The lazy-deletion invariant
    // (every entry keeps a heap key >= its live count; stale pops
    // re-arm the live count) and therefore the valid-pop order are
    // byte-for-byte unchanged.
    std::vector<int32_t> touched;
    int64_t epoch = 0;
    auto touch = [&](int32_t e) {
        auto& en = map.entries[size_t(e)];
        if (en.epoch != epoch) {
            en.epoch = epoch;
            touched.push_back(e);
        }
    };
    auto occ_append = [&](int64_t i) {
        int32_t e = map.find_or_add(key_at(i));
        link(i, e);
        touch(e);
    };
    auto occ_remove = [&](int64_t i) {
        auto& o = oc[size_t(i)];
        int32_t e = o.od_ent;
        auto& en = map.entries[size_t(e)];
        int32_t p = o.od_prv, q = o.od_nxt;
        if (p >= 0) oc[size_t(p)].od_nxt = q; else en.head = q;
        if (q >= 0) oc[size_t(q)].od_prv = p; else en.tail = p;
        o = {-1, -1, -1};
        en.count--;
        touch(e);
    };

    for (int64_t i = 0; i + 1 < n; i++)
        link(i, map.find_or_add(key_at(i)));
    for (size_t e = 0; e < map.entries.size(); e++) {
        auto& en = map.entries[e];
        en.best = en.count;
        if (en.count >= 2)
            heap.push((uint64_t(en.count) << 32) | uint32_t(e));
    }

    int64_t num_rules = 0;
    std::vector<int64_t> occs;
    while (num_rules < max_rules && !heap.empty()) {
        uint64_t top = heap.top();
        heap.pop();
        int32_t e = int32_t(top & 0xFFFFFFFFu);
        int64_t cnt = int64_t(top >> 32);
        auto& en = map.entries[size_t(e)];
        if (en.count != cnt) {  // stale: re-arm the live count
            en.best = en.count;
            if (en.count >= 2)
                heap.push((uint64_t(en.count) << 32) | uint32_t(e));
            continue;
        }
        if (cnt < 2) break;             // true maximum below threshold
        uint64_t key = en.key;
        int32_t a = int32_t(key >> 32), b = int32_t(key & 0xFFFFFFFFu);
        if (num_rules >= rules_cap) return -1;
        int32_t fresh = int32_t(256 + num_rules);
        rules_out[2 * num_rules] = a;
        rules_out[2 * num_rules + 1] = b;
        num_rules++;
        occs.clear();
        for (int32_t it = en.head; it >= 0; it = oc[size_t(it)].od_nxt)
            occs.push_back(it);
        std::sort(occs.begin(), occs.end());
        for (int64_t i : occs) {
            // re-validate: an earlier replacement this round (overlap
            // like "aaa") may have destroyed this occurrence
            if (nd[size_t(i)].sym != a) continue;
            int32_t j = nd[size_t(i)].nxt;
            if (j < 0 || nd[size_t(j)].sym != b) continue;
            int32_t l = nd[size_t(i)].prv, r = nd[size_t(j)].nxt;
            if (l >= 0) occ_remove(l);
            if (r >= 0) occ_remove(j);
            occ_remove(i);
            nd[size_t(i)].sym = fresh;
            nd[size_t(j)].sym = -1;
            nd[size_t(i)].nxt = r;
            if (r >= 0) nd[size_t(r)].prv = int32_t(i);
            if (l >= 0) occ_append(l);
            if (r >= 0) occ_append(i);
        }
        for (int32_t te : touched) {
            auto& ten = map.entries[size_t(te)];
            if (ten.count > ten.best) {
                ten.best = ten.count;
                heap.push((uint64_t(ten.count) << 32) | uint32_t(te));
            }
        }
        touched.clear();
        epoch++;
    }

    int64_t m = 0;
    for (int32_t i = 0; i >= 0; i = nd[size_t(i)].nxt)
        start_out[m++] = nd[size_t(i)].sym;
    *start_len_out = m;
    return num_rules;
}

}  // extern "C"

// ---- ESP rounds --------------------------------------------------------
// Native mirror of compressors/esp.py:esp_rounds (reference
// compressors/EspCompressor.hpp round structure, esp_math.hpp iter_log,
// landmark_spanner, BlockAdjust). Bit-for-bit identical rule list and
// root to the Python implementation: same metablock classification,
// eager-1/3 splits, alphabet reduction, landmark spans, 1-block merge
// and first-use rule-id assignment.

namespace esp_detail {

struct PairMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    std::vector<int32_t> table;
    uint64_t mask;

    explicit PairMap(int64_t n) {
        // entries are bounded by the total rule count <= n, so a 2n
        // pow2 table keeps load <= 50% (4n cost 2 GB alone at 100 MB)
        uint64_t cap = 64;
        while (cap < uint64_t(2 * n)) cap <<= 1;
        table.assign(cap, -1);
        mask = cap - 1;
    }
    // returns existing id or assigns next_id (first-use order)
    int32_t get_or_add(uint64_t key, int32_t next_id, bool* added) {
        uint64_t h = key * 0x9E3779B97F4A7C15ull;
        uint64_t s = (h >> 32) & mask;
        while (true) {
            int32_t e = table[s];
            if (e < 0) {
                table[s] = int32_t(keys.size());
                keys.push_back(key);
                vals.push_back(next_id);
                *added = true;
                return next_id;
            }
            if (keys[size_t(e)] == key) { *added = false; return vals[size_t(e)]; }
            s = (s + 1) & mask;
        }
    }
};

inline int iter_log(int64_t n) {
    if (n < 7) return 0;
    if (n < 9) return 1;
    if (n < 17) return 2;
    if (n < 257) return 3;
    return 4;
}

inline void split13(int64_t len, std::vector<int32_t>& out) {
    int64_t rest = len;
    while (rest > 4) { out.push_back(3); rest -= 3; }
    if (rest == 4) { out.push_back(2); out.push_back(2); }
    else if (rest) out.push_back(int32_t(rest));
}

inline int64_t label(int64_t l, int64_t r) {
    uint64_t diff = uint64_t(l ^ r);
    int ctz = __builtin_ctzll(diff);
    return 2 * int64_t(ctz) + ((r >> ctz) & 1);
}

// reduced-label landmark blocks (esp.py:_landmark_blocks, tie_to_right)
inline void landmark_blocks(const int64_t* seg, int64_t m,
                            std::vector<int32_t>& out) {
    if (m == 1) { out.push_back(1); return; }
    std::vector<uint8_t> high(static_cast<size_t>(m));
    for (int64_t i = 0; i < m; i++) {
        int64_t lv = i > 0 ? seg[i - 1] : -1;
        int64_t rv = i < m - 1 ? seg[i + 1] : -1;
        high[size_t(i)] = seg[i] > lv && seg[i] > rv;
    }
    std::vector<int64_t> idx;
    for (int64_t i = 0; i < m; i++) {
        bool lm = high[size_t(i)];
        if (!lm) {
            int64_t lv = i > 0 ? seg[i - 1] : 4;
            int64_t rv = i < m - 1 ? seg[i + 1] : 4;
            bool low = seg[i] < lv && seg[i] < rv;
            bool nbr = (i > 0 && high[size_t(i - 1)]) ||
                       (i < m - 1 && high[size_t(i + 1)]);
            lm = low && !nbr;
        }
        if (lm) idx.push_back(i);
    }
    if (idx.empty()) { split13(m, out); return; }
    std::vector<std::pair<int64_t, int64_t>> spans;
    for (int64_t i : idx) {
        int64_t l = i > 0 ? i - 1 : i;
        int64_t r = i < m - 1 ? i + 1 : i;
        if (!spans.empty()) {
            if (l == spans.back().second) spans.back().second -= 1;
            l = spans.back().second + 1;
            if (l > r) continue;
        } else {
            l = 0;
        }
        spans.push_back({l, r});
    }
    spans.back().second = m - 1;
    for (auto& sp : spans) split13(sp.second - sp.first + 1, out);
}

// esp.py:_reduce_alphabet — iterated labels then 3/4/5 remap
inline void reduce_alphabet(const int32_t* seg, int64_t m, int passes,
                            std::vector<int64_t>& buf) {
    buf.resize(size_t(m));
    for (int64_t i = 0; i < m; i++) buf[size_t(i)] = seg[i];
    int64_t cur = m;
    for (int p = 0; p < passes; p++) {
        for (int64_t i = 0; i + 1 < cur; i++)
            buf[size_t(i)] = label(buf[size_t(i)], buf[size_t(i + 1)]);
        cur -= 1;
    }
    buf.resize(size_t(cur));
    for (int64_t v = 3; v <= 5; v++) {
        for (int64_t i = 0; i < cur; i++) {
            if (buf[size_t(i)] != v) continue;
            int64_t e = 0;
            int64_t n0 = i > 0 ? buf[size_t(i - 1)] : -1;
            int64_t n1 = i < cur - 1 ? buf[size_t(i + 1)] : -1;
            if (n0 == e) e++;
            if (n1 == e) e++;
            if (n0 == e) e++;
            if (n1 == e) e++;
            buf[size_t(i)] = e;
        }
    }
}

}  // namespace esp_detail

extern "C" {

// Returns number of rules (>= 0) or -1 on cap overflow. rules_out
// holds (left, right) pairs, ids >= 256 are rule ids + 256.
int64_t tdc_esp_rounds(const uint8_t* text, int64_t n,
                       int32_t* rules_out, int64_t rules_cap,
                       int64_t* root_out) {
    using namespace esp_detail;
    if (n <= 0) { *root_out = 0; return 0; }
    std::vector<int32_t> s(static_cast<size_t>(n));
    std::vector<int32_t> s2;
    for (int64_t i = 0; i < n; i++) s[size_t(i)] = text[i];
    PairMap map(n);
    int64_t num_rules = 0;
    int64_t alphabet = 256;
    std::vector<int32_t> blocks, merged;
    std::vector<int64_t> reduced;

    auto rule_id = [&](int32_t a, int32_t b) -> int64_t {
        uint64_t key = (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
        bool added = false;
        int32_t rid = map.get_or_add(key, int32_t(256 + num_rules), &added);
        if (added) {
            if (num_rules >= rules_cap) return -1;
            rules_out[2 * num_rules] = a;
            rules_out[2 * num_rules + 1] = b;
            num_rules++;
        }
        return rid;
    };

    while (int64_t(s.size()) > 1) {
        int64_t sz = int64_t(s.size());
        blocks.clear();
        int64_t i = 0;
        while (i < sz) {
            int64_t j = i;
            while (j + 1 < sz && s[size_t(j + 1)] == s[size_t(i)]) j++;
            if (j > i) {  // type 1: repeating run
                split13(j - i + 1, blocks);
                i = j + 1;
            } else {  // group consecutive singleton runs: type 2 segment
                int64_t e = i;
                while (e + 1 < sz && s[size_t(e + 1)] != s[size_t(e)] &&
                       (e + 2 >= sz || s[size_t(e + 2)] != s[size_t(e + 1)]))
                    e++;
                int64_t seglen = e - i + 1;
                int64_t p = iter_log(alphabet);
                if (p > seglen) p = seglen;
                split13(p, blocks);
                if (p < seglen) {
                    reduce_alphabet(s.data() + i, seglen, int(p), reduced);
                    landmark_blocks(reduced.data(),
                                    int64_t(reduced.size()), blocks);
                }
                i = e + 1;
            }
        }
        // merge length-1 blocks (esp.py:_merge_one_blocks)
        merged.clear();
        for (int32_t L : blocks) {
            merged.push_back(L);
            while (merged.size() >= 2 &&
                   (merged.back() == 1 || merged[merged.size() - 2] == 1)) {
                int32_t b = merged.back(); merged.pop_back();
                int32_t a = merged.back(); merged.pop_back();
                int32_t total = a + b;
                if (total == 4) { merged.push_back(2); merged.push_back(2); }
                else merged.push_back(total);
            }
        }
        // blocks -> rules
        s2.clear();
        int64_t pos = 0;
        for (int32_t L : merged) {
            int64_t rid;
            if (L == 2) {
                rid = rule_id(s[size_t(pos)], s[size_t(pos + 1)]);
            } else {
                int64_t inner = rule_id(s[size_t(pos)], s[size_t(pos + 1)]);
                if (inner < 0) return -1;
                rid = rule_id(int32_t(inner), s[size_t(pos + 2)]);
            }
            if (rid < 0) return -1;
            s2.push_back(int32_t(rid));
            pos += L;
        }
        if (pos != sz) return -2;  // internal invariant violation
        alphabet = 256 + num_rules;
        s.swap(s2);
    }
    *root_out = s[0];
    return num_rules;
}

// SLP dependency sort (esp.py:slp_dep_sort; reference SLPDepSort.hpp).
// Renumbers rules so left children are non-decreasing. Exact mirror of
// the Python heap construction incl. (key, old) tie-breaking, so the
// output permutation is identical. Returns 0, or -2 if the grammar has
// a dependency cycle.
int64_t tdc_slp_dep_sort(const int64_t* rules, int64_t n, int64_t root,
                         int64_t* out, int64_t* new_root) {
    if (n == 0) { *new_root = root; return 0; }
    std::vector<int64_t> wait_head(size_t(n), -1);
    std::vector<int64_t> wait_next(size_t(n), -1);
    std::vector<int64_t> wait_tail(size_t(n), -1);
    typedef std::pair<int64_t, int64_t> KO;
    std::priority_queue<KO, std::vector<KO>, std::greater<KO>> heap;
    for (int64_t old = 0; old < n; old++) {
        int64_t left = rules[2 * old];
        if (left < 256) {
            heap.push({left, old});
        } else {
            int64_t p = left - 256;
            if (p < 0 || p >= n) return -2;
            // append preserving old-index order
            if (wait_head[size_t(p)] < 0) wait_head[size_t(p)] = old;
            else wait_next[size_t(wait_tail[size_t(p)])] = old;
            wait_tail[size_t(p)] = old;
        }
    }
    std::vector<int64_t> newid(size_t(n), -1);
    std::vector<int64_t> order_key(static_cast<size_t>(n));
    std::vector<int64_t> order_old(static_cast<size_t>(n));
    int64_t count = 0;
    while (!heap.empty()) {
        KO top = heap.top();
        heap.pop();
        int64_t old = top.second;
        int64_t idx = count;
        newid[size_t(old)] = idx;
        order_key[size_t(idx)] = top.first;
        order_old[size_t(idx)] = old;
        count++;
        for (int64_t dep = wait_head[size_t(old)]; dep >= 0;
             dep = wait_next[size_t(dep)])
            heap.push({256 + idx, dep});
    }
    if (count != n) return -2;
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = order_key[size_t(i)];
        int64_t rt = rules[2 * order_old[size_t(i)] + 1];
        out[2 * i + 1] =
            rt < 256 ? rt : 256 + newid[size_t(rt - 256)];
    }
    *new_root = root < 256 ? root : 256 + newid[size_t(root - 256)];
    return 0;
}

}  // extern "C"

// ---- SLE token emission + SLE factor-stream decode ----------------------
// Host-side SLE coder kernels (coders/sle.py). Bit-identical to the
// Python scalar emitter: per emission either (flag=1, gamma(kmer rank))
// or (flag=0, flag, gamma(lit rank) | raw byte). Gamma of v is one token
// of value (1<<b)|v and length 2b+1 with b = bits_for(v) >= 1
// (reference util.hpp:194 semantics).

extern "C" {

static inline uint64_t tdc_gamma_tok(int64_t v, int64_t* len_out) {
    int b = 1;
    while ((uint64_t(v) >> b) != 0) b++;
    *len_out = 2 * int64_t(b) + 1;
    return (uint64_t(1) << b) | uint64_t(v);
}

// Greedy 3-gram matcher over one literal run buf[0..n); emits tokens for
// emissions starting strictly below `limit`. Appends to values/lens at
// *ntok_inout. Returns the consumed byte count, or -1 on token overflow.
int64_t tdc_sle_run_tokens(const uint8_t* buf, int64_t n, int64_t limit,
                           const int64_t* sorted_keys,
                           const int64_t* key_rank, int64_t n_kmers,
                           int kk, const int32_t* lit_rank,
                           uint64_t* values, int64_t* lens, int64_t cap,
                           int64_t* ntok_inout) {
    int64_t nt = *ntok_inout;
    int64_t i = 0;
    while (i < limit) {
        int64_t rank = -1;
        if (n_kmers > 0 && i + kk <= n) {
            int64_t key = 0;
            for (int j = 0; j < kk; j++) key = (key << 8) | buf[i + j];
            int64_t lo = 0, hi = n_kmers;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (sorted_keys[mid] < key) lo = mid + 1; else hi = mid;
            }
            if (lo < n_kmers && sorted_keys[lo] == key)
                rank = key_rank[lo];
        }
        if (rank >= 0) {
            if (nt + 2 > cap) return -1;
            values[nt] = 1; lens[nt] = 1; nt++;
            int64_t gl; uint64_t gv = tdc_gamma_tok(rank, &gl);
            values[nt] = gv; lens[nt] = gl; nt++;
            i += kk;
        } else {
            if (nt + 3 > cap) return -1;
            values[nt] = 0; lens[nt] = 1; nt++;
            int32_t lr = lit_rank[buf[i]];
            if (lr >= 0) {
                values[nt] = 1; lens[nt] = 1; nt++;
                int64_t gl; uint64_t gv = tdc_gamma_tok(lr, &gl);
                values[nt] = gv; lens[nt] = gl; nt++;
            } else {
                values[nt] = 0; lens[nt] = 1; nt++;
                values[nt] = buf[i]; lens[nt] = 8; nt++;
            }
            i += 1;
        }
    }
    *ntok_inout = nt;
    return i;
}

// Whole factor-stream body under the SLE coder (lzss/LZSSCoding.hpp
// layout after the 4 header fields): per factor a gap flag bit,
// [gap length in w_dist bits, SLE gap literal tokens], src in w_src
// bits, (len - flen_min) in w_len bits; then a trailing literal run.
// Each gap is matched independently (the scalar coder flushes `final`
// before every non-literal field). Returns the token count or -1.
int64_t tdc_factor_stream_sle(const uint8_t* text, int64_t n,
                              const int64_t* fpos, const int64_t* fsrc,
                              const int64_t* flen, int64_t nfac,
                              int w_src, int w_len, int w_dist,
                              int64_t flen_min,
                              const int64_t* sorted_keys,
                              const int64_t* key_rank, int64_t n_kmers,
                              int kk, const int32_t* lit_rank,
                              uint64_t* values, int64_t* lens,
                              int64_t cap) {
    int64_t nt = 0;
    int64_t p = 0;
    auto emit_gap = [&](int64_t start, int64_t glen) -> bool {
        if (nt + 2 > cap) return false;
        values[nt] = 1; lens[nt] = 1; nt++;
        values[nt] = uint64_t(glen); lens[nt] = w_dist; nt++;
        int64_t got = tdc_sle_run_tokens(
            text + start, glen, glen, sorted_keys, key_rank, n_kmers,
            kk, lit_rank, values, lens, cap, &nt);
        return got == glen;
    };
    for (int64_t f = 0; f < nfac; f++) {
        if (fpos[f] == p) {
            if (nt + 1 > cap) return -1;
            values[nt] = 0; lens[nt] = 1; nt++;
        } else {
            if (!emit_gap(p, fpos[f] - p)) return -1;
            p = fpos[f];
        }
        if (nt + 2 > cap) return -1;
        values[nt] = uint64_t(fsrc[f]); lens[nt] = w_src; nt++;
        values[nt] = uint64_t(flen[f] - flen_min); lens[nt] = w_len; nt++;
        p += flen[f];
    }
    if (p < n) {
        if (!emit_gap(p, n - p)) return -1;
    }
    return nt;
}

// Factor-stream decode with SLE-coded gap literals (modes as in
// tdc_lzss_decode). Returns -2 on malformed input, -1 on overflow.
int64_t tdc_lzss_decode_sle(const uint8_t* payload, int64_t nbits,
                            int64_t start_bit, int64_t n,
                            int64_t flen_min, int w_src, int w_len,
                            int w_dist, const uint8_t* kmers,
                            int64_t n_kmers, int kk,
                            const uint8_t* lits, int64_t n_lits,
                            int mode, uint8_t* out, int64_t out_cap,
                            int64_t* fpos, int64_t* fsrc, int64_t* flen,
                            int64_t fcap, int64_t* nfac_out) {
    if (kk < 1 || kk > 8) return -2;
    BitRd rd{payload, nbits, start_bit};
    int64_t cursor = 0;
    int64_t litc = 0;
    int64_t nfac = 0;
    auto read_gamma = [&]() -> int64_t {
        int zeros = 0;
        while (rd.pos < rd.nbits && rd.read(1) == 0) zeros++;
        return rd.read(zeros);
    };
    uint8_t run[8];
    while (rd.pos < nbits) {
        int64_t flag = rd.read(1);
        if (flag) {
            if (rd.pos >= nbits) break;
            int64_t num = rd.read(w_dist);
            int64_t produced = 0;
            while (produced < num) {
                int64_t take;
                if (rd.read(1)) {
                    int64_t r = read_gamma();
                    if (r >= n_kmers || produced + kk > num) return -2;
                    memcpy(run, kmers + r * kk, size_t(kk));
                    take = kk;
                } else if (rd.read(1)) {
                    int64_t r = read_gamma();
                    if (r >= n_lits) return -2;
                    run[0] = lits[r];
                    take = 1;
                } else {
                    run[0] = uint8_t(rd.read(8));
                    take = 1;
                }
                for (int64_t j = 0; j < take; j++) {
                    if (mode == 0) {
                        if (cursor >= out_cap) return -1;
                        out[cursor++] = run[j];
                    } else {
                        if (litc >= out_cap) return -1;
                        out[litc++] = run[j];
                        cursor++;
                    }
                }
                produced += take;
            }
        }
        if (rd.pos >= nbits) break;
        int64_t src = rd.read(w_src);
        int64_t len = rd.read(w_len) + flen_min;
        if (mode == 0) {
            if (cursor + len > out_cap || src + len > out_cap) return -1;
            if (src < 0 || src >= cursor) return -2;
            for (int64_t i = 0; i < len; i++)
                out[cursor + i] = out[src + i];
            cursor += len;
        } else {
            if (nfac >= fcap) return -1;
            fpos[nfac] = cursor; fsrc[nfac] = src; flen[nfac] = len;
            nfac++;
            cursor += len;
        }
    }
    if (nfac_out) *nfac_out = nfac;
    return (mode == 0) ? cursor : litc;
}

}  // extern "C"

// ---- token packing + SLE rank tables ------------------------------------
// tdc_pack_tokens32: MSB-first bit packing of (value, len<=32) tokens
// (the executable spec is io/bitio.py pack_tokens; output bit-identical).
// Returns the total bit count. The caller sizes `out` >= ceil(sum(lens)/8).

extern "C" {

int64_t tdc_pack_tokens32(const uint32_t* values, const uint8_t* lens,
                          int64_t n, uint8_t* out) {
    uint64_t acc = 0;
    int bits = 0;
    int64_t ob = 0;
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        int w = lens[i];
        uint64_t v = values[i];
        if (w < 32) v &= (uint64_t(1) << w) - 1;
        acc = (acc << w) | v;
        bits += w;
        total += w;
        while (bits >= 8) {
            out[ob++] = uint8_t(acc >> (bits - 8));
            bits -= 8;
        }
        acc &= (uint64_t(1) << bits) - 1;
    }
    if (bits > 0) out[ob++] = uint8_t(acc << (8 - bits));
    return total;
}

// SLE rank tables (coders/sle.py _rank_tables): top-255 k-gram keys with
// count > 1 ordered by (-count, key), and all present literals ordered by
// (-count, byte). kk <= 4. Returns the k-mer count; *n_lits_out gets the
// literal count.
int64_t tdc_sle_rank(const uint8_t* chars, int64_t n, int kk,
                     int64_t* kmer_keys_out, int64_t max_kmers,
                     uint8_t* lits_out, int64_t max_lits,
                     int64_t* n_lits_out) {
    // literal counts
    int64_t lit_cnt[256] = {0};
    for (int64_t i = 0; i < n; i++) lit_cnt[chars[i]]++;
    struct LC { int64_t cnt; int b; };
    std::vector<LC> lcs;
    for (int b = 0; b < 256; b++)
        if (lit_cnt[b]) lcs.push_back({lit_cnt[b], b});
    std::sort(lcs.begin(), lcs.end(), [](const LC& a, const LC& b) {
        return a.cnt != b.cnt ? a.cnt > b.cnt : a.b < b.b;
    });
    int64_t nl = std::min<int64_t>(int64_t(lcs.size()), max_lits);
    for (int64_t i = 0; i < nl; i++) lits_out[i] = uint8_t(lcs[i].b);
    *n_lits_out = nl;
    // k-gram counts via sort of packed keys
    int64_t nk = 0;
    if (n >= kk && kk >= 1 && kk <= 4) {
        std::vector<uint32_t> keys(size_t(n - kk + 1));
        uint32_t key = 0;
        for (int j = 0; j < kk; j++) key = (key << 8) | chars[j];
        uint32_t mask = kk < 4 ? ((uint32_t(1) << (8 * kk)) - 1)
                               : 0xFFFFFFFFu;
        keys[0] = key;
        for (int64_t i = kk; i < n; i++) {
            key = ((key << 8) | chars[i]) & mask;
            keys[size_t(i - kk + 1)] = key;
        }
        std::sort(keys.begin(), keys.end());
        struct KC { int64_t cnt; uint32_t key; };
        std::vector<KC> kcs;
        for (size_t i = 0; i < keys.size();) {
            size_t j = i;
            while (j < keys.size() && keys[j] == keys[i]) j++;
            if (j - i > 1) kcs.push_back({int64_t(j - i), keys[i]});
            i = j;
        }
        std::sort(kcs.begin(), kcs.end(), [](const KC& a, const KC& b) {
            return a.cnt != b.cnt ? a.cnt > b.cnt : a.key < b.key;
        });
        nk = std::min<int64_t>(int64_t(kcs.size()), max_kmers);
        for (int64_t i = 0; i < nk; i++)
            kmer_keys_out[i] = int64_t(kcs[i].key);
    }
    return nk;
}

}  // extern "C"

// ---- LZ78U parse + decode ------------------------------------------------
// Suffix-tree LZ78U factorization (compressors/lz78u.py compress walk,
// reference compressors/LZ78UCompressor.hpp): one factor per freshly
// visited suffix-tree node, labels >= threshold sub-factorized against
// already-assigned node factors with 0-escaped cut records. Emits the
// coder-agnostic event stream:
//   kind 0 = ref      (value = r,   aux = factor_count | -1 for len_r)
//   kind 1 = sep bit  (value = 0/1)
//   kind 2 = char     (value = byte)

extern "C" {

}  // extern "C"

template <typename I>
static int64_t lz78u_parse_impl(const I* parent, const I* sdepth,
                                const uint8_t* is_leaf,
                                const I* leaf_of_rank, const I* isa,
                                const uint8_t* text, int64_t n,
                                int64_t m, int64_t threshold,
                                uint8_t* kind, I* value, I* aux,
                                int64_t cap) {
    std::vector<I> R(size_t(m), 0);
    std::vector<int64_t> path;
    int64_t ne = 0;       // event count
    int64_t fc = 0;       // factor count
    auto emit = [&](uint8_t k, int64_t v, int64_t a) -> bool {
        if (ne >= cap) return false;
        kind[ne] = k; value[ne] = I(v); aux[ne] = I(a); ne++;
        return true;
    };
    auto build_path = [&](int64_t leaf) {
        path.clear();
        for (int64_t v = leaf; v != -1; v = parent[v]) path.push_back(v);
        std::reverse(path.begin(), path.end());
    };
    // output(begin, end, ref): one factor record
    auto output = [&](int64_t begin, int64_t end, int64_t ref) -> bool {
        while (end > begin && text[end - 1] == 0) end--;
        if (!emit(0, ref, fc)) return false;
        if (end - begin >= threshold) {
            if (!emit(1, 0, 0)) return false;
            int64_t pos = begin;
            while (pos < end) {
                build_path(leaf_of_rank[isa[pos]]);
                size_t d = 1;
                int64_t par2 = 0;
                int64_t node = path[d];
                while (!is_leaf[node] && R[size_t(node)] != 0) {
                    par2 = node;
                    d++;
                    node = path[d];
                }
                int64_t depth = sdepth[par2];
                if (depth < threshold) {
                    if (!emit(1, 0, 0)) return false;
                    if (!emit(2, text[pos], 0)) return false;
                    pos += 1;
                } else {
                    if (!emit(1, 1, 0)) return false;
                    if (!emit(0, R[size_t(par2)], fc)) return false;
                    pos += depth;
                    if (pos > end) {
                        if (!emit(1, 1, 0)) return false;
                        if (!emit(0, 0, fc)) return false;
                        if (!emit(0, pos - end, -1)) return false;
                    }
                }
            }
            if (!emit(1, 0, 0)) return false;
            if (!emit(2, 0, 0)) return false;
        } else {
            if (!emit(1, 1, 0)) return false;
            for (int64_t i = begin; i < end; i++)
                if (!emit(2, text[i], 0)) return false;
            if (!emit(2, 0, 0)) return false;
        }
        fc++;
        return true;
    };
    int64_t pos = 0;
    while (pos < n - 1) {
        build_path(leaf_of_rank[isa[pos]]);
        int64_t par = path[path.size() - 2];
        if (par == 0 || R[size_t(par)] != 0) {
            int64_t psd = sdepth[par];
            if (!output(pos + psd, pos + psd + 1, R[size_t(par)]))
                return -1;
            pos += psd + 1;
            continue;
        }
        size_t d = 1;
        int64_t par2 = 0;
        int64_t node = path[d];
        while (R[size_t(node)] != 0) {
            par2 = node;
            d++;
            node = path[d];
        }
        int64_t begin = pos + sdepth[par2];
        int64_t end = pos + sdepth[node];
        if (!output(begin, end, R[size_t(par2)])) return -1;
        R[size_t(node)] = I(fc);  // output() already incremented
        pos = end;
    }
    return ne;
}

extern "C" {

int64_t tdc_lz78u_parse(const int64_t* parent, const int64_t* sdepth,
                        const uint8_t* is_leaf,
                        const int64_t* leaf_of_rank, const int64_t* isa,
                        const uint8_t* text, int64_t n, int64_t m,
                        int64_t threshold,
                        uint8_t* kind, int64_t* value, int64_t* aux,
                        int64_t cap) {
    return lz78u_parse_impl<int64_t>(
        parent, sdepth, is_leaf, leaf_of_rank, isa, text, n, m,
        threshold, kind, value, aux, cap);
}

int64_t tdc_lz78u_parse32(const int32_t* parent, const int32_t* sdepth,
                          const uint8_t* is_leaf,
                          const int32_t* leaf_of_rank,
                          const int32_t* isa, const uint8_t* text,
                          int64_t n, int64_t m, int64_t threshold,
                          uint8_t* kind, int32_t* value, int32_t* aux,
                          int64_t cap) {
    return lz78u_parse_impl<int32_t>(
        parent, sdepth, is_leaf, leaf_of_rank, isa, text, n, m,
        threshold, kind, value, aux, cap);
}

// LZ78U stream decode (compressors/lz78u.py decompress): binary refs of
// width bits_for(factor_count), raw separator bits, chars via the
// canonical-huffman LUT when k > 0 else plain 8-bit. Each factor's full
// expansion is a contiguous segment of `out`, so expand() is a segment
// copy. Returns output length (incl. restored sentinel), -1 on overflow,
// -2 on malformed input.
int64_t tdc_lz78u_decode(const uint8_t* payload, int64_t nbits,
                         int64_t start_bit, const uint8_t* lut_sym,
                         const uint8_t* lut_len, int k,
                         int ref_kind, int str_kind,
                         uint8_t* out, int64_t out_cap) {
    BitRd rd{payload, nbits, start_bit};
    auto bits_for = [](int64_t v) -> int {
        int b = 1;
        while ((uint64_t(v) >> b) != 0) b++;
        return b;
    };
    auto read_ref = [&](int64_t fc, int w) -> int64_t {
        // ref coder fields: Range(fc) fixed width for kind 0,
        // the coder's VLC otherwise (values stored verbatim)
        if (ref_kind == 0) return rd.read(w);
        return rd.read_code(ref_kind, w);
    };
    auto read_literal = [&]() -> int {
        if (str_kind == 1 || str_kind == 2 || str_kind == 3) {
            int64_t v = rd.read_code(str_kind, 8);
            if (v < 0 || v > 255) return -1;
            return int(v);
        }
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) return -1;
            rd.pos = save + len;
            return lut_sym[w];
        }
        return int(rd.read(8));
    };
    std::vector<int64_t> exp_off, exp_len;
    std::vector<uint8_t> rebuilt;
    int64_t fc = 0;
    int64_t o = 0;
    while (rd.pos < nbits) {
        int64_t ref = read_ref(fc, bits_for(fc));
        if (rd.pos >= nbits) break;
        if (ref < 0 || ref > fc) return -2;
        int64_t not_factorized = rd.read(1);
        rebuilt.clear();
        if (not_factorized) {
            while (true) {
                int c = read_literal();
                if (c < 0) return -2;
                if (c == 0) break;
                rebuilt.push_back(uint8_t(c));
                if (int64_t(rebuilt.size()) > out_cap) return -1;
                if (rd.pos >= nbits) return -2;
            }
        } else {
            while (true) {
                int64_t is_sub_char = !rd.read(1);
                if (is_sub_char) {
                    int c = read_literal();
                    if (c < 0) return -2;
                    rebuilt.push_back(uint8_t(c));
                } else {
                    int64_t sub = read_ref(fc, bits_for(fc));
                    if (sub < 0 || sub > fc) return -2;
                    if (sub == 0) {
                        int64_t cut = read_ref(fc, 32);
                        if (cut < 0 || cut > int64_t(rebuilt.size()))
                            return -2;
                        rebuilt.resize(rebuilt.size() - size_t(cut));
                    } else {
                        int64_t so = exp_off[size_t(sub - 1)];
                        int64_t sl = exp_len[size_t(sub - 1)];
                        rebuilt.insert(rebuilt.end(), out + so,
                                       out + so + sl);
                    }
                }
                if (int64_t(rebuilt.size()) > out_cap) return -1;
                if (!rebuilt.empty() && rebuilt.back() == 0) {
                    rebuilt.pop_back();
                    break;
                }
                // truncated stream: past-EOF reads return zeros which
                // can decode to a nonzero symbol forever; -1 here
                // would make the caller's grow-and-retry loop spin
                if (rd.pos >= nbits) return -2;
            }
        }
        int64_t start = o;
        if (ref != 0) {
            int64_t ro = exp_off[size_t(ref - 1)];
            int64_t rl = exp_len[size_t(ref - 1)];
            if (o + rl > out_cap) return -1;
            memcpy(out + o, out + ro, size_t(rl));
            o += rl;
        }
        if (o + int64_t(rebuilt.size()) > out_cap) return -1;
        memcpy(out + o, rebuilt.data(), rebuilt.size());
        o += int64_t(rebuilt.size());
        exp_off.push_back(start);
        exp_len.push_back(o - start);
        fc++;
    }
    if (o >= out_cap) return -1;
    out[o++] = 0;  // restore the sentinel
    return o;
}

}  // extern "C"

// ---- LZ78 parse over alternative trie structures -------------------------
// Structure-faithful native variants of the LZ78/LZW dictionary parse
// (compressors/lz78_trie.py): kind 0 = ternary search trie
// (lz78/TernaryTrie.hpp), kind 1 = first-child/next-sibling child-list
// trie (lz78/BinaryTrie.hpp), kind 2 = double-array base/check trie
// with first-fit base relocation (lz78/CedarTrie.hpp's structure,
// mirroring compressors/lz78_trie.py CedarTrie). Same canonical parse
// as tdc_lz78_parse; only the lookup structure differs (tests pin
// equality).

extern "C" {

int64_t tdc_lz78_parse_struct(const uint8_t* in, int64_t n, int lzw,
                              int64_t dict_limit, int kind,
                              uint32_t* out_refs, uint8_t* out_chars,
                              int64_t out_cap) {
    // Node storage. LZ78: ids 0..next_id (0 = root); LZW: 0..255 roots.
    // Ternary: per-node child BST over (char, lo, hi, child_id).
    // Binary: per-node first_child + per-node next_sibling/in_char.
    struct BstNode { uint8_t ch; int32_t lo, hi; uint32_t id; };
    std::vector<int32_t> bst_root;       // trie node -> BST root
    std::vector<BstNode> bst;            // ternary arena
    std::vector<int32_t> first_child;    // binary layout
    std::vector<int32_t> next_sibling;
    std::vector<uint8_t> in_char;
    int64_t roots = lzw ? 256 : 1;
    // kind 2: double-array. Slots hold (base, check, trie id); check
    // -1 = free, -2 = root. Roots live at slots 0..roots-1. Child
    // lookup is check[base[slot]+c] == slot; collisions relocate the
    // parent's child block to a fresh first-fit base (monotone hint).
    std::vector<int32_t> da_base, da_check, da_id;
    std::vector<int32_t> da_slot_of;              // trie id -> slot
    std::vector<std::vector<uint8_t>> da_kids;    // slot -> child chars
    int64_t da_hint = 1;
    auto da_grow = [&](int64_t need) {
        int64_t cap = int64_t(da_base.size());
        if (need < cap) return;
        while (cap <= need) cap *= 2;
        da_base.resize(size_t(cap), 0);
        da_check.resize(size_t(cap), -1);
        da_id.resize(size_t(cap), -1);
        da_kids.resize(size_t(cap));
    };
    auto da_find_base = [&](const std::vector<uint8_t>& kids,
                            int extra_ch) -> int64_t {
        int64_t b = da_hint;
        for (;; b++) {
            bool ok = true;
            for (size_t j = 0; ok && j <= kids.size(); j++) {
                int ch = (j < kids.size()) ? kids[j] : extra_ch;
                int64_t s = b + ch;
                da_grow(s);
                if (da_check[size_t(s)] != -1) ok = false;
            }
            if (ok) { da_hint = b; return b; }
        }
    };
    auto da_relocate = [&](int64_t slot, int extra_ch) {
        std::vector<uint8_t> kids = da_kids[size_t(slot)];
        int64_t old_base = da_base[size_t(slot)];
        int64_t newb = da_find_base(kids, extra_ch);
        for (uint8_t ch : kids) {
            int64_t old_s = old_base + ch;
            int64_t new_s = newb + ch;
            da_grow(new_s);
            da_base[size_t(new_s)] = da_base[size_t(old_s)];
            da_check[size_t(new_s)] = int32_t(slot);
            da_id[size_t(new_s)] = da_id[size_t(old_s)];
            da_slot_of[size_t(da_id[size_t(old_s)])] = int32_t(new_s);
            da_kids[size_t(new_s)] = std::move(da_kids[size_t(old_s)]);
            int64_t gb = da_base[size_t(old_s)];
            for (uint8_t gch : da_kids[size_t(new_s)])
                da_check[size_t(gb + gch)] = int32_t(new_s);
            da_check[size_t(old_s)] = -1;
            da_id[size_t(old_s)] = -1;
            da_kids[size_t(old_s)].clear();
        }
        da_base[size_t(slot)] = int32_t(newb);
    };
    auto reset = [&]() {
        if (kind == 0) {
            bst_root.assign(size_t(roots), -1);
            bst.clear();
        } else if (kind == 2) {
            da_base.assign(512, 0);
            da_check.assign(512, -1);
            da_id.assign(512, -1);
            da_kids.assign(512, {});
            da_slot_of.clear();
            da_hint = 1;
            for (int64_t r = 0; r < roots; r++) {
                da_check[size_t(r)] = -2;
                da_id[size_t(r)] = int32_t(r);
                da_slot_of.push_back(int32_t(r));
            }
        } else {
            first_child.assign(size_t(roots), -1);
            next_sibling.assign(size_t(roots), -1);
            in_char.assign(size_t(roots), 0);
        }
    };
    reset();
    auto add_node = [&]() {
        if (kind == 0) {
            bst_root.push_back(-1);
        } else {
            first_child.push_back(-1);
            next_sibling.push_back(-1);
            in_char.push_back(0);
        }
    };
    // find (node, c); if absent insert mapping to `fresh` and return -1
    auto find_or_insert = [&](uint32_t node, uint8_t c,
                              uint32_t fresh) -> int64_t {
        if (kind == 2) {
            int64_t slot = da_slot_of[node];
            int64_t s = int64_t(da_base[size_t(slot)]) + c;
            da_grow(s);
            if (da_check[size_t(s)] == slot && da_id[size_t(s)] != -1)
                return da_id[size_t(s)];
            if (da_check[size_t(s)] != -1) {
                da_relocate(slot, c);
                slot = da_slot_of[node];
                s = int64_t(da_base[size_t(slot)]) + c;
            }
            da_base[size_t(s)] = 1;  // leaf: any base works
            da_check[size_t(s)] = int32_t(slot);
            da_id[size_t(s)] = int32_t(fresh);
            da_slot_of.push_back(int32_t(s));
            da_kids[size_t(slot)].push_back(c);
            return -1;
        }
        if (kind == 0) {
            int32_t b = bst_root[node];
            int32_t prev = -1;
            bool hi = false;
            while (b != -1) {
                if (bst[size_t(b)].ch == c) return bst[size_t(b)].id;
                prev = b;
                hi = c > bst[size_t(b)].ch;
                b = hi ? bst[size_t(b)].hi : bst[size_t(b)].lo;
            }
            int32_t nb = int32_t(bst.size());
            bst.push_back({c, -1, -1, fresh});
            if (prev == -1) bst_root[node] = nb;
            else if (hi) bst[size_t(prev)].hi = nb;
            else bst[size_t(prev)].lo = nb;
            add_node();
            return -1;
        }
        int32_t ch = first_child[node];
        int32_t prev = -1;
        while (ch != -1) {
            if (in_char[size_t(ch)] == c) return ch;
            prev = ch;
            ch = next_sibling[size_t(ch)];
        }
        // binary trie ids ARE node slots: ids are assigned in slot
        // order by both parse loops, so the fresh slot equals `fresh`
        add_node();
        int32_t slot = int32_t(first_child.size()) - 1;
        (void)fresh;
        in_char[size_t(slot)] = c;
        if (prev == -1) first_child[node] = slot;
        else next_sibling[size_t(prev)] = slot;
        return -1;
    };
    int64_t count = 0;
    uint32_t next_id = 1;
    uint32_t lzw_next = 256;
    uint32_t node = 0;
    uint32_t parent = 0;
    uint8_t last_c = 0;
    int lzw_active = 0;
    uint32_t lzw_node = 0;
    // binary layout maps trie ids to storage slots 1:1 only when ids
    // are assigned in slot order, which both loops below guarantee.
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        last_c = c;
        if (!lzw) {
            int64_t child = find_or_insert(node, c, next_id);
            if (child < 0) {
                if (count >= out_cap) return -1;
                out_refs[count] = node;
                out_chars[count] = c;
                count++;
                next_id++;
                parent = node = 0;
                if (dict_limit && next_id > uint32_t(dict_limit)) {
                    reset();
                    next_id = 1;
                }
            } else {
                parent = node;
                node = uint32_t(child);
            }
        } else {
            if (!lzw_active) { lzw_node = c; lzw_active = 1; continue; }
            int64_t child = find_or_insert(lzw_node, c, lzw_next);
            if (child < 0) {
                if (count >= out_cap) return -1;
                out_refs[count++] = lzw_node;
                lzw_next++;
                lzw_node = c;
                if (dict_limit
                    && lzw_next > uint32_t(dict_limit) + 256) {
                    reset();
                    lzw_next = 256;
                }
            } else {
                lzw_node = uint32_t(child);
            }
        }
    }
    if (!lzw) {
        if (node != 0) {
            if (count >= out_cap) return -1;
            out_refs[count] = parent;
            out_chars[count] = last_c;
            count++;
        }
    } else if (lzw_active) {
        if (count >= out_cap) return -1;
        out_refs[count++] = lzw_node;
    }
    return count;
}

}  // extern "C"

// ---- Re-Pair stream decode -----------------------------------------------
// Mirrors compressors/repair.py decompress: 32-bit rule count, then per
// rule i two symbols (flag bit + literal | (id - 256) in bits_for(i)
// bits), then start symbols in bits_for(num_rules) bits; grammar
// expansion by explicit stack. Literals via canonical-huffman LUT when
// k > 0 else plain 8-bit. Returns output length, -1 overflow, -2
// malformed.

extern "C" {

int64_t tdc_repair_decode(const uint8_t* payload, int64_t nbits,
                          int64_t start_bit, const uint8_t* lut_sym,
                          const uint8_t* lut_len, int k, int code_kind,
                          uint8_t* out, int64_t out_cap) {
    BitRd rd{payload, nbits, start_bit};
    auto bits_for = [](int64_t v) -> int {
        int b = 1;
        while ((uint64_t(v) >> b) != 0) b++;
        return b;
    };
    auto read_int = [&](int w) -> int64_t {
        if (code_kind == 0) return rd.read(w);
        return rd.read_code(code_kind, w);
    };
    auto read_literal = [&]() -> int {
        if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
            int64_t v = rd.read_code(code_kind, 8);
            if (v < 0 || v > 255) return -1;
            return int(v);
        }
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) return -1;
            rd.pos = save + len;
            return lut_sym[w];
        }
        return int(rd.read(8));
    };
    int64_t nr = read_int(32);
    // every rule body costs >= 2 stream bits, so a valid nr is bounded
    // by the remaining bits; a looser check would let a malformed
    // count allocate 16*nr bytes (bad_alloc would escape the C ABI)
    if (nr < 0 || 2 * nr > nbits - rd.pos) return -2;
    std::vector<int64_t> L(static_cast<size_t>(nr));
    std::vector<int64_t> R(static_cast<size_t>(nr));
    for (int64_t i = 0; i < nr; i++) {
        int w = bits_for(i);
        for (int side = 0; side < 2; side++) {
            int64_t x;
            int64_t fl = rd.read_flag(code_kind);
            if (fl < 0) return -2;
            if (fl) {
                x = 256 + read_int(w);
                if (x - 256 >= i) return -2;  // forward rule reference
            } else {
                int c = read_literal();
                if (c < 0) return -2;
                x = c;
            }
            (side ? R : L)[size_t(i)] = x;
        }
    }
    int w = bits_for(nr);
    int64_t o = 0;
    std::vector<int64_t> stack;
    while (rd.pos < nbits) {
        int64_t x;
        int64_t fl = rd.read_flag(code_kind);
        if (fl < 0) return -2;
        if (fl) {
            x = 256 + read_int(w);
            if (x - 256 >= nr) return -2;
        } else {
            int c = read_literal();
            if (c < 0) return -2;
            x = c;
        }
        stack.clear();
        stack.push_back(x);
        while (!stack.empty()) {
            int64_t s = stack.back();
            stack.pop_back();
            if (s < 256) {
                if (o >= out_cap) return -1;
                out[o++] = uint8_t(s);
            } else {
                stack.push_back(R[size_t(s - 256)]);
                stack.push_back(L[size_t(s - 256)]);
            }
        }
    }
    return o;
}

}  // extern "C"

// ---- SA-IS linear-time suffix array ---------------------------------------
// From-scratch implementation of the induced-sorting algorithm (Nong,
// Zhang & Chan, "Two Efficient Algorithms for Linear Time Suffix Array
// Construction", 2009). Replaces the O(n log n) radix prefix-doubling
// construction as the default tdc_suffix_array backend (same output:
// the suffix array of a byte string is unique). The divsufsort port the
// reference vendors (util/divsufsort/) fills the same role there.

namespace tdc_sais {

static inline bool is_lms(const uint8_t* t, int64_t i) {
    return i > 0 && t[i] && !t[i - 1];
}

// s: values in [0, K); s[n-1] is the unique smallest symbol (sentinel).
// Templated on the index width I: the int32 instantiation (n < 2^31)
// halves both the output and the recursion workspace.
template <typename I>
static void sais(const I* s, I* sa, I n, I K, std::vector<I>& work) {
    std::vector<uint8_t> t(static_cast<size_t>(n), uint8_t(0));
    t[size_t(n - 1)] = 1;
    for (I i = n - 2; i >= 0; i--)
        t[size_t(i)] = s[i] < s[i + 1]
            || (s[i] == s[i + 1] && t[size_t(i + 1)]);
    std::vector<I> bkt(size_t(K) + 1);
    auto buckets = [&](bool ends) {
        std::fill(bkt.begin(), bkt.end(), I(0));
        for (I i = 0; i < n; i++) bkt[size_t(s[i]) + 1]++;
        for (size_t i = 1; i < bkt.size(); i++) bkt[i] += bkt[i - 1];
        if (!ends) return;           // bkt[c] = start of bucket c
        // ends: bkt[c] = one past end of bucket c (shift left by one)
        for (size_t i = 0; i + 1 < bkt.size(); i++) bkt[i] = bkt[i + 1];
    };
    auto induce = [&]() {
        // L-type left-to-right from bucket starts
        buckets(false);
        std::vector<I> head(bkt.begin(), bkt.end());
        for (I i = 0; i < n; i++) {
            I j = sa[i] - 1;
            if (sa[i] > 0 && !t[size_t(j)])
                sa[head[size_t(s[j])]++] = j;
        }
        // S-type right-to-left from bucket ends
        buckets(true);
        std::vector<I> tail(bkt.begin(), bkt.end());
        for (I i = n - 1; i >= 0; i--) {
            I j = sa[i] - 1;
            if (sa[i] > 0 && t[size_t(j)])
                sa[--tail[size_t(s[j])]] = j;
        }
    };
    // 1) place LMS suffixes at bucket ends (arbitrary order), induce
    std::fill(sa, sa + n, I(-1));
    buckets(true);
    {
        std::vector<I> tail(bkt.begin(), bkt.end());
        for (I i = 1; i < n; i++)
            if (is_lms(t.data(), i)) sa[--tail[size_t(s[i])]] = i;
    }
    induce();
    // 2) extract sorted LMS substrings, assign names
    I n1 = 0;
    for (I i = 0; i < n; i++)
        if (is_lms(t.data(), sa[i])) sa[n1++] = sa[i];
    std::fill(sa + n1, sa + n, I(-1));
    I name = 0, prev = -1;
    for (I i = 0; i < n1; i++) {
        I pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (I d = 0;; d++) {
                if (pos + d >= n || prev + d >= n
                    || s[pos + d] != s[prev + d]
                    || t[size_t(pos + d)] != t[size_t(prev + d)]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(t.data(), pos + d)
                              || is_lms(t.data(), prev + d))) {
                    diff = !(is_lms(t.data(), pos + d)
                             && is_lms(t.data(), prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        sa[n1 + pos / 2] = name - 1;
    }
    // compact names into s1 (order of appearance in the text)
    I* s1 = sa + n - n1;
    for (I i = n - 1, j = n - 1; i >= n1; i--)
        if (sa[i] >= 0) sa[j--] = sa[i];
    // 3) sort the LMS order: recurse if names repeat
    if (name < n1) {
        sais<I>(s1, sa, n1, name, work);
    } else {
        for (I i = 0; i < n1; i++) sa[s1[i]] = i;
    }
    // map s1 indices back to text positions
    {
        std::vector<I>& lms = work;
        lms.clear();
        lms.reserve(size_t(n1));
        for (I i = 1; i < n; i++)
            if (is_lms(t.data(), i)) lms.push_back(i);
        for (I i = 0; i < n1; i++) sa[i] = lms[size_t(sa[i])];
    }
    // 4) final induce from the sorted LMS suffixes
    std::fill(sa + n1, sa + n, I(-1));
    buckets(true);
    {
        std::vector<I> tail(bkt.begin(), bkt.end());
        for (I i = n1 - 1; i >= 0; i--) {
            I j = sa[i];
            sa[i] = -1;
            sa[--tail[size_t(s[j])]] = j;
        }
    }
    induce();
}

}  // namespace tdc_sais

extern "C" {

void tdc_suffix_array_sais(const uint8_t* text, int64_t n, int64_t* sa) {
    if (n <= 0) return;
    if (n == 1) { sa[0] = 0; return; }
    // sentinel formulation: s = text+1 with a trailing unique 0
    std::vector<int64_t> s(size_t(n) + 1);
    for (int64_t i = 0; i < n; i++) s[size_t(i)] = int64_t(text[i]) + 1;
    s[size_t(n)] = 0;
    std::vector<int64_t> sa1(size_t(n) + 1);
    std::vector<int64_t> work;
    tdc_sais::sais<int64_t>(s.data(), sa1.data(), n + 1, 257, work);
    // drop the sentinel suffix (always first)
    for (int64_t i = 0; i < n; i++) sa[i] = sa1[size_t(i) + 1];
}

void tdc_suffix_array_sais32(const uint8_t* text, int64_t n,
                             int32_t* sa) {
    if (n <= 0) return;
    if (n == 1) { sa[0] = 0; return; }
    std::vector<int32_t> s(size_t(n) + 1);
    for (int64_t i = 0; i < n; i++) s[size_t(i)] = int32_t(text[i]) + 1;
    s[size_t(n)] = 0;
    std::vector<int32_t> sa1(size_t(n) + 1);
    std::vector<int32_t> work;
    tdc_sais::sais<int32_t>(s.data(), sa1.data(), int32_t(n + 1), 257,
                            work);
    for (int64_t i = 0; i < n; i++) sa[i] = sa1[size_t(i) + 1];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Arithmetic (integer range) coder fast paths — exact mirrors of
// tudocomp_tpu/coders/arithmetic.py (flush-and-restart 64-bit blocks;
// reference semantics coders/ArithmeticCoder.hpp:72-144). The literal-only
// stream layout (everything after the codebook header) is a plain sequence
// of 64-bit MSB-first code words, one per block, then final lower + ~0.
// ---------------------------------------------------------------------------

extern "C" {

static inline uint64_t tdc_arith_offset(uint64_t range, uint64_t cum,
                                        uint64_t total) {
    if (range <= total)
        return (uint64_t)((unsigned __int128)range * cum / total);
    return range / total * cum;
}

// data[n] -> out_codes (64-bit block codes incl. the final lower + ~0
// terminator). cum[256] = normalized cumulative counts. Returns the
// number of code words, or -1 if cap is too small.
int64_t tdc_arith_encode(const uint8_t* data, int64_t n,
                         const uint64_t* cum, uint64_t total,
                         uint64_t* out_codes, int64_t cap) {
    const uint64_t UMAX = ~0ull;
    if (n <= 0 || total == 0) return 0;
    uint64_t lower = 0, upper = UMAX;
    const uint64_t min_range = total;
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        unsigned v = data[i];
        uint64_t rng = upper - lower;
        if (rng < min_range) {
            if (m >= cap) return -1;
            out_codes[m++] = lower;
            lower = 0;
            upper = UMAX;
            rng = UMAX;
        }
        upper = lower + tdc_arith_offset(rng, cum[v], total);
        if (v != 0) lower = lower + tdc_arith_offset(rng, cum[v - 1], total);
    }
    if (m + 2 > cap) return -1;
    out_codes[m++] = lower;
    out_codes[m++] = UMAX;
    return m;
}

// Decode `count` literals from the MSB-first bit stream starting at
// start_bit. syms/cums are the codebook's sigma (symbol, cumulative)
// pairs in symbol order. Returns 0, or -2 on a malformed stream.
int64_t tdc_arith_decode(const uint8_t* payload, int64_t nbits,
                         int64_t start_bit, const uint8_t* syms,
                         const uint64_t* cums, int64_t sigma,
                         uint64_t total, int64_t count, uint8_t* out) {
    const uint64_t UMAX = ~0ull;
    if (count <= 0) return 0;
    if (total == 0 || sigma <= 0) return -2;
    const uint64_t min_range = total;
    int64_t counter = 0;
    int64_t pos = start_bit;
    while (counter < count) {
        if (pos + 64 > nbits) return -2;
        uint64_t code = 0;
        for (int b = 0; b < 64; b++) {
            code = (code << 1) |
                   (uint64_t)((payload[(pos + b) >> 3] >>
                               (7 - ((pos + b) & 7))) & 1);
        }
        pos += 64;
        if (code == UMAX) return -2;  // premature terminator
        uint64_t lower = 0, upper = UMAX;
        uint64_t rng = UMAX;
        while (min_range <= rng && counter < count) {
            uint64_t interval_lower = lower;
            int matched = 0;
            for (int64_t j = 0; j < sigma; j++) {
                upper = lower + tdc_arith_offset(rng, cums[j], total);
                if (code < upper) {
                    out[counter] = syms[j];
                    lower = interval_lower;
                    matched = 1;
                    break;
                }
                interval_lower = upper;
            }
            if (!matched) return -2;  // code outside every interval
            counter++;
            rng = upper - lower;
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-stream literal decode for the universal VLC coders — mirrors the
// BitReader walks in tudocomp_tpu/io/bitio.py (read_elias_gamma/_delta/
// read_ternary) for LiteralEncoder's decode-until-eof tail.
// kind: 1 = gamma, 2 = delta, 3 = ternary. Returns the literal count,
// -1 if cap is too small, -2 on a malformed / misaligned stream.
// ---------------------------------------------------------------------------

extern "C" {

static inline int tdc_vlc_bit(const uint8_t* p, int64_t pos) {
    return (p[pos >> 3] >> (7 - (pos & 7))) & 1;
}

int64_t tdc_vlc_literals(const uint8_t* p, int64_t nbits, int64_t pos,
                         int kind, uint8_t* out, int64_t cap) {
    int64_t m = 0;
    while (pos < nbits) {
        uint64_t v = 0;
        if (kind == 1 || kind == 2) {
            // unary: zeros then a 1 (read_unary), giving the bit count
            int64_t zeros = 0;
            while (pos < nbits && !tdc_vlc_bit(p, pos)) { zeros++; pos++; }
            if (pos >= nbits) return -2;  // unary ran past the end
            pos++;                        // the terminating 1
            int64_t width = zeros;
            if (kind == 2) {              // delta: gamma gives the width
                if (pos + width > nbits) return -2;
                uint64_t g = 0;
                for (int64_t b = 0; b < width; b++)
                    g = (g << 1) | (uint64_t)tdc_vlc_bit(p, pos + b);
                pos += width;
                width = (int64_t)g;
            }
            if (width > 63 || pos + width > nbits) return -2;
            for (int64_t b = 0; b < width; b++)
                v = (v << 1) | (uint64_t)tdc_vlc_bit(p, pos + b);
            pos += width;
        } else if (kind == 3) {
            // base-3 digits in 2-bit codes, terminator 0b11 (read_ternary)
            if (pos + 2 > nbits) return -2;
            unsigned mod = (unsigned)((tdc_vlc_bit(p, pos) << 1) |
                                      tdc_vlc_bit(p, pos + 1));
            pos += 2;
            if (mod < 3) {
                uint64_t b3 = 1;
                for (;;) {
                    v += mod * b3;
                    b3 *= 3;
                    if (pos + 2 > nbits) return -2;
                    mod = (unsigned)((tdc_vlc_bit(p, pos) << 1) |
                                     tdc_vlc_bit(p, pos + 1));
                    pos += 2;
                    if (mod == 3) break;
                }
                v += 1;
            }
        } else {
            return -2;
        }
        if (v > 255) return -2;  // not a literal stream
        if (m >= cap) return -1;
        out[m++] = (uint8_t)v;
    }
    return m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sliding-window LZSS (reference LZSSSlidingWindowCompressor.hpp:39-143):
// greedy longest-match scan over [i-w, i), lookahead bounded by the
// streaming buffer end min(n, max(2w, i+w)), ties to the leftmost
// candidate; stream = per event either (flag=1, pos-src in Range(pos),
// len in Range(window)) or (flag=0, literal). code_kind as in BitRd.
// ---------------------------------------------------------------------------

extern "C" {

struct TdcBitWr {
    uint8_t* p;
    int64_t cap_bits;
    int64_t pos;
    inline int put(uint64_t v, int64_t w) {
        if (pos + w > cap_bits) return -1;
        for (int64_t i = w - 1; i >= 0; i--) {
            uint64_t b = (v >> i) & 1;
            int64_t q = pos >> 3;
            int r = int(7 - (pos & 7));
            p[q] = (uint8_t)((p[q] & ~(1u << r)) | (unsigned(b) << r));
            pos++;
        }
        return 0;
    }
    inline int put_gamma(uint64_t v) {
        int64_t nb = v ? 64 - __builtin_clzll(v) : 1;
        if (put(1, nb + 1)) return -1;  // unary(nb): nb zeros then 1
        return put(v, nb);
    }
    inline int put_delta(uint64_t v) {
        int64_t nb = v ? 64 - __builtin_clzll(v) : 1;
        if (put_gamma((uint64_t)nb)) return -1;
        return put(v, nb);
    }
    inline int put_ternary(uint64_t v) {
        if (v) {
            v -= 1;
            for (;;) {
                if (put(v % 3, 2)) return -1;
                v /= 3;
                if (!v) break;
            }
        }
        return put(3, 2);
    }
    inline int put_ascii_int(uint64_t v) {
        char buf[24];
        int m = 0;
        do { buf[m++] = char('0' + v % 10); v /= 10; } while (v);
        for (int i = m - 1; i >= 0; i--)
            if (put((uint64_t)(unsigned char)buf[i], 8)) return -1;
        return put(':', 8);
    }
    // fixed width w for kind 0, else the VLC family
    inline int put_code(int kind, uint64_t v, int64_t w) {
        switch (kind) {
            case 0: return put(v, w);
            case 1: return put_gamma(v);
            case 2: return put_delta(v);
            case 3: return put_ternary(v);
            default: return put_ascii_int(v);
        }
    }
    inline int put_flag(int kind, int v) {
        if (kind == 4) return put(v ? '1' : '0', 8);
        return put(v, 1);
    }
};

static inline int64_t tdc_bits_for(uint64_t v) {
    return v ? 64 - __builtin_clzll(v) : 1;
}

// Factorize + encode in one pass. Returns the bit count written into
// out (caller packs it into its BitWriter), or -1 if cap_bits is too
// small, or -2 on bad parameters.
int64_t tdc_lzss_window_encode(const uint8_t* t, int64_t n,
                               int64_t window, int64_t threshold,
                               int code_kind, uint8_t* out,
                               int64_t cap_bits) {
    if (window < 1 || threshold < 1) return -2;
    TdcBitWr wr{out, cap_bits, 0};
    const int64_t w_len = tdc_bits_for((uint64_t)window);
    int64_t i = 0;
    while (i < n) {
        // length cap == window (the reference wraps its Range(window)
        // field for longer initial-buffer matches; see lzss.py)
        int64_t buf_end = i + window;
        if (buf_end > n) buf_end = n;
        int64_t best_len = 0, best_src = 0;
        int64_t lo = i - window;
        if (lo < 0) lo = 0;
        for (int64_t k = lo; k < i; k++) {
            int64_t j = 0;
            while (i + j < buf_end && t[k + j] == t[i + j]) j++;
            if (j >= threshold && j > best_len) { best_len = j; best_src = k; }
        }
        if (best_len > 0) {
            if (wr.put_flag(code_kind, 1)) return -1;
            if (wr.put_code(code_kind, (uint64_t)(i - best_src),
                            tdc_bits_for((uint64_t)i))) return -1;
            if (wr.put_code(code_kind, (uint64_t)best_len, w_len))
                return -1;
            i += best_len;
        } else {
            if (wr.put_flag(code_kind, 0)) return -1;
            if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
                if (wr.put_code(code_kind, t[i], 8)) return -1;
            } else {
                if (wr.put(t[i], 8)) return -1;  // bit/ascii: raw byte
            }
            i++;
        }
    }
    return wr.pos;
}

// Mirror decoder. Returns the text length, -1 if out_cap too small,
// -2 on malformed input.
int64_t tdc_lzss_window_decode(const uint8_t* payload, int64_t nbits,
                               int64_t start_bit, int64_t window,
                               int code_kind, uint8_t* out,
                               int64_t out_cap) {
    if (window < 1) return -2;
    BitRd rd{payload, nbits, start_bit};
    const int w_len = int(tdc_bits_for((uint64_t)window));
    int64_t cursor = 0;
    while (rd.pos < nbits) {
        int64_t flag = rd.read_flag(code_kind);
        if (flag < 0) return -2;
        if (flag) {
            int64_t delta = rd.read_code(
                code_kind, int(tdc_bits_for((uint64_t)cursor)));
            int64_t len = rd.read_code(code_kind, w_len);
            if (delta < 0 || len < 0) return -2;
            int64_t src = cursor - delta;
            if (src < 0 || src >= cursor) return -2;
            if (cursor + len > out_cap) return -1;
            for (int64_t k = 0; k < len; k++)
                out[cursor + k] = out[src + k];
            cursor += len;
        } else {
            int64_t c;
            if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
                c = rd.read_code(code_kind, 8);
            } else {
                if (rd.pos + 8 > nbits) return -2;
                c = rd.read(8);
            }
            if (c < 0 || c > 255) return -2;
            if (cursor >= out_cap) return -1;
            out[cursor++] = (uint8_t)c;
        }
    }
    return cursor;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LZ78 / LZW whole-stream decode for any integer code kind (incl. the
// growing Range(count) fixed widths and the dictionary reset), mirrors
// compressors/lz78.py decompress / lzw.py decompress exactly.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lz78_stream_decode(const uint8_t* p, int64_t nbits,
                               int64_t pos0, int code_kind,
                               int64_t dict_max, uint8_t* out,
                               int64_t cap) {
    BitRd rd{p, nbits, pos0};
    std::vector<int64_t> start, len;
    int64_t cursor = 0, fc = 0;
    while (rd.pos < nbits) {
        int64_t ref = rd.read_code(
            code_kind, int(tdc_bits_for((uint64_t)fc)));
        if (ref < 0 || rd.pos >= nbits) return -2;
        int64_t c;
        if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
            c = rd.read_code(code_kind, 8);
        } else {
            if (rd.pos + 8 > nbits) return -2;
            c = rd.read(8);
        }
        if (c < 0 || c > 255) return -2;
        if (ref > fc) return -2;  // must point to an emitted factor
        int64_t plen = ref ? len[size_t(ref - 1)] + 1 : 1;
        if (cursor + plen > cap) return -1;
        if (ref)
            memcpy(out + cursor, out + start[size_t(ref - 1)],
                   size_t(len[size_t(ref - 1)]));
        out[cursor + plen - 1] = (uint8_t)c;
        start.push_back(cursor);
        len.push_back(plen);
        cursor += plen;
        fc++;
        if (dict_max && fc + 1 == dict_max) {
            start.clear();
            len.clear();
            fc = 0;
        }
    }
    return cursor;
}

int64_t tdc_lzw_stream_decode(const uint8_t* p, int64_t nbits,
                              int64_t pos0, int code_kind,
                              int64_t dict_max, uint8_t* out,
                              int64_t cap) {
    BitRd rd{p, nbits, pos0};
    const int64_t NONE = -1;
    std::vector<int32_t> pref;
    std::vector<uint8_t> lastc;
    auto reset = [&] {
        pref.assign(256, int32_t(NONE));
        lastc.resize(256);
        for (int j = 0; j < 256; j++) lastc[size_t(j)] = (uint8_t)j;
    };
    reset();
    int64_t counter = 0, i = NONE, cursor = 0;
    const int64_t reset_after = dict_max - 256;
    std::vector<uint8_t> tmp;
    auto rebuild = [&](int64_t k) {
        tmp.clear();
        while (k != NONE) {
            tmp.push_back(lastc[size_t(k)]);
            k = pref[size_t(k)];
        }
        std::reverse(tmp.begin(), tmp.end());
    };
    for (;;) {
        if (reset_after > 0 && counter == reset_after) {
            reset();
            counter = 0;
            i = NONE;
        }
        if (rd.pos >= nbits) break;
        int64_t k = rd.read_code(
            code_kind, int(tdc_bits_for((uint64_t)(counter + 256))));
        if (k < 0) return -2;
        counter++;
        if (k > (int64_t)pref.size()) return -2;
        if (k == (int64_t)pref.size()) {
            if (i == NONE) return -2;  // self-reference with no prior
            rebuild(i);
            uint8_t f0 = tmp[0];
            pref.push_back((int32_t)i);
            lastc.push_back(f0);
            rebuild(k);
        } else {
            rebuild(k);
            if (i != NONE) {
                pref.push_back((int32_t)i);
                lastc.push_back(tmp[0]);
            }
        }
        if (cursor + (int64_t)tmp.size() > cap) return -1;
        memcpy(out + cursor, tmp.data(), tmp.size());
        cursor += (int64_t)tmp.size();
        i = k;
    }
    return cursor;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS start-string decode (compressors/lfs.py EncodeStrategy.decode):
// interleaved (flag, literal | rule-id) events; literals via the
// canonical-Huffman LUT (k > 0) or plain 8-bit (k == 0), rule ids in
// fixed width w_id; each id expands to its dictionary string.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs_start_decode(const uint8_t* p, int64_t nbits,
                             int64_t pos0, const uint8_t* lut_sym,
                             const uint8_t* lut_len, int k, int w_id,
                             const int64_t* dict_lens, int64_t ndict,
                             uint8_t* out, int64_t cap) {
    BitRd rd{p, nbits, pos0};
    auto read_lit = [&](int* ok) -> int {
        *ok = 1;
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) { *ok = 0; return 0; }
            rd.pos = save + len;
            return lut_sym[w];
        }
        if (rd.pos + 8 > nbits) { *ok = 0; return 0; }
        return int(rd.read(8));
    };
    // phase 1: the rule strings, as one run of literals
    std::vector<uint8_t> blob;
    std::vector<int64_t> off(size_t(ndict) + 1, 0);
    for (int64_t d = 0; d < ndict; d++) {
        for (int64_t j = 0; j < dict_lens[d]; j++) {
            int ok;
            int c = read_lit(&ok);
            if (!ok) return -2;
            blob.push_back((uint8_t)c);
        }
        off[size_t(d) + 1] = (int64_t)blob.size();
    }
    // phase 2: the start string
    int64_t cursor = 0;
    while (rd.pos < nbits) {
        int64_t flag = rd.read(1);
        if (flag) {
            if (rd.pos + w_id > nbits) return -2;
            int64_t id = rd.read(w_id);
            if (id < 0 || id >= ndict) return -2;
            int64_t len = off[size_t(id) + 1] - off[size_t(id)];
            if (cursor + len > cap) return -1;
            memcpy(out + cursor, blob.data() + off[size_t(id)],
                   size_t(len));
            cursor += len;
        } else {
            int ok;
            int c = read_lit(&ok);
            if (!ok) return -2;
            if (cursor >= cap) return -1;
            out[cursor++] = (uint8_t)c;
        }
    }
    return cursor;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS2 decode (compressors/lfs.py LFS2Compressor.decompress): rules are
// decoded backward and may reference higher-id rules; then the start
// stream expands (flag, literal | rule-id) events. Exact mirror incl.
// the size-countdown loop per rule.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs2_decode(const uint8_t* p, int64_t nbits, int64_t pos0,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int k, int w_id, const int64_t* dict_lens,
                        int64_t ndict, uint8_t* out, int64_t cap) {
    BitRd rd{p, nbits, pos0};
    auto read_lit = [&](int* ok) -> int {
        *ok = 1;
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) { *ok = 0; return 0; }
            rd.pos = save + len;
            return lut_sym[w];
        }
        if (rd.pos + 8 > nbits) { *ok = 0; return 0; }
        return int(rd.read(8));
    };
    std::vector<std::vector<uint8_t>> rules;
    rules.resize(size_t(ndict));
    for (int64_t r = ndict - 1; r >= 0; r--) {
        int64_t size_cur = dict_lens[r];
        std::vector<uint8_t>& body = rules[size_t(r)];
        while (size_cur > 0) {
            if (rd.pos >= nbits) return -2;
            int64_t flag = rd.read(1);
            if (flag) {
                if (rd.pos + w_id > nbits) return -2;
                int64_t ref = rd.read(w_id) - 1;
                if (ref < 0 || ref >= ndict) return -2;
                if (ref <= r) return -2;  // refs point to higher ids
                body.insert(body.end(), rules[size_t(ref)].begin(),
                            rules[size_t(ref)].end());
                size_cur -= dict_lens[ref];
            } else {
                int ok;
                int c = read_lit(&ok);
                if (!ok) return -2;
                body.push_back((uint8_t)c);
                size_cur -= 1;
            }
        }
    }
    int64_t cursor = 0;
    while (rd.pos < nbits) {
        int64_t flag = rd.read(1);
        if (flag) {
            if (rd.pos + w_id > nbits) return -2;
            int64_t ref = rd.read(w_id) - 1;
            if (ref < 0 || ref >= ndict) return -2;
            const std::vector<uint8_t>& body = rules[size_t(ref)];
            if (cursor + (int64_t)body.size() > cap) return -1;
            memcpy(out + cursor, body.data(), body.size());
            cursor += (int64_t)body.size();
        } else {
            int ok;
            int c = read_lit(&ok);
            if (!ok) return -2;
            if (cursor >= cap) return -1;
            out[cursor++] = (uint8_t)c;
        }
    }
    return cursor;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// lcpcomp bulldozer strategy (compressors/lcpcomp.py BulldozerStrategy,
// reference compress/BulldozerStrategy.hpp intended behavior): exact
// mirror of the Python interval sweep.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lcpcomp_bulldozer(const int64_t* sa, const int64_t* lcp,
                              int64_t n, int64_t threshold,
                              int64_t* fpos, int64_t* fsrc,
                              int64_t* flen, int64_t fcap) {
    struct Iv { int64_t p, q, l; };
    std::vector<Iv> iv;
    for (int64_t i = 1; i < n; i++) {
        if (lcp[i] >= threshold) {
            iv.push_back({sa[i], sa[i - 1], lcp[i]});
            iv.push_back({sa[i - 1], sa[i], lcp[i]});
        }
    }
    // stable: ties on (p, l) keep candidate order like Python's sort
    std::stable_sort(iv.begin(), iv.end(), [](const Iv& a, const Iv& b) {
        if (a.p != b.p) return a.p < b.p;
        return a.l > b.l;
    });
    std::vector<uint8_t> marked(size_t(n), 0);
    int64_t nf = 0;
    size_t x = 0;
    while (x < iv.size()) {
        int64_t p = iv[x].p, q = iv[x].q, max_l = iv[x].l;
        if (!marked[size_t(q)]) {
            int64_t length = 1;
            while (length < max_l && q + length < n &&
                   !marked[size_t(q + length)])
                length++;
            if (length >= threshold) {
                bool free_run = true;
                for (int64_t j = p; j < p + length; j++) {
                    if (marked[size_t(j)]) { free_run = false; break; }
                }
                if (free_run) {
                    if (nf >= fcap) return -1;
                    fpos[nf] = p; fsrc[nf] = q; flen[nf] = length;
                    nf++;
                    for (int64_t j = p; j < p + length; j++)
                        marked[size_t(j)] = 1;
                    x++;
                    while (x < iv.size() && iv[x].p < p + length) x++;
                    continue;
                }
            }
        }
        x++;
    }
    return nf;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS SimST strategy (compressors/lfs.py SimSTStrategy.compute_rules,
// reference lfs/SimSTStrategy.hpp): depth-binned greedy LRF selection
// with on-demand child-merged begin lists, dead-position pruning and
// the reference's shared monotone min_shorter re-binning accumulator.
// Exact mirror of the Python walk.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs_simst(const int64_t* parent, const int64_t* sdepth,
                      const uint8_t* is_leaf, const int64_t* suffix,
                      int64_t nn, int64_t n, int64_t min_lrf,
                      int64_t* d_start, int64_t* d_len, int64_t d_cap,
                      int64_t* o_pos, int64_t* o_rule, int64_t* o_len,
                      int64_t o_cap, int64_t* nd_out) {
    std::vector<std::vector<int32_t>> children;
    children.resize(size_t(nn));
    for (int64_t v = 1; v < nn; v++)
        children[size_t(parent[v])].push_back(int32_t(v));
    int64_t max_depth = 0;
    for (int64_t v = 0; v < nn; v++)
        if (!is_leaf[v] && v != 0 && sdepth[v] > max_depth)
            max_depth = sdepth[v];
    std::vector<std::vector<int64_t>> bins;
    bins.resize(size_t(max_depth) + 1);
    for (int64_t v = 0; v < nn; v++)
        if (!is_leaf[v] && v != 0)
            bins[size_t(sdepth[v])].push_back(v);
    std::vector<uint8_t> dead(size_t(n), 0);
    std::vector<std::vector<int64_t>> node_begins;
    node_begins.resize(size_t(nn));
    std::vector<uint8_t> has_begins(size_t(nn), 0);

    auto begins = [&](int64_t v) -> std::vector<int64_t>& {
        if (has_begins[size_t(v)]) return node_begins[size_t(v)];
        std::vector<int64_t> stack{v}, order;
        while (!stack.empty()) {
            int64_t u = stack.back();
            stack.pop_back();
            order.push_back(u);
            for (int32_t c : children[size_t(u)])
                if (!is_leaf[c] && !has_begins[size_t(c)])
                    stack.push_back(c);
        }
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            int64_t u = *it;
            if (has_begins[size_t(u)]) continue;
            std::vector<int64_t> merged;
            for (int32_t c : children[size_t(u)]) {
                if (is_leaf[c]) {
                    int64_t p = suffix[c];
                    if (!dead[size_t(p)]) merged.push_back(p);
                } else {
                    merged.insert(merged.end(),
                                  node_begins[size_t(c)].begin(),
                                  node_begins[size_t(c)].end());
                    node_begins[size_t(c)].clear();
                    node_begins[size_t(c)].shrink_to_fit();
                }
            }
            std::sort(merged.begin(), merged.end());
            node_begins[size_t(u)] = std::move(merged);
            has_begins[size_t(u)] = 1;
        }
        return node_begins[size_t(v)];
    };

    int64_t nd = 0, no = 0;
    // iterate lengths max_depth .. min_lrf (bins may gain entries at
    // smaller lengths mid-flight, exactly like the Python dict)
    for (int64_t length = max_depth; length >= min_lrf; length--) {
        // the Python loop iterates the bin list by reference; re-binned
        // nodes land in other (smaller) bins, never the current one
        for (size_t qi = 0; qi < bins[size_t(length)].size(); qi++) {
            int64_t v = bins[size_t(length)][qi];
            std::vector<int64_t>& poss = begins(v);
            std::vector<int64_t> selected, not_selected;
            int64_t last = -length - 1;
            int64_t min_shorter = 1;
            for (int64_t p : poss) {
                if (last + length <= p && !dead[size_t(p)] &&
                    !dead[size_t(p + length - 1)]) {
                    selected.push_back(p);
                    last = p;
                } else {
                    not_selected.push_back(p);
                }
                if (!dead[size_t(p)] && dead[size_t(p + length - 1)]) {
                    while (p + min_shorter < n &&
                           !dead[size_t(p + min_shorter)])
                        min_shorter++;
                }
            }
            if (min_shorter > 1 && min_shorter < length &&
                min_shorter >= min_lrf) {
                int64_t parent_depth = sdepth[parent[v]];
                if (parent_depth < min_shorter)
                    bins[size_t(min_shorter)].push_back(v);
            }
            if ((int64_t)selected.size() >= 2) {
                node_begins[size_t(v)] = std::move(not_selected);
                if (nd >= d_cap) return -1;
                d_start[nd] = selected[0];
                d_len[nd] = length;
                for (int64_t p : selected) {
                    for (int64_t j = p; j < p + length; j++)
                        dead[size_t(j)] = 1;
                    if (no >= o_cap) return -1;
                    o_pos[no] = p;
                    o_rule[no] = nd;
                    o_len[no] = length;
                    no++;
                }
                nd++;
            }
        }
    }
    *nd_out = nd;
    return no;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS BST strategy (compressors/lfs.py BSTStrategy.compute_rules,
// reference lfs/BSTStrategy.hpp over the binary suffix tree): exact
// mirror incl. the chain-DFS bin order and dead-head filtering.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs_bst(const int64_t* parent, const int64_t* sdepth,
                    const int64_t* suffix,
                    int64_t nn, int64_t n, int64_t min_lrf,
                    int64_t* d_start, int64_t* d_len, int64_t d_cap,
                    int64_t* o_pos, int64_t* o_rule, int64_t* o_len,
                    int64_t o_cap, int64_t* nd_out) {
    std::vector<int64_t> first_child(size_t(nn), 0);
    std::vector<int64_t> next_sibling(size_t(nn), 0);
    for (int64_t v = nn - 1; v >= 1; v--) {  // prepend keeps child order
        int64_t p = parent[v];
        next_sibling[size_t(v)] = first_child[size_t(p)];
        first_child[size_t(p)] = v;
    }
    int64_t max_depth = 0;
    {
        std::vector<int64_t> stack{0};
        while (!stack.empty()) {
            int64_t v = stack.back();
            stack.pop_back();
            if (first_child[size_t(v)] != 0 && sdepth[v] > max_depth)
                max_depth = sdepth[v];
            for (int64_t c = first_child[size_t(v)]; c != 0;
                 c = next_sibling[size_t(c)])
                stack.push_back(c);
        }
    }
    std::vector<std::vector<int64_t>> bins;
    bins.resize(size_t(max_depth) + 1);
    {
        std::vector<int64_t> stack{0};
        while (!stack.empty()) {
            int64_t v = stack.back();
            stack.pop_back();
            if (first_child[size_t(v)] != 0) {
                int64_t d = sdepth[v];
                if (d > 0) bins[size_t(d)].push_back(v);
                for (int64_t c = first_child[size_t(v)]; c != 0;
                     c = next_sibling[size_t(c)])
                    stack.push_back(c);
            }
        }
    }
    std::vector<uint8_t> dead(size_t(n), 0);
    std::vector<std::vector<int64_t>> begins;
    begins.resize(size_t(nn));
    std::vector<uint8_t> has(size_t(nn), 0);

    auto positions = [&](int64_t v) -> std::vector<int64_t>& {
        if (has[size_t(v)]) return begins[size_t(v)];
        std::vector<int64_t> stack{v}, order;
        while (!stack.empty()) {
            int64_t u = stack.back();
            stack.pop_back();
            order.push_back(u);
            for (int64_t c = first_child[size_t(u)]; c != 0;
                 c = next_sibling[size_t(c)])
                if (first_child[size_t(c)] != 0 && !has[size_t(c)])
                    stack.push_back(c);
        }
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            int64_t u = *it;
            if (has[size_t(u)]) continue;
            std::vector<int64_t> merged;
            for (int64_t c = first_child[size_t(u)]; c != 0;
                 c = next_sibling[size_t(c)]) {
                if (first_child[size_t(c)] == 0) {  // leaf
                    int64_t p = suffix[c];
                    if (!dead[size_t(p)]) merged.push_back(p);
                } else {
                    merged.insert(merged.end(), begins[size_t(c)].begin(),
                                  begins[size_t(c)].end());
                    begins[size_t(c)].clear();
                    begins[size_t(c)].shrink_to_fit();
                }
            }
            std::sort(merged.begin(), merged.end());
            begins[size_t(u)] = std::move(merged);
            has[size_t(u)] = 1;
        }
        return begins[size_t(v)];
    };

    int64_t nd = 0, no = 0;
    for (int64_t length = max_depth; length >= min_lrf; length--) {
        for (size_t qi = 0; qi < bins[size_t(length)].size(); qi++) {
            int64_t v = bins[size_t(length)][qi];
            std::vector<int64_t>& poss = positions(v);
            std::vector<int64_t> selected, not_selected;
            int64_t last = -length - 1;
            for (int64_t p : poss) {
                if (last + length <= p && !dead[size_t(p)] &&
                    !dead[size_t(p + length - 1)]) {
                    selected.push_back(p);
                    last = p;
                } else if (!dead[size_t(p)]) {  // drop dead heads
                    not_selected.push_back(p);
                }
            }
            if ((int64_t)selected.size() >= 2) {
                begins[size_t(v)] = std::move(not_selected);
                if (nd >= d_cap) return -1;
                d_start[nd] = selected[0];
                d_len[nd] = length;
                for (int64_t p : selected) {
                    for (int64_t j = p; j < p + length; j++)
                        dead[size_t(j)] = 1;
                    if (no >= o_cap) return -1;
                    o_pos[no] = p;
                    o_rule[no] = nd;
                    o_len[no] = length;
                    no++;
                }
                nd++;
            }
        }
    }
    *nd_out = nd;
    return no;
}

}  // extern "C"

// ---- streaming (O(window)-memory) variants ------------------------------
// Reference parity: lzss/rle/mtf/lz78 stream one pass via as_stream()
// (io/Input.hpp:199-208). These carry the per-compressor O(1)/O(window)
// state across caller-sized chunks so whole inputs never materialize.

extern "C" {

// MTF with caller-owned table state (256 bytes, identity-initialized by
// the caller before the first chunk).
void tdc_mtf_encode_s(const uint8_t* in, uint8_t* out, int64_t n,
                      uint8_t* table) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        uint8_t j = 0;
        while (table[j] != c) j++;
        out[i] = j;
        memmove(table + 1, table, j);
        table[0] = c;
    }
}

void tdc_mtf_decode_s(const uint8_t* in, uint8_t* out, int64_t n,
                      uint8_t* table) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t j = in[i];
        uint8_t c = table[j];
        out[i] = c;
        memmove(table + 1, table, j);
        table[0] = c;
    }
}

// RLE decode over a chunk, carrying `prev` across calls. Stops cleanly
// before a token whose vbyte run-length is cut by the chunk end when
// final_chunk == 0 (the caller re-feeds the tail with the next chunk).
// Returns bytes produced; *consumed <- input bytes consumed.
// -1: out_cap too small (caller grows and retries the same chunk),
// -2: malformed stream.
int64_t tdc_rle_decode_s(const uint8_t* in, int64_t n, uint8_t* out,
                         int64_t out_cap, int64_t offset,
                         int64_t* prev_io, int final_chunk,
                         int64_t* consumed) {
    int64_t o = 0;
    int64_t i = 0;
    int64_t prev = *prev_io;
    while (i < n) {
        int64_t tok = i;
        uint8_t c = in[i++];
        if (int64_t(c) == prev) {
            uint64_t run = 0;
            int shift = 0;
            bool terminated = false;
            while (i < n) {
                uint8_t b = in[i++];
                if (shift > 63) return -2;
                if (shift == 63 && (b & 0x7F) > 1) return -2;
                run |= uint64_t(b & 0x7F) << shift;
                shift += 7;
                if (!(b & 0x80)) { terminated = true; break; }
            }
            if (!terminated) {
                if (final_chunk) return -2;
                i = tok;  // hold the whole token for the next chunk
                break;
            }
            if (offset < 0 || run < uint64_t(offset)) return -2;
            run -= uint64_t(offset);
            if (o >= out_cap ||
                run > uint64_t(out_cap) || o + 1 + int64_t(run) > out_cap) {
                *consumed = tok;
                *prev_io = prev;
                return -1;
            }
            out[o++] = c;
            memset(out + o, c, size_t(run));
            o += int64_t(run);
            prev = int64_t(c);
        } else {
            if (o >= out_cap) {
                *consumed = tok;
                *prev_io = prev;
                return -1;
            }
            out[o++] = c;
            prev = int64_t(c);
        }
    }
    *consumed = i;
    *prev_io = prev;
    return o;
}

// Sliding-window LZSS factorize+encode over a chunk buffer t[0..n)
// whose byte 0 sits at absolute input position abs_base. Factorizes
// positions in [start, limit) where limit = final_chunk ? n :
// n - window (so every decision sees its full look-ahead and equals
// the whole-buffer parse); the adaptive delta field width uses the
// ABSOLUTE position (reference Range(fpos),
// LZSSSlidingWindowCompressor.hpp:86). Returns bits written into out
// (each chunk's stream starts at bit 0; the caller splices them),
// -1 if cap_bits too small, -2 on bad parameters.
// *next_i <- first unfactorized buffer index (>= limit; a final factor
// may overshoot limit).
int64_t tdc_lzss_window_encode_s(const uint8_t* t, int64_t n,
                                 int64_t start, int64_t abs_base,
                                 int final_chunk, int64_t window,
                                 int64_t threshold, int code_kind,
                                 uint8_t* out, int64_t cap_bits,
                                 int64_t* next_i) {
    if (window < 1 || threshold < 1 || start < 0) return -2;
    TdcBitWr wr{out, cap_bits, 0};
    const int64_t w_len = tdc_bits_for((uint64_t)window);
    int64_t limit = final_chunk ? n : n - window;
    int64_t i = start;
    while (i < limit) {
        int64_t buf_end = i + window;
        if (buf_end > n) buf_end = n;
        int64_t best_len = 0, best_src = 0;
        int64_t lo = i - window;
        if (lo < 0) lo = 0;
        for (int64_t k = lo; k < i; k++) {
            int64_t j = 0;
            while (i + j < buf_end && t[k + j] == t[i + j]) j++;
            if (j >= threshold && j > best_len) { best_len = j; best_src = k; }
        }
        if (best_len > 0) {
            if (wr.put_flag(code_kind, 1)) return -1;
            if (wr.put_code(code_kind, (uint64_t)(i - best_src),
                            tdc_bits_for((uint64_t)(abs_base + i))))
                return -1;
            if (wr.put_code(code_kind, (uint64_t)best_len, w_len))
                return -1;
            i += best_len;
        } else {
            if (wr.put_flag(code_kind, 0)) return -1;
            if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
                if (wr.put_code(code_kind, t[i], 8)) return -1;
            } else {
                if (wr.put(t[i], 8)) return -1;
            }
            i++;
        }
    }
    *next_i = i;
    return wr.pos;
}

}  // extern "C"

// ---- streaming LZ78/LZW parse+encode ------------------------------------
// Reference parity: LZ78/LZW stream one pass via as_stream()
// (compressors/LZ78Compressor.hpp:67, LZWCompressor.hpp:42). A heap-held
// handle carries the dictionary (open-addressing hash keyed by
// (parent << 8) | char, grown by rehash), the current node walk, and the
// factor counter across caller-sized chunks; each feed() encodes the
// factors completed inside the chunk as a bit run starting at bit 0
// (the caller splices runs through StreamBitSink). Token format and the
// dict_size reset mirror compressors/lz78.py compress() /
// lzw.py compress() exactly (reset when the trie size reaches dict_max;
// LZ78 size = factors + root, LZW size = factors + 256 roots).

struct TdcLz78S {
    std::vector<uint64_t> keys;
    std::vector<uint32_t> vals;
    uint64_t mask = 0;
    int64_t used = 0;
    int lzw = 0;
    int64_t dict_limit = 0;
    uint32_t next_id = 1;    // LZ78 fresh id (0 = root)
    uint32_t lzw_next = 256; // LZW fresh id (roots preseeded)
    uint32_t node = 0;       // current walk node
    uint32_t parent = 0;     // LZ78: node's parent for the tail factor
    uint8_t last_c = 0;
    int lzw_active = 0;      // LZW: a walk is open
    int64_t factor_count = 0;
};

static void tdc78s_rehash(TdcLz78S* s, size_t ncap) {
    std::vector<uint64_t> keys(ncap, ~0ULL);
    std::vector<uint32_t> vals(ncap, 0);
    uint64_t mask = uint64_t(ncap) - 1;
    for (size_t i = 0; i < s->keys.size(); i++) {
        if (s->keys[i] == ~0ULL) continue;
        uint64_t h = mix(s->keys[i]) & mask;
        while (keys[h] != ~0ULL) h = (h + 1) & mask;
        keys[h] = s->keys[i];
        vals[h] = s->vals[i];
    }
    s->keys.swap(keys);
    s->vals.swap(vals);
    s->mask = mask;
}

extern "C" {

void* tdc_lz78s_new(int lzw, int64_t dict_limit) {
    TdcLz78S* s = new (std::nothrow) TdcLz78S();
    if (!s) return nullptr;
    size_t cap = 1 << 16;
    if (dict_limit > 0) {  // bounded dictionary: size for it up front
        size_t want = size_t(4 * dict_limit + 1024);
        while (cap < want && cap < (size_t(1) << 28)) cap <<= 1;
    }
    s->keys.assign(cap, ~0ULL);
    s->vals.assign(cap, 0);
    s->mask = uint64_t(cap) - 1;
    s->lzw = lzw;
    s->dict_limit = dict_limit;
    return s;
}

void tdc_lz78s_free(void* h) { delete static_cast<TdcLz78S*>(h); }

// Feed one chunk; encode completed factors into `out` (bits from 0).
// final_chunk == 1 additionally flushes the trailing partial phrase.
// Returns bits written, or -1 if cap_bits is too small.
int64_t tdc_lz78s_feed(void* h, const uint8_t* in, int64_t n,
                       int final_chunk, int code_kind,
                       uint8_t* out, int64_t cap_bits) {
    TdcLz78S* s = static_cast<TdcLz78S*>(h);
    TdcBitWr wr{out, cap_bits, 0};

    auto find_or_insert = [&](uint32_t par, uint8_t c,
                              uint32_t fresh) -> int64_t {
        if (uint64_t(s->used + 1) * 2 > s->keys.size())
            tdc78s_rehash(s, s->keys.size() * 2);
        uint64_t key = (uint64_t(par) << 8) | c;
        uint64_t hh = mix(key) & s->mask;
        while (true) {
            if (s->keys[hh] == ~0ULL) {
                s->keys[hh] = key;
                s->vals[hh] = fresh;
                s->used++;
                return -1;  // inserted
            }
            if (s->keys[hh] == key) return int64_t(s->vals[hh]);
            hh = (hh + 1) & s->mask;
        }
    };
    auto reset_dict = [&]() {
        std::fill(s->keys.begin(), s->keys.end(), ~0ULL);
        s->used = 0;
        s->factor_count = 0;
    };
    auto emit_ref = [&](uint32_t ref, uint64_t range_max) -> int {
        return wr.put_code(code_kind, ref, tdc_bits_for(range_max));
    };
    auto emit_lit = [&](uint8_t c) -> int {
        if (code_kind == 1 || code_kind == 2 || code_kind == 3)
            return wr.put_code(code_kind, c, 8);
        return wr.put(c, 8);  // bit/ascii: raw byte
    };

    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        s->last_c = c;
        if (!s->lzw) {
            int64_t child = find_or_insert(s->node, c, s->next_id);
            if (child < 0) {
                if (emit_ref(s->node, uint64_t(s->factor_count)))
                    return -1;
                if (emit_lit(c)) return -1;
                s->factor_count++;
                s->next_id++;
                s->parent = s->node = 0;
                // trie.size (= next_id) reached dict_size -> reset
                if (s->dict_limit &&
                    s->next_id == uint32_t(s->dict_limit)) {
                    reset_dict();
                    s->next_id = 1;
                }
            } else {
                s->parent = s->node;
                s->node = uint32_t(child);
            }
        } else {
            if (!s->lzw_active) {
                s->node = c;
                s->lzw_active = 1;
                continue;
            }
            int64_t child = find_or_insert(s->node, c, s->lzw_next);
            if (child < 0) {
                if (emit_ref(s->node,
                             uint64_t(s->factor_count) + 256))
                    return -1;
                s->factor_count++;
                s->lzw_next++;
                s->node = c;  // walk restarts at root c (kept across reset)
                // trie.size (= lzw_next) reached dict_size -> reset
                if (s->dict_limit &&
                    s->lzw_next == uint32_t(s->dict_limit)) {
                    reset_dict();
                    s->lzw_next = 256;
                }
            } else {
                s->node = uint32_t(child);
            }
        }
    }
    if (final_chunk) {
        if (!s->lzw) {
            if (s->node != 0) {
                if (emit_ref(s->parent, uint64_t(s->factor_count)))
                    return -1;
                if (emit_lit(s->last_c)) return -1;
                s->node = 0;
            }
        } else if (s->lzw_active) {
            if (emit_ref(s->node, uint64_t(s->factor_count) + 256))
                return -1;
            s->lzw_active = 0;
        }
    }
    return wr.pos;
}

}  // extern "C"

// ---- streaming LZ78/LZW decode ------------------------------------------
// One-pass decode parity with the reference decompressors
// (LZ78Compressor.hpp:16-38 replays (ref, literal) pairs;
// LZWCompressor.hpp uses lzw::decode_step): a heap-held handle carries
// the undecoded bit tail plus the O(dict) expansion state across
// chunks. Factor expansion walks the (parent, char) chains backward —
// no reliance on output history, so output streams out chunk by chunk
// (total walk cost equals the output size). The final-byte convention
// (io/spec.md Finalization) needs the stream's last two bytes, so two
// bytes are held back until the final feed. Token decode rolls back to
// the token start on bit underrun (the VLC readers return -1 and the
// fixed-width reader overshoots nbits detectably).

struct TdcLz78DS {
    std::vector<uint8_t> pend;  // undecoded payload tail
    int64_t bit_off = 0;        // consumed bits within pend[0]
    int lzw = 0;
    int code_kind = 0;
    int64_t dict_max = 0;
    // LZ78: factor (ref, char); LZW: (pref, lastc) + open prev code
    std::vector<int32_t> ref;
    std::vector<uint8_t> ch;
    std::vector<int32_t> pref;
    std::vector<uint8_t> lastc;
    int64_t lzw_prev = -1;
    int64_t fc = 0, counter = 0;
    std::vector<uint8_t> tmp, out;

    void lzw_reset() {
        pref.assign(256, -1);
        lastc.resize(256);
        for (int j = 0; j < 256; j++) lastc[size_t(j)] = (uint8_t)j;
    }
};

extern "C" {

void* tdc_lz78ds_new(int lzw, int64_t dict_max, int code_kind) {
    TdcLz78DS* s = new (std::nothrow) TdcLz78DS();
    if (!s) return nullptr;
    s->lzw = lzw;
    s->dict_max = dict_max;
    s->code_kind = code_kind;
    if (lzw) s->lzw_reset();
    return s;
}

void tdc_lz78ds_free(void* h) { delete static_cast<TdcLz78DS*>(h); }

// Feed a compressed chunk; decoded bytes accumulate in the handle
// (drain with tdc_lz78ds_take). Returns the number of decoded bytes
// now available, or -2 on a malformed stream.
int64_t tdc_lz78ds_feed(void* h, const uint8_t* in, int64_t n,
                        int final_chunk) {
    TdcLz78DS* s = static_cast<TdcLz78DS*>(h);
    s->pend.insert(s->pend.end(), in, in + n);
    int64_t nbits;
    const int hold = 2;  // final-byte convention needs the last bytes
    if (final_chunk) {
        // io/bitio.py parse_stream over the full remaining tail
        int64_t nb = int64_t(s->pend.size());
        if (nb == 0) return int64_t(s->out.size());
        int f = s->pend[size_t(nb - 1)] & 7;
        if (f >= 6) nbits = 8 * (nb - 2) + f;
        else if (f) nbits = 8 * (nb - 1) + f;
        else nbits = 8 * (nb - 1);
        if (nbits < 0) nbits = 0;
    } else {
        if (int64_t(s->pend.size()) <= hold)
            return int64_t(s->out.size());
        nbits = 8 * (int64_t(s->pend.size()) - hold);
    }
    BitRd rd{s->pend.data(), nbits, s->bit_off};
    while (rd.pos < nbits) {
        int64_t save = rd.pos;
        if (!s->lzw) {
            int64_t r = rd.read_code(
                s->code_kind, int(tdc_bits_for((uint64_t)s->fc)));
            if (r < 0 || rd.pos >= nbits) { rd.pos = save; break; }
            int64_t c;
            if (s->code_kind == 1 || s->code_kind == 2 ||
                s->code_kind == 3) {
                c = rd.read_code(s->code_kind, 8);
            } else {
                c = rd.read(8);
            }
            if (c < 0 || rd.pos > nbits) { rd.pos = save; break; }
            if (c > 255 || r > s->fc) return -2;  // malformed
            // expand: chain walk (no output-history dependence)
            s->tmp.clear();
            s->tmp.push_back((uint8_t)c);
            for (int64_t k = r; k > 0; k = s->ref[size_t(k - 1)])
                s->tmp.push_back(s->ch[size_t(k - 1)]);
            s->out.insert(s->out.end(), s->tmp.rbegin(),
                          s->tmp.rend());
            s->ref.push_back(int32_t(r));
            s->ch.push_back((uint8_t)c);
            s->fc++;
            // trie size = factors + root
            if (s->dict_max && s->fc + 1 == s->dict_max) {
                s->ref.clear();
                s->ch.clear();
                s->fc = 0;
            }
        } else {
            if (s->dict_max > 256 &&
                s->counter == s->dict_max - 256) {
                s->lzw_reset();
                s->counter = 0;
                s->lzw_prev = -1;
            }
            int64_t k = rd.read_code(
                s->code_kind,
                int(tdc_bits_for((uint64_t)(s->counter + 256))));
            if (k < 0 || rd.pos > nbits) { rd.pos = save; break; }
            int64_t have = int64_t(s->pref.size());
            if (k > have) return -2;  // malformed
            s->counter++;
            // rebuild string of code k (or prev + first(prev) for the
            // self-referential fresh-code case), reference
            // lzw/LZWDecoding.hpp:13-49
            s->tmp.clear();
            if (k == have) {
                if (s->lzw_prev < 0) return -2;
                int64_t q = s->lzw_prev;
                while (q >= 0) {
                    s->tmp.push_back(s->lastc[size_t(q)]);
                    q = s->pref[size_t(q)];
                }
                uint8_t first = s->tmp.back();
                std::reverse(s->tmp.begin(), s->tmp.end());
                s->tmp.push_back(first);
            } else {
                int64_t q = k;
                while (q >= 0) {
                    s->tmp.push_back(s->lastc[size_t(q)]);
                    q = s->pref[size_t(q)];
                }
                std::reverse(s->tmp.begin(), s->tmp.end());
            }
            s->out.insert(s->out.end(), s->tmp.begin(), s->tmp.end());
            if (s->lzw_prev >= 0) {
                s->pref.push_back(int32_t(s->lzw_prev));
                s->lastc.push_back(s->tmp.front());
            }
            s->lzw_prev = k;
        }
    }
    s->bit_off = rd.pos;
    // drop fully-consumed bytes from the tail
    int64_t drop = s->bit_off >> 3;
    if (drop > 0) {
        s->pend.erase(s->pend.begin(), s->pend.begin() + drop);
        s->bit_off &= 7;
    }
    if (final_chunk && rd.pos < nbits) return -2;  // stuck mid-stream
    return int64_t(s->out.size());
}

// Copy and clear the decoded bytes accumulated by feed().
int64_t tdc_lz78ds_take(void* h, uint8_t* dst, int64_t cap) {
    TdcLz78DS* s = static_cast<TdcLz78DS*>(h);
    int64_t m = int64_t(s->out.size());
    if (m > cap) return -1;
    if (m) memcpy(dst, s->out.data(), size_t(m));
    s->out.clear();
    return m;
}

}  // extern "C"

// ---- streaming LZSS sliding-window decode --------------------------------
// One-pass decode of the lzss window token stream (flag, delta, len |
// flag, literal): back-copies reach at most `window` bytes, so the
// handle keeps an O(window) output tail plus the undecoded bit tail.
// Field widths follow the ABSOLUTE output position (the encoder's
// Range(fpos) convention, LZSSSlidingWindowCompressor.hpp:86).

struct TdcLzssDS {
    std::vector<uint8_t> pend;
    int64_t bit_off = 0;
    int64_t window = 0;
    int code_kind = 0;
    int64_t abs = 0;          // absolute output cursor
    std::vector<uint8_t> buf; // O(window) history + undrained output
    int64_t drained = 0;      // buf[0..drained) already returned
};

extern "C" {

void* tdc_lzssds_new(int64_t window, int code_kind) {
    if (window < 1) return nullptr;
    TdcLzssDS* s = new (std::nothrow) TdcLzssDS();
    if (!s) return nullptr;
    s->window = window;
    s->code_kind = code_kind;
    return s;
}

void tdc_lzssds_free(void* h) { delete static_cast<TdcLzssDS*>(h); }

int64_t tdc_lzssds_feed(void* h, const uint8_t* in, int64_t n,
                        int final_chunk) {
    TdcLzssDS* s = static_cast<TdcLzssDS*>(h);
    s->pend.insert(s->pend.end(), in, in + n);
    int64_t nbits;
    const int hold = 2;
    if (final_chunk) {
        int64_t nb = int64_t(s->pend.size());
        if (nb == 0) return int64_t(s->buf.size()) - s->drained;
        int f = s->pend[size_t(nb - 1)] & 7;
        if (f >= 6) nbits = 8 * (nb - 2) + f;
        else if (f) nbits = 8 * (nb - 1) + f;
        else nbits = 8 * (nb - 1);
        if (nbits < 0) nbits = 0;
    } else {
        if (int64_t(s->pend.size()) <= hold)
            return int64_t(s->buf.size()) - s->drained;
        nbits = 8 * (int64_t(s->pend.size()) - hold);
    }
    BitRd rd{s->pend.data(), nbits, s->bit_off};
    const int w_len = int(tdc_bits_for((uint64_t)s->window));
    while (rd.pos < nbits) {
        int64_t save = rd.pos;
        int64_t flag = rd.read_flag(s->code_kind);
        if (flag < 0 || rd.pos > nbits) { rd.pos = save; break; }
        if (flag) {
            int64_t delta = rd.read_code(
                s->code_kind, int(tdc_bits_for((uint64_t)s->abs)));
            if (delta < 0 || rd.pos > nbits) { rd.pos = save; break; }
            int64_t len = rd.read_code(s->code_kind, w_len);
            if (len < 0 || rd.pos > nbits) { rd.pos = save; break; }
            if (delta < 1 || delta > s->abs || delta > s->window ||
                len < 1 || len > s->window)
                return -2;
            for (int64_t k = 0; k < len; k++) {
                s->buf.push_back(
                    s->buf[s->buf.size() - size_t(delta)]
                );
            }
            s->abs += len;
        } else {
            int64_t c;
            if (s->code_kind == 1 || s->code_kind == 2 ||
                s->code_kind == 3) {
                c = rd.read_code(s->code_kind, 8);
            } else {
                c = rd.read(8);
            }
            if (c < 0 || rd.pos > nbits) { rd.pos = save; break; }
            if (c > 255) return -2;
            s->buf.push_back((uint8_t)c);
            s->abs += 1;
        }
    }
    s->bit_off = rd.pos;
    int64_t drop = s->bit_off >> 3;
    if (drop > 0) {
        s->pend.erase(s->pend.begin(), s->pend.begin() + drop);
        s->bit_off &= 7;
    }
    if (final_chunk && rd.pos < nbits) return -2;
    return int64_t(s->buf.size()) - s->drained;
}

int64_t tdc_lzssds_take(void* h, uint8_t* dst, int64_t cap) {
    TdcLzssDS* s = static_cast<TdcLzssDS*>(h);
    int64_t m = int64_t(s->buf.size()) - s->drained;
    if (m > cap) return -1;
    if (m) memcpy(dst, s->buf.data() + s->drained, size_t(m));
    s->drained = int64_t(s->buf.size());
    // trim: keep only the last `window` bytes of history
    if (int64_t(s->buf.size()) > s->window) {
        int64_t cut = int64_t(s->buf.size()) - s->window;
        s->buf.erase(s->buf.begin(), s->buf.begin() + cut);
        s->drained -= cut;
    }
    return m;
}

}  // extern "C"
