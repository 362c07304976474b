// jplace "p"-row batch formatter (host-side hot loop of the placement
// pipeline at production read counts).
//
// The reference assembles placement rows through json_simple object
// trees, one java object per value (Main_PLACEMENT_v07.java:266-315,
// PlacementProcess.java:974-1047) -- fine at 500 reads/s, a bottleneck
// four orders of magnitude up.  Here a whole batch of placements is
// formatted in one call: edge_num / distal_length decimal strings are
// precomputed per node id by the caller (they only depend on the tree),
// so the inner loop is two shortest-round-trip double prints
// (std::to_chars, C++17) and memcpys.
//
// Row layouts (rappas_tpu_torch.place.jplace.JplaceWriter):
//   default: [edge_num, likelihood, like_weight_ratio, distal, 0.0]
//   guppy:   [distal, edge_num, like_weight_ratio, likelihood, 0.0]
//
// Returns the total bytes written, or -1 if the output buffer is too
// small (the caller grows it and retries).

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

inline char* put_str(char* p, const char* buf, int32_t lo, int32_t hi) {
    std::memcpy(p, buf + lo, hi - lo);
    return p + (hi - lo);
}

inline char* put_f64(char* p, double v) {
    auto res = std::to_chars(p, p + 32, v);
    return res.ptr;
}

}  // namespace

extern "C" {

long long jp_format_rows(
    const int32_t* nodes, const float* scores, const float* lwr,
    const int64_t* row_off, int64_t n,
    const char* estr_buf, const int32_t* estr_off,
    const char* dstr_buf, const int32_t* dstr_off,
    int guppy, char* out, int64_t cap, int64_t* out_off) {
    char* p = out;
    char* end = out + cap;
    for (int64_t i = 0; i < n; ++i) {
        out_off[i] = p - out;
        for (int64_t r = row_off[i]; r < row_off[i + 1]; ++r) {
            // worst case per row: 2 brackets + 4 commas + 2 x 25-char
            // doubles + the two cached strings + ",0.0]"
            int32_t nd = nodes[r];
            int32_t elen = estr_off[nd + 1] - estr_off[nd];
            int32_t dlen = dstr_off[nd + 1] - dstr_off[nd];
            if (end - p < 64 + elen + dlen) return -1;
            if (r > row_off[i]) *p++ = ',';
            *p++ = '[';
            if (guppy) {
                p = put_str(p, dstr_buf, dstr_off[nd], dstr_off[nd + 1]);
                *p++ = ',';
                p = put_str(p, estr_buf, estr_off[nd], estr_off[nd + 1]);
                *p++ = ',';
                p = put_f64(p, (double)lwr[r]);
                *p++ = ',';
                p = put_f64(p, (double)scores[r]);
            } else {
                p = put_str(p, estr_buf, estr_off[nd], estr_off[nd + 1]);
                *p++ = ',';
                p = put_f64(p, (double)scores[r]);
                *p++ = ',';
                p = put_f64(p, (double)lwr[r]);
                *p++ = ',';
                p = put_str(p, dstr_buf, dstr_off[nd], dstr_off[nd + 1]);
            }
            std::memcpy(p, ",0.0]", 5);
            p += 5;
        }
    }
    out_off[n] = p - out;
    return p - out;
}

namespace {

inline char* put_json_escaped(char* p, const char* h, long long hlen) {
    static const char hexd[] = "0123456789abcdef";
    for (long long j = 0; j < hlen; j++) {
        unsigned char c = h[j];
        if (c == '"' || c == '\\') {
            *p++ = '\\';
            *p++ = c;
        } else if (c < 0x20) {
            std::memcpy(p, "\\u00", 4);
            p += 4;
            *p++ = hexd[c >> 4];
            *p++ = hexd[c & 15];
        } else {
            *p++ = c;
        }
    }
    return p;
}

}  // namespace

// Assemble full placement lines for one batch:
//   {"p":[<rows_i>],"nm":[["<header_i>",1],["<dup_sub>",1],...]}
// rows_buf/rows_off come from jp_format_rows; hdr_buf/hdr_off hold the
// utf-8 headers of the SAME placements.  Headers are JSON-escaped while
// copying ('"', '\\' and control bytes -> \u00XX; other bytes pass
// through raw, i.e. ensure_ascii=False semantics).  extra_cnt (nullable)
// gives the number of duplicate-read "nm" sub-headers per placement,
// flattened in placement order in ex_buf/ex_off (round 5 -- before,
// any placement with duplicates fell back to a python renderer).
// Returns total bytes written or -1 if out is too small (caller grows).
long long jp_format_lines(const char* rows_buf, const long long* rows_off,
                          const char* hdr_buf, const long long* hdr_off,
                          const int32_t* extra_cnt, const char* ex_buf,
                          const long long* ex_off,
                          long long n, char* out, long long cap,
                          long long* out_off) {
    char* p = out;
    char* lim = out + cap;
    long long e = 0;     // running index into the flattened extras
    for (long long i = 0; i < n; i++) {
        long long rlen = rows_off[i + 1] - rows_off[i];
        long long hlen = hdr_off[i + 1] - hdr_off[i];
        long long ecnt = extra_cnt ? extra_cnt[i] : 0;
        long long elen = ecnt ? ex_off[e + ecnt] - ex_off[e] : 0;
        // worst case: every header/extra byte escapes to 6 chars
        if (p + rlen + 6 * (hlen + elen) + 10 * ecnt + 32 > lim)
            return -1;
        out_off[i] = p - out;
        std::memcpy(p, "{\"p\":[", 6);
        p += 6;
        std::memcpy(p, rows_buf + rows_off[i], rlen);
        p += rlen;
        std::memcpy(p, "],\"nm\":[[\"", 10);
        p += 10;
        p = put_json_escaped(p, hdr_buf + hdr_off[i], hlen);
        std::memcpy(p, "\",1]", 4);
        p += 4;
        for (long long k = 0; k < ecnt; k++, e++) {
            std::memcpy(p, ",[\"", 3);
            p += 3;
            p = put_json_escaped(p, ex_buf + ex_off[e],
                                 ex_off[e + 1] - ex_off[e]);
            std::memcpy(p, "\",1]", 4);
            p += 4;
        }
        // ",\n" trails every line so consecutive-run consumers can
        // slice N pre-joined lines in one go (the caller strips the
        // final separator)
        std::memcpy(p, "]},\n", 4);
        p += 4;
    }
    out_off[n] = p - out;
    return p - out;
}

// Per-placed-read TSV report lines (logs/placements_<query>.tsv,
// PlacementProcess.java:937-962 default-DB branch):
//   <qname>\t\t\t\t\t<best>\t<label>\t<score>\n
// qname = header up to the first ' '; labels come as a node-id-indexed
// blob.  The --original-nodes resolution branch stays in python (rare
// DBs).  Returns bytes written or -1 if out is too small (caller grows).
long long jp_format_tsv(const unsigned char* hdr_buf,
                        const long long* hdr_off,
                        const int32_t* best, const float* scores,
                        long long n,
                        const char* lbl_buf, const int32_t* lbl_off,
                        char* out, long long cap) {
    char* p = out;
    char* lim = out + cap;
    for (long long i = 0; i < n; i++) {
        const char* h = (const char*)hdr_buf + hdr_off[i];
        long long hlen = hdr_off[i + 1] - hdr_off[i];
        const char* sp = (const char*)std::memchr(h, ' ', hlen);
        long long qlen = sp ? sp - h : hlen;
        int32_t b = best[i];
        int32_t llen = lbl_off[b + 1] - lbl_off[b];
        if (p + qlen + llen + 64 > lim) return -1;
        std::memcpy(p, h, qlen);
        p += qlen;
        std::memcpy(p, "\t\t\t\t\t", 5);
        p += 5;
        p = std::to_chars(p, p + 12, b).ptr;
        *p++ = '\t';
        std::memcpy(p, lbl_buf + lbl_off[b], llen);
        p += llen;
        *p++ = '\t';
        p = put_f64(p, (double)scores[i]);
        *p++ = '\n';
    }
    return p - out;
}

}  // extern "C"
