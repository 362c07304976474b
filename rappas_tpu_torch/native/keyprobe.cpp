// Fused k-mer indexing + row lookup for the postings layout's host path:
// a sorted-key probe for BIG key spaces (protein k>=8), or a direct
// index table where the key space is small enough for one.
//
// The reference probes its Java hash once per window
// (PlacementProcess.java:687-719).  Here the numpy pipeline did two
// vectorized passes per batch -- a k-step int64 Horner over [B, Q]
// windows and a bucketed binary-search (HostKeyIndex) -- together
// ~100 ms per 16k x 100aa batch, the prep-thread wall of the protein
// CLI loop (docs/PERF.md round 5).  This kernel fuses both: one
// rolling-hash sweep per read (O(L) per read, not O(k*Q)) with an
// inline bucket probe per window, parallelized over reads with
// std::thread (ctypes releases the GIL).
//
// Encoding contract = PlacementEngine._host_rows: out[b, q] is the
// value-table entry for a hit, `miss` for absent / ambiguous /
// past-length windows.  Buckets: lo[v >> shift] .. lo[(v >> shift)+1]
// bound the candidate range of the sorted key array (HostKeyIndex
// layout, int32 lo table).  With a direct table, out[b, q] is
// direct[v] and the keys are unused.
//
// With `lrows`, the same sweep also left-packs each read's light rows
// (r < nl) in window order into lrows[b, 0 ..) with `nl` pads to Q, and
// writes their count and their real postings (light_counts[r] summed),
// and the batch's windows on heavy rows (r > nl): postings_batch's light
// pack, P3's plan input, and whether the batch has heavy hits at all.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Args {
    const int8_t* codes;      // [B, L] state codes, negative = ambig/pad
    const int32_t* lengths;   // [B]
    int64_t B, L;
    int32_t k, n_states;
    const int64_t* keys;      // sorted unique k-mer indices
    const int32_t* vals;      // encoded row per key
    int64_t n_keys;
    const int32_t* lo;        // bucket -> first key position
    int32_t shift;
    int32_t miss;
    int32_t* out;             // [B, Q]
    const int32_t* direct;    // row per k-mer index, or null: probe keys
    int32_t nl;               // light rows are r < nl
    const int32_t* light_counts;  // [nl + 1] real postings per light row
    int32_t* lrows;           // [B, Q] packed light rows, or null
    int32_t* hits;            // [B] light rows per read
    int64_t* pairs;           // [B] real light postings per read
    int64_t* n_heavy;         // [1] windows on heavy rows (r > nl)
};

inline int32_t probe(const Args& a, int64_t v) {
    if (a.direct) return a.direct[v];
    if (a.n_keys == 0 || v > a.keys[a.n_keys - 1]) return a.miss;
    int64_t b = v >> a.shift;
    int32_t s = a.lo[b], e = a.lo[b + 1];
    for (int32_t j = s; j < e; j++) {
        int64_t kj = a.keys[j];
        if (kj == v) return a.vals[j];
        if (kj > v) break;
    }
    return a.miss;
}

//: windows ahead whose table entry a sweep prefetches: the lookups are
//: random over tables of megabytes, so the loads overlap
constexpr int64_t AHEAD = 16;

void rows_range(const Args& a, int64_t b0, int64_t b1) {
    const int64_t Q = a.L - a.k + 1;
    int64_t top = 1;                        // n_states^(k-1)
    for (int32_t i = 0; i < a.k - 1; i++) top *= a.n_states;
    std::vector<int64_t> v(Q);              // a read's indices, -1 invalid
    int64_t heavy = 0;                      // windows on rows past nl
    for (int64_t b = b0; b < b1; b++) {
        const int8_t* c = a.codes + b * a.L;
        int32_t* o = a.out + b * Q;
        const int64_t q_max = (int64_t)a.lengths[b] - a.k;  // inclusive
        int64_t idx = 0;                    // (k-1)-prefix accumulator
        int32_t bad = 0;                    // negatives in window
        for (int32_t i = 0; i < a.k - 1; i++) {
            int8_t s = c[i];
            if (s < 0) { bad++; s = 0; }
            idx = idx * a.n_states + s;
        }
        for (int64_t q = 0; q < Q; q++) {
            int8_t s_in = c[q + a.k - 1];
            if (s_in < 0) { bad++; s_in = 0; }
            idx = idx * a.n_states + s_in;  // full index of [q, q+k)
            v[q] = (bad == 0 && q <= q_max) ? idx : -1;
            int8_t s_out = c[q];            // slide: drop position q
            if (s_out < 0) { bad--; s_out = 0; }
            idx -= (int64_t)s_out * top;
        }
        for (int64_t q = 0; q < Q; q++) {
            if (a.direct && q + AHEAD < Q && v[q + AHEAD] >= 0)
                __builtin_prefetch(a.direct + v[q + AHEAD]);
            o[q] = v[q] >= 0 ? probe(a, v[q]) : a.miss;
        }
        if (!a.lrows) continue;
        int32_t* lr = a.lrows + b * Q;
        int32_t n = 0;                      // light rows packed
        int64_t p = 0;                      // their real postings
        for (int64_t q = 0; q < Q; q++) {
            if (q + AHEAD < Q && o[q + AHEAD] < a.nl)
                __builtin_prefetch(a.light_counts + o[q + AHEAD]);
            const int32_t r = o[q];
            if (r < a.nl) {
                lr[n++] = r;
                p += a.light_counts[r];
            }
            heavy += r > a.nl;
        }
        for (int64_t q = n; q < Q; q++) lr[q] = a.nl;
        a.hits[b] = n;
        a.pairs[b] = p;
    }
    if (a.lrows) __atomic_fetch_add(a.n_heavy, heavy, __ATOMIC_RELAXED);
}

}  // namespace

extern "C" {

void kp_rows(const int8_t* codes, const int32_t* lengths,
             long long B, long long L, int k, int n_states,
             const int64_t* keys, const int32_t* vals, long long n_keys,
             const int32_t* lo, int shift, int miss,
             int32_t* out, int n_threads, const int32_t* direct,
             int nl, const int32_t* light_counts, int32_t* lrows,
             int32_t* hits, int64_t* pairs, int64_t* n_heavy) {
    Args a{codes, lengths, B, L, k, n_states, keys, vals, n_keys,
           lo, (int32_t)shift, (int32_t)miss, out, direct, (int32_t)nl,
           light_counts, lrows, hits, pairs, n_heavy};
    const int64_t Q = L - k + 1;
    if (Q <= 0) return;
    if (n_threads <= 1 || B < 2 * n_threads) {
        rows_range(a, 0, B);
        return;
    }
    std::vector<std::thread> ts;
    int64_t step = (B + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo_b = t * step;
        int64_t hi_b = lo_b + step < B ? lo_b + step : B;
        if (lo_b >= hi_b) break;
        ts.emplace_back([&a, lo_b, hi_b] { rows_range(a, lo_b, hi_b); });
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
