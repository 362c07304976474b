// Fused k-mer indexing + sorted-key probe for BIG key spaces (the
// protein k>=8 host path).
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
// layout, int32 lo table).

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
};

inline int32_t probe(const Args& a, int64_t v) {
    if (v > a.keys[a.n_keys - 1]) return a.miss;
    int64_t b = v >> a.shift;
    int32_t s = a.lo[b], e = a.lo[b + 1];
    for (int32_t j = s; j < e; j++) {
        int64_t kj = a.keys[j];
        if (kj == v) return a.vals[j];
        if (kj > v) break;
    }
    return a.miss;
}

void rows_range(const Args& a, int64_t b0, int64_t b1) {
    const int64_t Q = a.L - a.k + 1;
    int64_t top = 1;                        // n_states^(k-1)
    for (int32_t i = 0; i < a.k - 1; i++) top *= a.n_states;
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
            o[q] = (bad == 0 && q <= q_max) ? probe(a, idx) : a.miss;
            int8_t s_out = c[q];            // slide: drop position q
            if (s_out < 0) { bad--; s_out = 0; }
            idx -= (int64_t)s_out * top;
        }
    }
}

}  // namespace

extern "C" {

void kp_rows(const int8_t* codes, const int32_t* lengths,
             long long B, long long L, int k, int n_states,
             const int64_t* keys, const int32_t* vals, long long n_keys,
             const int32_t* lo, int shift, int miss,
             int32_t* out, int n_threads) {
    Args a{codes, lengths, B, L, k, n_states, keys, vals, n_keys,
           lo, (int32_t)shift, (int32_t)miss, out};
    const int64_t Q = L - k + 1;
    if (Q <= 0) return;
    if (n_keys == 0) {
        for (int64_t i = 0; i < B * Q; i++) out[i] = miss;
        return;
    }
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
