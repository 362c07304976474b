// Exact phylo-kmer explorer, native port of the reference recursion.
//
// Faithful to WordExplorer_v3.exploreWords
// (core/algos/WordExplorer_v3.java:98-199) including:
//  * float32 running-sum accumulation with += / -= residual drift,
//  * the shared boundReached/boundReachingK sibling-pruning flags,
//  * gap jumps with the limitTo1Jump statefulness (idxOfFirstJump reset
//    only when the recursion re-enters depth 0),
//  * the L-k+2 start-position loop and per-position explorer state reset
//    (Main_DBBUILD_3.java:692,707-714).
//
// C float arithmetic is IEEE-754 binary32 like Java float, so the
// emitted scores match the reference (and the Python oracle) bit for
// bit.  Used by the DB build whenever gap jumps are active; ~1000x the
// Python oracle's speed and parallelised over nodes by the caller
// (ctypes releases the GIL).
//
// C ABI:
//   handle = we_explore(...)   -> run one node, return result handle
//   we_count(handle)           -> number of (code, sum) tuples
//   we_codes(handle), we_sums(handle) -> data pointers
//   we_free(handle)            -> release

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

struct Result {
    std::vector<int64_t> codes;
    std::vector<float> sums;
};

struct GapIntervals {
    // CSR over columns: intervals for column c are
    // lens[offsets[c] .. offsets[c+1])
    const int32_t* offsets;
    const int32_t* lens;
    int n_cols;

    bool has(int col) const {
        return col >= 0 && col < n_cols && offsets[col] < offsets[col + 1];
    }
};

struct Explorer {
    const int8_t* states;   // [L, S] sorted desc per site
    const float* pp;        // [L, S]
    int L, S, k;
    float thr;
    GapIntervals gaps;
    bool do_jumps, limit1;

    // reference explorer state (WordExplorer_v3.java:43-58)
    float cur = 0.0f;
    bool bound = false;
    int bound_k = -1;
    int first_jump = -1;
    std::vector<int64_t> word;

    Result* out;

    void explore(int i, int j, int depth) {
        if (i > L - 1) return;                       // :109-111
        if (depth == 0) first_jump = -1;             // :113-115
        word[depth] = states[(size_t)i * S + j];
        cur += pp[(size_t)i * S + j];                // f32 += drift kept
        bound = cur < thr;
        if (bound) bound_k = depth;
        if (depth == k - 1) {                        // :126-143
            if (!bound) {
                int64_t code = 0;
                for (int d = 0; d < k; d++) code = code * S + word[d];
                out->codes.push_back(code);
                out->sums.push_back(cur);
            }
            cur -= pp[(size_t)i * S + j];
            return;
        }
        for (int j2 = 0; j2 < S; j2++) {             // :147-191
            if (bound && bound_k == depth + 1) break;
            explore(i + 1, j2, depth + 1);
            if (do_jumps && i < L - 1 && gaps.has(i + 1)) {
                if (!limit1) {
                    for (int32_t g = gaps.offsets[i + 1];
                         g < gaps.offsets[i + 2]; g++)
                        explore(i + 1 + gaps.lens[g], j2, depth + 1);
                } else if (first_jump == -1) {
                    first_jump = i;
                    for (int32_t g = gaps.offsets[i + 1];
                         g < gaps.offsets[i + 2]; g++)
                        explore(i + 1 + gaps.lens[g], j2, depth + 1);
                }
            }
        }
        cur -= pp[(size_t)i * S + j];
    }
};

}  // namespace

extern "C" {

void* we_explore(const int8_t* states_sorted, const float* pp_sorted,
                 int L, int S, int k, float thr,
                 const int32_t* gap_offsets, const int32_t* gap_lens,
                 int n_gap_cols, int do_jumps, int limit1) {
    auto* res = new Result();
    Explorer ex;
    ex.states = states_sorted;
    ex.pp = pp_sorted;
    ex.L = L;
    ex.S = S;
    ex.k = k;
    ex.thr = thr;
    ex.gaps = GapIntervals{gap_offsets, gap_lens, n_gap_cols};
    ex.do_jumps = do_jumps != 0;
    ex.limit1 = limit1 != 0;
    ex.word.assign(k, 0);
    ex.out = res;

    // fresh explorer state per start position (Main_DBBUILD_3.java:707)
    for (int pos = 0; pos < L - k + 2; pos++) {
        ex.cur = 0.0f;
        ex.bound = false;
        ex.bound_k = -1;
        ex.first_jump = -1;
        for (int j = 0; j < S; j++) ex.explore(pos, j, 0);
    }
    return res;
}

int64_t we_count(void* handle) {
    return (int64_t)((Result*)handle)->codes.size();
}

const int64_t* we_codes(void* handle) {
    return ((Result*)handle)->codes.data();
}

const float* we_sums(void* handle) {
    return ((Result*)handle)->sums.data();
}

void we_free(void* handle) { delete (Result*)handle; }

}  // extern "C"
