// K1 accumulate_packed, K2 accumulate_codes, C1 accumulate_compact, C2
// accumulate_rows and C3 accumulate_rows_range: the row ids of a read's
// k-mer windows and the row sum over a dense delta table, fused in one pass
// per read.
//
// Replaces (rappas_tpu/place/engine.py):
//   K1: kmer_rows_packed (:253) + accumulate (:195), 2-bit packed reads on
//       the direct table;
//   K2: kmer_rows (:175) + accumulate (:195), int8 state codes on the
//       direct table (reads that carry an ambiguity or an invalid code, and
//       every read of a non-DNA alphabet);
//   C1: kmer_indices64 (:278) + compact_rows (:300) + accumulate (:195),
//       int8 state codes on the compact table, the sorted keys searched on
//       the card (k-mer index spaces that fit int32);
//   C2: accumulate (:195) over int32 rows that the host looked up in the
//       keys (index spaces above 31 bits: amino k >= 8, DNA k >= 16;
//       engine.py:1370-1373);
//   C3: the shard step of rappas_tpu/parallel/kmer_sharded.py:73-80 before
//       its psum: global int32 rows (host-searched) folded into one
//       k-mer-range shard of the compact table, + accumulate (:195), f32.
//
//   acc[dest[b], e] = scale * sum_q D[row(b, q), e]
//
// K1, K2, C1 and C2 are instantiated for an f32 and a uint16 table (C3 for
// f32: sharded placement is f32-only).  A uint16 value
// widens to f32 exactly on load, the sum stays f32, and scale multiplies
// it once at the end, as the JAX engine does (:1363, :1378): a sum of
// quantised values below 2^24 is exact in f32 in any order.
//
// row(b, q): K1/K2 roll the k codes of window q in Horner order (the row
// is the k-mer index); C1 rolls the int32 index and lower-bounds it in
// keys[n] (a hit is its position); C2 reads it.  A window past len - k
// (K1), holding a negative code (K2, C1), absent from the keys (C1), given
// as the last row (C2) or outside the shard's range (C3: global row r is
// local row r - lo when lo <= r < lo + per) is the all-zero miss row and is
// skipped, which leaves every sum bitwise unchanged.
//
// What bounds it on an H100: bytes.  Each valid window reads one E-wide
// row of D (E = 300 at BASELINE config 1: 1.2 KB in f32, 600 B in u16),
// so a batch moves about B * Q * E * itemsize bytes of row traffic, and a
// table past the 50 MB L2 (config 1's 79 MB direct table; the 1.2 GB u16
// compact table of a k=12 DB) serves most rows from DRAM.  C1 also makes
// about log2(n) dependent probes of the keys per window (21 for 2M keys);
// its 8 MB key array fits L2.  C3 reads every window's row id but only the
// rows of its own range (about 1 / mp of the hits).  The least the card
// could move is each distinct row once plus the inputs and the output
// (chip_smoke.py reports both).
//
// Design: one block per read.  The block resolves kTile row ids into
// shared memory at a time (one thread per window), then its threads span
// E and read each row with coalesced loads, summing over q in registers
// in f32 (kCols columns per thread per pass, more passes when E > kThreads
// * kCols).  No block carries state to another, so the blocks run in any
// order.  Simple first: no async copies, no row reuse across reads.
//
// D1 routed_accumulate replaces routed_accumulate (:915) on the direct
// table height-split into parts (parts.cuh; each part its body rows plus a
// trailing zero row, f32 or uint16): the host routed each read's windows
// to their parts, routed[p, b, :W] part p's part-local rows, pads >= the
// part's height (its zero row).  The same block design, with the part
// loop outside the window loop: per column a sum over each part's windows,
// the partial sums added in part order (JAX's `acc = a_0 + a_1 + ...` of
// one accumulate per part), then scale once.  What bounds it: bytes, as
// K2; the routing pads cost a shared-memory row id each, no row read.

#include <cstdint>
#include <cuda_runtime.h>

#include "parts.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kTile = 256;

// K1: base i of a 2-bit packed read sits at bits 2 * (i % 4) of byte i / 4;
// windows past lengths[b] - k miss
struct PackedRow {
  const uint8_t* seq;
  int64_t stride;
  const int32_t* lengths;
  int L, k, miss;
  __device__ int windows(int b) const {
    return min(L - k + 1, max(lengths[b] - k + 1, 0));
  }
  __device__ int operator()(int b, int q) const {
    const uint8_t* s = seq + b * stride;
    int r = 0;
    for (int i = 0; i < k; ++i) {
      const int p = q + i;
      r = r * 4 + ((s[p >> 2] >> ((p & 3) * 2)) & 3);
    }
    return r;
  }
};

// the Horner index of window q of int8 codes[b, L], or -1 when it holds a
// negative code (ambiguity or padding)
__device__ int kmer_index(const int8_t* codes, int L, int k, int n_states,
                          int b, int q) {
  const int8_t* s = codes + static_cast<int64_t>(b) * L + q;
  int r = 0;
  for (int i = 0; i < k; ++i) {
    const int c = s[i];
    if (c < 0) return -1;
    r = r * n_states + c;
  }
  return r;
}

// K2: the index is the direct table's row
struct CodeRow {
  const int8_t* codes;
  int L, k, n_states, miss;
  __device__ int windows(int) const { return L - k + 1; }
  __device__ int operator()(int b, int q) const {
    const int r = kmer_index(codes, L, k, n_states, b, q);
    return r < 0 ? miss : r;
  }
};

// C1: the index's position in the sorted keys[n], or n (= miss)
struct CompactRow {
  const int8_t* codes;
  int L, k, n_states;
  const int32_t* keys;
  int miss;  // = n
  __device__ int windows(int) const { return L - k + 1; }
  __device__ int operator()(int b, int q) const {
    const int idx = kmer_index(codes, L, k, n_states, b, q);
    if (idx < 0) return miss;
    int lo = 0, hi = miss;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(keys + mid) < idx) lo = mid + 1;
      else hi = mid;
    }
    return (lo < miss && __ldg(keys + lo) == idx) ? lo : miss;
  }
};

// C2: rows[b, q] as the host gave them
struct GivenRow {
  const int32_t* rows;
  int Q, miss;
  __device__ int windows(int) const { return Q; }
  __device__ int operator()(int b, int q) const {
    return __ldg(rows + static_cast<int64_t>(b) * Q + q);
  }
};

// C3: a global row folded into this shard's range [lo, lo + per); any
// other row is the shard's zero row per (= miss)
struct RangeRow {
  const int32_t* rows;
  int Q, lo, miss;  // miss = per
  __device__ int windows(int) const { return Q; }
  __device__ int operator()(int b, int q) const {
    const int r = __ldg(rows + static_cast<int64_t>(b) * Q + q) - lo;
    return (r >= 0 && r < miss) ? r : miss;
  }
};

template <class Rows, class T>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(Rows row_of, const T* __restrict__ D, int E, float scale,
                  const int32_t* __restrict__ dest, float* __restrict__ acc) {
  __shared__ int rows[kTile];
  const int b = blockIdx.x;
  const int nq = row_of.windows(b);
  const int miss = row_of.miss;
  float* out = acc + static_cast<int64_t>(dest != nullptr ? dest[b] : b) * E;
  for (int c0 = 0; c0 < E; c0 += kThreads * kCols) {
    float a[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[j] = 0.f;
    for (int t0 = 0; t0 < nq; t0 += kTile) {
      const int n = min(kTile, nq - t0);
      __syncthreads();  // the previous tile's rows are consumed
      for (int i = threadIdx.x; i < n; i += kThreads)
        rows[i] = row_of(b, t0 + i);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int r = rows[i];
        if (r == miss) continue;  // all-zero row, uniform over the block
        const T* d = D + static_cast<int64_t>(r) * E + c0 + threadIdx.x;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + j * kThreads + static_cast<int>(threadIdx.x) < E)
            a[j] += static_cast<float>(__ldg(d + j * kThreads));
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = c0 + j * kThreads + threadIdx.x;
      if (col < E) out[col] = a[j] * scale;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
routed_accumulate_kernel(Parts parts, const int32_t* __restrict__ routed,
                         int B, int W, int E, float scale,
                         float* __restrict__ acc) {
  __shared__ int rows[kTile];
  const int b = blockIdx.x;
  float* out = acc + static_cast<int64_t>(b) * E;
  for (int c0 = 0; c0 < E; c0 += kThreads * kCols) {
    float a[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[j] = 0.f;
    for (int p = 0; p < parts.n; ++p) {
      const T* D = static_cast<const T*>(parts.base(p));
      const int64_t H = parts.height(p);
      const int32_t* rp = routed + (static_cast<int64_t>(p) * B + b) * W;
      float s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = 0.f;
      for (int t0 = 0; t0 < W; t0 += kTile) {
        const int n = min(kTile, W - t0);
        __syncthreads();  // the previous tile's rows are consumed
        for (int i = threadIdx.x; i < n; i += kThreads)
          rows[i] = __ldg(rp + t0 + i);
        __syncthreads();
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const int r = rows[i];
          if (r >= H) continue;  // a pad: the zero row, uniform
          const T* d = D + static_cast<int64_t>(r) * E + c0 + threadIdx.x;
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (c0 + j * kThreads + static_cast<int>(threadIdx.x) < E)
              s[j] += static_cast<float>(__ldg(d + j * kThreads));
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) a[j] += s[j];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = c0 + j * kThreads + threadIdx.x;
      if (col < E) out[col] = a[j] * scale;
    }
  }
}

// one launch of B blocks on an f32 (u16 == 0) or uint16 table
template <class Rows>
int launch(Rows rows, const void* D, int u16, int E, float scale,
           const int32_t* dest, float* acc, int B, cudaStream_t stream) {
  if (B > 0) {
    if (u16)
      accumulate_kernel<<<B, kThreads, 0, stream>>>(
          rows, static_cast<const uint16_t*>(D), E, scale, dest, acc);
    else
      accumulate_kernel<<<B, kThreads, 0, stream>>>(
          rows, static_cast<const float*>(D), E, scale, dest, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// D: f32 (u16 = 0) or uint16 (u16 = 1) [miss + 1, E], row miss all zero;
// scale multiplies each sum; dest: int32[B] rows of acc to write, or null
// for rows 0..B-1; acc: f32.  Each returns cudaGetLastError().

// K1.  packed: uint8[B, seq_stride] 2-bit reads; lengths: int32[B];
// L: padded read length (Q = L - k + 1 windows).
int rp_accumulate_packed(const void* D, int u16, int E, int miss,
                         const uint8_t* packed, int64_t seq_stride,
                         const int32_t* lengths, int B, int L, int k,
                         float scale, const int32_t* dest, float* acc,
                         cudaStream_t stream) {
  return launch(PackedRow{packed, seq_stride, lengths, L, k, miss}, D, u16,
                E, scale, dest, acc, B, stream);
}

// K2.  codes: int8[B, L] state codes (row stride L).
int rp_accumulate_codes(const void* D, int u16, int E, int miss,
                        const int8_t* codes, int B, int L, int k,
                        int n_states, float scale, const int32_t* dest,
                        float* acc, cudaStream_t stream) {
  return launch(CodeRow{codes, L, k, n_states, miss}, D, u16, E, scale, dest,
                acc, B, stream);
}

// C1.  D: [n + 1, E] compact table; keys: int32[n] sorted; codes: int8[B, L]
// with n_states^k <= 2^31 - 1; acc: f32[B, E].
int rp_accumulate_compact(const void* D, int u16, int E, const int32_t* keys,
                          int n, const int8_t* codes, int B, int L, int k,
                          int n_states, float scale, float* acc,
                          cudaStream_t stream) {
  return launch(CompactRow{codes, L, k, n_states, keys, n}, D, u16, E, scale,
                nullptr, acc, B, stream);
}

// C2.  rows: int32[B, Q] rows of D (miss = the last row); acc: f32[B, E].
int rp_accumulate_rows(const void* D, int u16, int E, int miss,
                       const int32_t* rows, int B, int Q, float scale,
                       float* acc, cudaStream_t stream) {
  return launch(GivenRow{rows, Q, miss}, D, u16, E, scale, nullptr, acc, B,
                stream);
}

// C3.  D: f32[per + 1, E], the k-mer-range shard holding global rows
// lo .. lo + per - 1 (row per zero); rows: int32[B, Q] global rows of the
// whole compact table; acc: f32[B, E], this shard's partial sums.
int rp_accumulate_rows_range(const float* D, int E, const int32_t* rows,
                             int B, int Q, int lo, int per, float* acc,
                             cudaStream_t stream) {
  if (B > 0)
    accumulate_kernel<<<B, kThreads, 0, stream>>>(RangeRow{rows, Q, lo, per},
                                                  D, E, 1.f, nullptr, acc);
  return static_cast<int>(cudaGetLastError());
}

// D1.  meta: int64[3, n] (parts.cuh) of the direct table's parts, f32
// (u16 = 0) or uint16 (u16 = 1) [H_i + 1, E], heights H_i; routed:
// int32[n, B, W] part-local rows (pads >= H_i); acc: f32[B, E], written.
int rp_routed_accumulate(const int64_t* meta, int n, int u16, int E,
                         const int32_t* routed, int B, int W, float scale,
                         float* acc, cudaStream_t stream) {
  if (B > 0) {
    if (u16)
      routed_accumulate_kernel<uint16_t><<<B, kThreads, 0, stream>>>(
          Parts{meta, n}, routed, B, W, E, scale, acc);
    else
      routed_accumulate_kernel<float><<<B, kThreads, 0, stream>>>(
          Parts{meta, n}, routed, B, W, E, scale, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
