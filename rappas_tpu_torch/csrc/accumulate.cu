// K1 accumulate_packed and K2 accumulate_codes: k-mer row ids and the
// row sum over the direct delta table, fused in one pass per read.
//
// Replaces (rappas_tpu/place/engine.py):
//   K1: kmer_rows_packed (:253) + accumulate (:195), 2-bit packed reads;
//   K2: kmer_rows (:175) + accumulate (:195), int8 state codes (reads that
//       carry an ambiguity or an invalid code, and every read of a
//       non-DNA alphabet).
//
//   acc[dest[b], e] = scale * sum_q D[row(b, q), e]
//
// row(b, q) is the Horner roll of the k codes of window q; a window past
// len - k (K1) or holding a negative code (K2) is the all-zero miss row
// and is skipped, which leaves every sum bitwise unchanged.
//
// What bounds it on an H100: bytes.  Each valid window reads one E-wide
// f32 row of D (E = 300 at BASELINE config 1: 1.2 KB), so a batch moves
// about B * Q * E * 4 bytes of row traffic, and the 79 MB table of
// config 1 does not fit the 50 MB L2, so most of those rows come from
// DRAM.  The least the card could move is the table once plus the
// inputs and the output (chip_smoke.py reports both).
//
// Design: one block per read.  The block rolls kTile row ids into
// shared memory at a time (one thread per window), then its threads
// span E and read each row with coalesced 4-byte loads, summing over q
// in registers in f32 (kCols columns per thread per pass, more passes
// when E > kThreads * kCols).  No block carries state to another, so the
// blocks run in any order.  Simple first: no async copies, no row reuse
// across reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kTile = 256;

// base i of a 2-bit packed read sits at bits 2 * (i % 4) of byte i / 4
struct PackedRow {
  __device__ static int row(const uint8_t* s, int q, int k, int, int) {
    int r = 0;
    for (int i = 0; i < k; ++i) {
      const int p = q + i;
      r = r * 4 + ((s[p >> 2] >> ((p & 3) * 2)) & 3);
    }
    return r;
  }
};

// int8 state codes; a negative code (ambiguity or padding) -> miss row
struct CodeRow {
  __device__ static int row(const uint8_t* s, int q, int k, int n_states,
                            int miss) {
    int r = 0;
    for (int i = 0; i < k; ++i) {
      const int c = static_cast<int8_t>(s[q + i]);
      if (c < 0) return miss;
      r = r * n_states + c;
    }
    return r;
  }
};

template <class Decode>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const float* __restrict__ D, int E, int miss,
                  const uint8_t* __restrict__ seq, int64_t seq_stride,
                  const int32_t* __restrict__ lengths, int L, int k,
                  int n_states, float scale,
                  const int32_t* __restrict__ dest,
                  float* __restrict__ acc) {
  __shared__ int rows[kTile];
  const int b = blockIdx.x;
  const uint8_t* s = seq + b * seq_stride;
  int nq = L - k + 1;
  if (lengths != nullptr) nq = min(nq, max(lengths[b] - k + 1, 0));
  float* out = acc + static_cast<int64_t>(dest != nullptr ? dest[b] : b) * E;
  for (int c0 = 0; c0 < E; c0 += kThreads * kCols) {
    float a[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[j] = 0.f;
    for (int t0 = 0; t0 < nq; t0 += kTile) {
      const int n = min(kTile, nq - t0);
      __syncthreads();  // the previous tile's rows are consumed
      for (int i = threadIdx.x; i < n; i += kThreads)
        rows[i] = Decode::row(s, t0 + i, k, n_states, miss);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int r = rows[i];
        if (r == miss) continue;  // all-zero row, uniform over the block
        const float* d = D + static_cast<int64_t>(r) * E + c0 + threadIdx.x;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + j * kThreads + static_cast<int>(threadIdx.x) < E)
            a[j] += __ldg(d + j * kThreads);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = c0 + j * kThreads + threadIdx.x;
      if (col < E) out[col] = a[j] * scale;
    }
  }
}

}  // namespace

extern "C" {

// K1.  packed: uint8[B, seq_stride] 2-bit reads; lengths: int32[B];
// L: padded read length (Q = L - k + 1 windows); dest: int32[B] rows of
// acc to write, or null for rows 0..B-1.  Returns cudaGetLastError().
int rp_accumulate_packed(const float* D, int E, int miss,
                         const uint8_t* packed, int64_t seq_stride,
                         const int32_t* lengths, int B, int L, int k,
                         float scale, const int32_t* dest, float* acc,
                         cudaStream_t stream) {
  if (B > 0)
    accumulate_kernel<PackedRow><<<B, kThreads, 0, stream>>>(
        D, E, miss, packed, seq_stride, lengths, L, k, 4, scale, dest, acc);
  return static_cast<int>(cudaGetLastError());
}

// K2.  codes: int8[B, L] state codes (row stride L).
int rp_accumulate_codes(const float* D, int E, int miss,
                        const int8_t* codes, int B, int L, int k,
                        int n_states, float scale, const int32_t* dest,
                        float* acc, cudaStream_t stream) {
  if (B > 0)
    accumulate_kernel<CodeRow><<<B, kThreads, 0, stream>>>(
        D, E, miss, reinterpret_cast<const uint8_t*>(codes), L, nullptr, L,
        k, n_states, scale, dest, acc);
  return static_cast<int>(cudaGetLastError());
}

const char* rp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
