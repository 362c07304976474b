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
// What bounds it on an H100: bytes, served from L2.  Each valid window
// reads one E-wide row of D (E = 300 at BASELINE config 1: 1.2 KB in
// f32, 600 B in u16): a config-1 batch of 16,384 reads moves about 2.8 GB
// of row traffic (1.4 GB in u16) against a bound, each distinct row read
// once, of a few tens of MB.  Random reads give no reuse of a row inside
// a block, so the step within reach is to serve every window's row from
// L2 (50 MB, roughly twice HBM's 3.35 TB/s) at full load width; a table
// past L2 (config 1's 79 MB f32 direct table) would otherwise serve most
// rows from DRAM.  C1 also makes about log2(n) dependent probes of the
// keys per window (21 for 2M keys); its 8 MB key array fits L2.  C3 reads
// every window's row id but only the rows of its own range (about 1 / mp
// of the hits).  chip_smoke.py reports the bound, the row bytes moved and
// their rate.
//
// Design (the host's kernels.slab_plan picks the numbers):
//   * column slabs: the table's columns are cut into slabs small enough
//     that one slab of the rows a batch can touch stays resident in L2
//     (config 1 f32: 4 slabs of 76 columns, about 20 MB each); a slab
//     row narrower than 128 B, or one slab, when the touched rows cannot
//     fit (the 1.2 GB compact tables).  The slab is the slowest grid index
//     (blockIdx.y), so the blocks resident at any moment read one slab.
//     Slab edges fall on whole vectors;
//   * several reads per block: thread t owns read t / chunks and the VEC
//     columns of chunk t % chunks of the slab, so every lane works
//     whatever E is; the block resolves the row ids of `tile` windows per
//     read at a time into shared memory, all threads at once (K1 and K2
//     recompute them per slab: a few shifts per window), then a warp per
//     read compacts its hit rows in window order by a ballot (C1, C2 and
//     C3, whose hits are sparse, then loop over hits only), and each
//     thread walks its read's hit rows in order;
//   * full-width loads, many rows in flight: VEC columns per load (16 B
//     when the row pitch allows: f32 at E = 300; 8 B for u16 rows 600 B
//     apart), 8 windows' loads issued before their adds; the reads,
//     lengths and outputs go through the evict-first (streaming) path;
//   * table loads carry an L2::evict_last policy only when a slab of the
//     rows the launch can touch fits the L2 budget (the plan's `keep`),
//     else the normal priority: evict_last lines outrank every other
//     kernel's data after the launch too, so a table past L2 (config 6's
//     compact tables, config 2's 1.26 GB direct one) would fill the L2
//     with them and gain no hits for it;
//   * C1 resolves its rows once when there is more than one slab: a
//     resolve pass writes int32 rows that the summing pass reads as C2
//     does; with one slab the search runs inline;
//   * the same sums: each column is summed in window order in f32
//     registers, miss rows skipped, scale applied once, no atomics -- the
//     bits of the one-block-per-read design this replaced.
//
// D1 routed_accumulate replaces routed_accumulate (:915) on the direct
// table height-split into parts (parts.cuh; each part its body rows plus a
// trailing zero row, f32 or uint16): the host routed each read's windows
// to their parts, routed[p, b, :W] part p's part-local rows, pads >= the
// part's height (its zero row).  One block of kThreads threads per read,
// kCols columns per thread per pass, kTile row ids staged in shared memory
// at a time, with the part loop outside the window loop: per column a sum
// over each part's windows,
// the partial sums added in part order (JAX's `acc = a_0 + a_1 + ...` of
// one accumulate per part), then scale once.  What bounds it: bytes, as
// K2; the routing pads cost a shared-memory row id each, no row read.

#include <cstdint>
#include <cuda_runtime.h>

#include "parts.cuh"

namespace {

// D1: one block per read
constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kTile = 256;

// the row-sum template: threads per block, and windows whose loads are
// issued before their adds
constexpr int kSumThreads = 256;
constexpr int kInFlight = 8;

// streaming (evict-first) loads of the reads, lengths and codes
template <class T>
__device__ __forceinline__ int ld_stream(const T* p) {
  return __ldcs(p);
}

// the L2 policy of the table's loads: keep its lines past others
// (evict_last), or the normal priority
__device__ __forceinline__ uint64_t table_policy(int keep) {
  uint64_t pol;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(pol));
  return pol;
}

// BYTES of a table row (16, 8, 4 or 2) in one read-only load with an L2
// policy, as 32-bit words (a 2-byte load fills the low half of w[0])
template <int BYTES>
struct Words;

template <>
struct Words<16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p), "l"(pol));
  }
};

template <>
struct Words<8> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
        : "=r"(w[0]), "=r"(w[1])
        : "l"(p), "l"(pol));
  }
};

template <>
struct Words<4> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
        : "=r"(w[0])
        : "l"(p), "l"(pol));
  }
};

template <>
struct Words<2> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    unsigned short h;
    asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
        : "=h"(h)
        : "l"(p), "l"(pol));
    w[0] = h;
  }
};

// the bytes of VEC values of T: one load
template <class T, int VEC>
constexpr int kBytes = VEC * static_cast<int>(sizeof(T));

// a[i] += value i of the loaded words (f32, or uint16 widened exactly)
template <class T, int VEC>
__device__ __forceinline__ void add_words(float (&a)[VEC],
                                          const Words<kBytes<T, VEC>>& x) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (sizeof(T) == 4)
      a[i] += __uint_as_float(x.w[i]);
    else
      a[i] += static_cast<float>((x.w[i / 2] >> (16 * (i & 1))) & 0xffffu);
  }
}

// VEC f32 sums times scale to out[0 .. VEC), streaming stores
template <int VEC>
__device__ __forceinline__ void store_sums(float* out, const float (&a)[VEC],
                                           float scale) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      __stcs(reinterpret_cast<float4*>(out + i),
             make_float4(a[i] * scale, a[i + 1] * scale, a[i + 2] * scale,
                         a[i + 3] * scale));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(out),
           make_float2(a[0] * scale, a[1] * scale));
  } else {
    __stcs(out, a[0] * scale);
  }
}

// K1: base i of a 2-bit packed read sits at bits 2 * (i % 4) of byte i / 4;
// windows past lengths[b] - k miss
struct PackedRow {
  const uint8_t* seq;
  int64_t stride;
  const int32_t* lengths;
  int L, k, miss;
  __device__ int max_windows() const { return L - k + 1; }
  __device__ int windows(int b) const {
    return min(L - k + 1, max(ld_stream(lengths + b) - k + 1, 0));
  }
  __device__ int operator()(int b, int q) const {
    const uint8_t* s = seq + b * stride;
    int r = 0;
    for (int i = 0; i < k; ++i) {
      const int p = q + i;
      r = r * 4 + ((ld_stream(s + (p >> 2)) >> ((p & 3) * 2)) & 3);
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
    const int c = ld_stream(s + i);
    if (c < 0) return -1;
    r = r * n_states + c;
  }
  return r;
}

// K2: the index is the direct table's row
struct CodeRow {
  const int8_t* codes;
  int L, k, n_states, miss;
  __device__ int max_windows() const { return L - k + 1; }
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
  __device__ int max_windows() const { return L - k + 1; }
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

// C2 (and C1 after its resolve pass): rows[b, q] as given
struct GivenRow {
  const int32_t* rows;
  int Q, miss;
  __device__ int max_windows() const { return Q; }
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
  __device__ int max_windows() const { return Q; }
  __device__ int windows(int) const { return Q; }
  __device__ int operator()(int b, int q) const {
    const int r = __ldg(rows + static_cast<int64_t>(b) * Q + q) - lo;
    return (r >= 0 && r < miss) ? r : miss;
  }
};

// The slab plan of one launch (kernels.slab_plan): VEC columns per load,
// `cols` columns per slab (a multiple of VEC, or E), `rpb` reads per
// block, `tile` row ids per read staged at a time, `keep` the table's
// loads evict_last.
struct Slabs {
  int vec, cols, rpb, tile, keep;
};

// grid (ceil(B / rpb), n_slabs), kSumThreads threads, rpb * (tile + 2)
// ints of dynamic shared memory
template <class Rows, class T, int VEC>
__global__ void __launch_bounds__(kSumThreads, 3)
accumulate_kernel(Rows row_of, const T* __restrict__ D, int E, Slabs sl,
                  float scale, const int32_t* __restrict__ dest,
                  float* __restrict__ acc, int B) {
  extern __shared__ int rows[];  // [rpb][tile + 1] hit rows, then [rpb]
  int* hits = rows + sl.rpb * (sl.tile + 1);  // hit rows per read
  const int pitch = sl.tile + 1;
  const int c0 = blockIdx.y * sl.cols;  // the slab's first column
  const int width = min(sl.cols, E - c0);
  const int chunks = (sl.cols + VEC - 1) / VEC;
  const int rl = threadIdx.x / chunks;
  const int c = threadIdx.x - rl * chunks;
  const int b0 = blockIdx.x * sl.rpb;
  const bool active = rl < sl.rpb && b0 + rl < B && c * VEC < width;
  const int lane = threadIdx.x & 31;
  const int miss = row_of.miss;
  const int nq = row_of.max_windows();
  const T* dcol = D + c0 + c * VEC;
  const uint64_t pol = table_policy(sl.keep);
  const int n_reads = min(sl.rpb, B - b0);
  float a[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = 0.f;
  for (int t0 = 0; t0 < nq; t0 += sl.tile) {
    const int n = min(sl.tile, nq - t0);
    __syncthreads();  // the previous tile's rows are consumed
    // every thread resolves windows of the block's reads
    for (int i = threadIdx.x; i < n_reads * n; i += kSumThreads) {
      const int r = i / n;
      const int q = t0 + (i - r * n);
      rows[r * pitch + (i - r * n)] =
          q < row_of.windows(b0 + r) ? row_of(b0 + r, q) : miss;
    }
    __syncthreads();
    // a warp per read keeps its hit rows, in window order, in place
    for (int r = threadIdx.x >> 5; r < n_reads; r += kSumThreads / 32) {
      int* own = rows + r * pitch;
      int cnt = 0;
      for (int q0 = 0; q0 < n; q0 += 32) {
        const int row = q0 + lane < n ? own[q0 + lane] : miss;
        const unsigned hit = __ballot_sync(0xffffffffu, row != miss);
        if (row != miss) own[cnt + __popc(hit & ((1u << lane) - 1u))] = row;
        cnt += __popc(hit);
      }
      if (lane == 0) hits[r] = cnt;
    }
    __syncthreads();
    if (!active) continue;
    const int* rr = rows + rl * pitch;
    const int nh = hits[rl];
    for (int i = 0; i < nh; i += kInFlight) {
      Words<kBytes<T, VEC>> x[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (i + j < nh)
          x[j].load(dcol + static_cast<int64_t>(rr[i + j]) * E, pol);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (i + j < nh) add_words<T, VEC>(a, x[j]);
    }
  }
  if (active) {
    const int b = b0 + rl;
    const int row = dest != nullptr ? ld_stream(dest + b) : b;
    store_sums<VEC>(acc + static_cast<int64_t>(row) * E + c0 + c * VEC, a,
                    scale);
  }
}

// C1's resolve pass: rows[b, q] = row_of(b, q), one thread per window
template <class Rows>
__global__ void resolve_rows_kernel(Rows row_of, int B, int Q,
                                    int32_t* __restrict__ rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(B) * Q) return;
  const int b = static_cast<int>(i / Q);
  rows[i] = row_of(b, static_cast<int>(i - static_cast<int64_t>(b) * Q));
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

// one launch of the row sum on a table of T with VEC columns per load
template <class Rows, class T, int VEC>
int launch_vec(Rows rows, const T* D, int E, Slabs sl, float scale,
               const int32_t* dest, float* acc, int B, cudaStream_t stream) {
  const int chunks = (sl.cols + VEC - 1) / VEC;
  const size_t smem = static_cast<size_t>(sl.rpb) * (sl.tile + 2) * 4;
  if (sl.cols < 1 || (sl.cols % VEC != 0 && sl.cols < E) || E % VEC != 0 ||
      sl.rpb < 1 || sl.tile < 1 || sl.rpb * chunks > kSumThreads ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && E > 0) {
    const dim3 grid((B + sl.rpb - 1) / sl.rpb, (E + sl.cols - 1) / sl.cols);
    accumulate_kernel<Rows, T, VEC><<<grid, kSumThreads, smem, stream>>>(
        rows, D, E, sl, scale, dest, acc, B);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Rows, class T>
int launch_typed(Rows rows, const T* D, int E, Slabs sl, float scale,
                 const int32_t* dest, float* acc, int B,
                 cudaStream_t stream) {
  switch (sl.vec) {
    case 1:
      return launch_vec<Rows, T, 1>(rows, D, E, sl, scale, dest, acc, B,
                                    stream);
    case 2:
      return launch_vec<Rows, T, 2>(rows, D, E, sl, scale, dest, acc, B,
                                    stream);
    case 4:
      return launch_vec<Rows, T, 4>(rows, D, E, sl, scale, dest, acc, B,
                                    stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_vec<Rows, T, 8>(rows, D, E, sl, scale, dest, acc, B,
                                      stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// one row sum on an f32 (u16 == 0) or uint16 table
template <class Rows>
int launch(Rows rows, const void* D, int u16, int E, Slabs sl, float scale,
           const int32_t* dest, float* acc, int B, cudaStream_t stream) {
  if (u16)
    return launch_typed(rows, static_cast<const uint16_t*>(D), E, sl, scale,
                        dest, acc, B, stream);
  return launch_typed(rows, static_cast<const float*>(D), E, sl, scale, dest,
                      acc, B, stream);
}

}  // namespace

extern "C" {

// D: f32 (u16 = 0) or uint16 (u16 = 1) [miss + 1, E], row miss all zero;
// scale multiplies each sum; dest: int32[B] rows of acc to write, or null
// for rows 0..B-1; acc: f32; (vec, cols, rpb, tile, keep): the slab plan
// (kernels.slab_plan).  Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a slab plan the kernel cannot take.

// K1.  packed: uint8[B, seq_stride] 2-bit reads; lengths: int32[B];
// L: padded read length (Q = L - k + 1 windows).
int rp_accumulate_packed(const void* D, int u16, int E, int miss,
                         const uint8_t* packed, int64_t seq_stride,
                         const int32_t* lengths, int B, int L, int k,
                         float scale, const int32_t* dest, float* acc,
                         int vec, int cols, int rpb, int tile, int keep,
                         cudaStream_t stream) {
  return launch(PackedRow{packed, seq_stride, lengths, L, k, miss}, D, u16,
                E, Slabs{vec, cols, rpb, tile, keep}, scale, dest, acc, B,
                stream);
}

// K2.  codes: int8[B, L] state codes (row stride L).
int rp_accumulate_codes(const void* D, int u16, int E, int miss,
                        const int8_t* codes, int B, int L, int k,
                        int n_states, float scale, const int32_t* dest,
                        float* acc, int vec, int cols, int rpb, int tile,
                        int keep, cudaStream_t stream) {
  return launch(CodeRow{codes, L, k, n_states, miss}, D, u16, E,
                Slabs{vec, cols, rpb, tile, keep}, scale, dest, acc, B,
                stream);
}

// C1.  D: [n + 1, E] compact table; keys: int32[n] sorted; codes: int8[B, L]
// with n_states^k <= 2^31 - 1; acc: f32[B, E]; rows: int32[B, L - k + 1]
// scratch for the resolve pass (null: the search runs inline, one slab).
int rp_accumulate_compact(const void* D, int u16, int E, const int32_t* keys,
                          int n, const int8_t* codes, int B, int L, int k,
                          int n_states, float scale, float* acc,
                          int32_t* rows, int vec, int cols, int rpb,
                          int tile, int keep, cudaStream_t stream) {
  const CompactRow search{codes, L, k, n_states, keys, n};
  const Slabs sl{vec, cols, rpb, tile, keep};
  const int Q = L - k + 1;
  if (rows == nullptr || Q <= 0)
    return launch(search, D, u16, E, sl, scale, nullptr, acc, B, stream);
  const int64_t total = static_cast<int64_t>(B) * Q;
  if (total > 0)
    resolve_rows_kernel<<<static_cast<int>((total + 255) / 256), 256, 0,
                          stream>>>(search, B, Q, rows);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch(GivenRow{rows, Q, n}, D, u16, E, sl, scale, nullptr, acc, B,
                stream);
}

// C2.  rows: int32[B, Q] rows of D (miss = the last row); acc: f32[B, E].
int rp_accumulate_rows(const void* D, int u16, int E, int miss,
                       const int32_t* rows, int B, int Q, float scale,
                       float* acc, int vec, int cols, int rpb, int tile,
                       int keep, cudaStream_t stream) {
  return launch(GivenRow{rows, Q, miss}, D, u16, E,
                Slabs{vec, cols, rpb, tile, keep}, scale, nullptr, acc, B,
                stream);
}

// C3.  D: f32[per + 1, E], the k-mer-range shard holding global rows
// lo .. lo + per - 1 (row per zero); rows: int32[B, Q] global rows of the
// whole compact table; acc: f32[B, E], this shard's partial sums.
int rp_accumulate_rows_range(const float* D, int E, const int32_t* rows,
                             int B, int Q, int lo, int per, float* acc,
                             int vec, int cols, int rpb, int tile, int keep,
                             cudaStream_t stream) {
  return launch_typed(RangeRow{rows, Q, lo, per}, D, E,
                      Slabs{vec, cols, rpb, tile, keep}, 1.f, nullptr, acc, B,
                      stream);
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
