// K1 accumulate_packed, K2 accumulate_codes, C1 accumulate_compact, C2
// accumulate_rows and C3 accumulate_rows_range: the row ids of a read's
// k-mer windows and the row sum over a dense delta table, fused in one pass
// per read; and D1 routed_accumulate, the row sum over a height-split
// direct table.
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
// K1, K2, C1, C2 and D1 are instantiated for an f32 and a uint16 table
// (C3 for f32: sharded placement is f32-only).  A uint16 value
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
// part's height H_p.  What bounds it: bytes, the distinct rows read once
// (config 2: about 1 GB of its 1.26 GB f32 table, against 2.8 GB of row
// traffic per 16,384-read batch, each row touched ~2.2 times).  Two
// designs measured no faster than one block per read walking every part:
// the row-sum template launched once per part (it keeps a part in L2 but
// moves acc through HBM once per part and pays 13 launches' tails), and
// column slabs of a part (each re-stages the routed rows, and row pieces
// of 160-300 B cost more HBM efficiency than the L2 reuse repays).  So D1
// is one launch of routed_sum_kernel: the blocks the card holds at once
// each own a group of reads (as many as kPairs (read, VEC-column) pairs
// per thread allow) and walk the parts in order, whole rows at a time
// (kernels.routed_plan; slabs only past one block's loads); per part a
// block stages its reads' routed rows, compacts the real ones in window
// order by a ballot (pads drop out before any load) and loads 8 rows in
// flight per pair; each part's sum is added to the pair's running total
// in registers (JAX's a_0 + a_1 + ...), scaled and stored once.  No
// atomics, no partial sums in HBM, 16-byte loads at E = 300; u16 sums
// stay exact.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "loads.cuh"
#include "parts.cuh"

namespace {

// the row-sum template: threads per block, and windows whose loads are
// issued before their adds
constexpr int kSumThreads = 256;
constexpr int kInFlight = 8;

// streaming (evict-first) loads of the reads, lengths and codes
template <class T>
__device__ __forceinline__ int ld_stream(const T* p) {
  return __ldcs(p);
}

// a[i] += value i of the loaded words (f32, or uint16 widened exactly)
template <class T, int VEC>
__device__ __forceinline__ void add_words(float (&a)[VEC],
                                          const Words<kBytes<T, VEC>>& x) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] += word_value<T, VEC>(x, i);
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

// ---- D1: the routed sums over a height-split direct table ------------- //

// (read, chunk) pairs of one slab that a D1 thread owns at most
constexpr int kPairs = 4;

// grid: at most the blocks the card holds at once, kSumThreads threads,
// rpb * (W + 1) ints of dynamic shared memory.  Block g owns reads g * rpb
// .. (g + 1) * rpb - 1 of each group of gridDim.x * rpb reads; a thread
// owns up to kPairs (read, chunk) pairs of a slab (whole rows unless E
// passes one block's loads), pair j = threadIdx.x + k * kSumThreads.
// Slab by slab, then part by part in order, the block stages its reads'
// routed rows of the part, a warp per read compacts the real ones (pads >=
// the part's height drop out) in window order, and each pair sums its
// read's rows of the part, then adds that sum to its running total (JAX's
// a_0 + a_1 + ...); the totals are scaled and stored once per slab.
template <class T, int VEC>
__global__ void __launch_bounds__(kSumThreads, 2)
routed_sum_kernel(Parts parts, const int32_t* __restrict__ routed, int B,
                  int W, int E, int cols, int rpb, float scale,
                  float* __restrict__ acc) {
  extern __shared__ int rows[];  // [rpb][W] hit rows, then [rpb] counts
  int* hits = rows + rpb * W;
  __shared__ int64_t s_meta[3 * kMaxParts];
  parts = stage_parts(parts, s_meta);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint64_t pol = table_policy(0);  // a split table is past L2
  const int n_slabs = (E + cols - 1) / cols;
  for (int g0 = 0; g0 < B; g0 += gridDim.x * rpb) {
    const int b0 = g0 + blockIdx.x * rpb;
    const int n_reads = max(0, min(rpb, B - b0));
    for (int s = 0; s < n_slabs; ++s) {
      const int c0 = s * cols;
      const int chunks = (min(cols, E - c0) + VEC - 1) / VEC;
      float a[kPairs][VEC];
#pragma unroll
      for (int k = 0; k < kPairs; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) a[k][v] = 0.f;
      for (int p = 0; p < parts.n; ++p) {
        const int H = static_cast<int>(parts.height(p));
        const int32_t* rp = routed + (static_cast<int64_t>(p) * B + b0) * W;
        __syncthreads();  // the previous part's rows are consumed
        for (int i = threadIdx.x; i < n_reads * W; i += kSumThreads) {
          const int r = __ldcs(rp + i);
          rows[i] = (r >= 0 && r < H) ? r : -1;
        }
        __syncthreads();
        for (int r = threadIdx.x >> 5; r < n_reads; r += kSumThreads / 32) {
          int* own = rows + r * W;
          int cnt = 0;
          for (int q0 = 0; q0 < W; q0 += 32) {
            const int row = q0 + lane < W ? own[q0 + lane] : -1;
            const unsigned hit = __ballot_sync(0xffffffffu, row >= 0);
            if (row >= 0) own[cnt + __popc(hit & ((1u << lane) - 1u))] = row;
            cnt += __popc(hit);
          }
          if (lane == 0) hits[r] = cnt;
        }
        __syncthreads();
        const T* D = static_cast<const T*>(parts.base(p)) + c0;
#pragma unroll
        for (int k = 0; k < kPairs; ++k) {
          const int j = threadIdx.x + k * kSumThreads;
          const int rl = j / chunks;
          if (rl >= n_reads) continue;
          const int* rr = rows + rl * W;
          const int nh = hits[rl];
          const T* dcol = D + (j - rl * chunks) * VEC;
          float sum[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
          for (int i = 0; i < nh; i += kInFlight) {
            Words<kBytes<T, VEC>> x[kInFlight];
#pragma unroll
            for (int q = 0; q < kInFlight; ++q)
              if (i + q < nh)
                x[q].load(dcol + static_cast<int64_t>(rr[i + q]) * E, pol);
#pragma unroll
            for (int q = 0; q < kInFlight; ++q)
              if (i + q < nh) add_words<T, VEC>(sum, x[q]);
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v) a[k][v] = __fadd_rn(a[k][v], sum[v]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int j = threadIdx.x + k * kSumThreads;
        const int rl = j / chunks;
        if (rl < n_reads)
          store_sums<VEC>(acc + static_cast<int64_t>(b0 + rl) * E + c0 +
                              (j - rl * chunks) * VEC,
                          a[k], scale);
      }
    }
  }
}

template <class T, int VEC>
int launch_routed(Parts parts, const int32_t* routed, int B, int W, int E,
                  int cols, float scale, float* acc, cudaStream_t stream) {
  const int chunks = (cols + VEC - 1) / VEC;
  // at most as many reads per block as the pairs and 48 KB of row ids
  // allow; as few as spread the batch over the blocks the card holds
  const int max_rpb = std::min(kPairs * kSumThreads / chunks,
                               12 * 1024 / (W + 1));
  if (parts.n < 1 || parts.n > kMaxParts || cols < 1 || E % VEC != 0 ||
      (cols % VEC != 0 && cols < E) || max_rpb < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, routed_sum_kernel<T, VEC>, kSumThreads,
        static_cast<size_t>(max_rpb) * (W + 1) * 4));
  if (err) return err;
  const int resident = std::max(1, per_sm * sms);
  const int rpb = std::min(max_rpb, (B + resident - 1) / resident);
  const int grid = std::min((B + rpb - 1) / rpb, resident);
  routed_sum_kernel<T, VEC>
      <<<grid, kSumThreads, static_cast<size_t>(rpb) * (W + 1) * 4,
         stream>>>(parts, routed, B, W, E, cols, rpb, scale, acc);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_routed_typed(Parts parts, const int32_t* routed, int B, int W,
                        int E, int vec, int cols, float scale, float* acc,
                        cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch_routed<T, 1>(parts, routed, B, W, E, cols, scale, acc,
                                 stream);
    case 2:
      return launch_routed<T, 2>(parts, routed, B, W, E, cols, scale, acc,
                                 stream);
    case 4:
      return launch_routed<T, 4>(parts, routed, B, W, E, cols, scale, acc,
                                 stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_routed<T, 8>(parts, routed, B, W, E, cols, scale, acc,
                                   stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// D1.  meta: int64[3, n] (parts.cuh, n <= kMaxParts) of the direct
// table's parts, f32 (u16 = 0) or uint16 (u16 = 1) [H_i + 1, E], heights
// H_i; routed: int32[n, B, W] part-local rows (pads >= H_i); acc: f32[B,
// E], written; vec, cols: values per load and columns per slab
// (kernels.routed_plan; every part's base and acc aligned to vec values).
int rp_routed_accumulate(const int64_t* meta, int n, int u16, int E,
                         const int32_t* routed, int B, int W, float scale,
                         float* acc, int vec, int cols, cudaStream_t stream) {
  if (u16)
    return launch_routed_typed<uint16_t>(Parts{meta, n}, routed, B, W, E, vec,
                                         cols, scale, acc, stream);
  return launch_routed_typed<float>(Parts{meta, n}, routed, B, W, E, vec,
                                    cols, scale, acc, stream);
}

const char* rp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
