// K4 ambiguous_pass and P2 ambiguous_postings: IUPAC-ambiguous k-mer
// windows scored and added into an accumulator, IN PLACE.  Two kernels:
// the direct one (K4, and A1 on a height-split direct table) and the
// postings one (P2, P2 on an edge-range shard, and A1 on a height-split
// light table), each with its row sources (parts.cuh for the splits).
//
// K4 replaces (rappas_tpu/place/engine.py) alt_delta_rows (:907) +
// ambiguous_contrib (:967) + ambiguous_pass (:1005): an alternative's row
// is a row of the direct or compact table D, f32 or uint16, times scale
// (per element, before the exp2, as alt_delta_rows scales it), and window
// w adds into acc[win_dest[w]] with win_dest = the window's read.
//
// P2 replaces alt_delta_rows_postings (:950) + ambiguous_contrib (:967) +
// the scatter of window contributions into the dense slots (:1433-1438):
// an alternative's row is heavy_dense[alt_hrows[i]] plus the scatter of
// its light row's postings (pads carry LIGHT_PAD_EDGE and match no
// column), and window w adds into acc_c[win_dest[w]] with win_dest = the
// slot of the window's read.  Under edge-range sharding
// (rappas_tpu/parallel/postings_sharded.py:170-180, the block of _step_amb
// :223) acc_c holds the columns of one shard's edges, offset .. offset + E
// - 1, and a posting adds into column edge - offset when that lies in
// [0, E) (JAX clips instead; its out-of-range postings are pads with zero
// deltas, so both add nothing there).
//
// A1 ambiguous_pass_split replaces alt_delta_rows_split (:931) + :967 +
// :1005: K4 on the split direct table (f32 or uint16), an alternative's
// global row read from the part that JAX's select chain picks (the last
// part whose first row is <= it), clipped to that part's body height, so
// the global miss row (the total body height) reads the last part's zero
// row.  A1 ambiguous_postings_parts replaces alt_delta_rows_postings
// (:950) on a split light table: P2 with the light row of an alternative
// taken from its part as light_gather does (:654-681), clipped into it.
// One device: edge offset 0.
//
// For window w with alternatives win_off[w] .. win_off[w+1]:
//
//   mean mode: c = log10(sum_alt 10^delta / W)   (W = 1 / win_inv_w)
//   max mode:  c = max_alt delta
//   hit = max_alt delta > 0
//   acc[win_dest[w], e] += hit ? max(c, DELTA_TINY) : 0
//
// (PlacementProcess.java:1129-1236; a hit is floored at DELTA_TINY so an
// edge hit only at threshold still joins the candidate list.)  Per (window,
// column) the alternatives' terms are summed in order with __fadd_rn;
// 10^x is exp2f(x * log2 10), log10 is log2f(.) / log2 10; the build uses
// no fast math, so DELTA_TINY = 1e-30 (a normal f32) is never flushed.
// The destination is updated with atomicAdd, only on a hit, because
// several windows of one read add into one row: the order of those adds
// varies from run to run and changes the f32 sum in its last bits.
//
// What bounds them on an H100: bytes (each alternative's row of D, E
// values; P2 each heavy alternative's row and P pairs per light one),
// a microsecond or two for a batch's ~1,000 windows -- below a launch's
// own cost.  So the designs cut latency and wasted work:
//
//   * direct: `group` threads per window, one per chunk of VEC columns
//     (16 B of f32 at E = 300, 8 B of uint16: 75 chunks, 75 threads,
//     3 windows per block); a thread issues the loads of up to kAltBatch
//     alternatives' rows before their exp2f/max.  The exp2f of every
//     alternative at every column is most of the work, so a window spread
//     over fewer threads (a warp: 3 chunks each) ran slower, and so did a
//     power-of-two group (128 threads, 53 of them idle);
//   * postings: a warp per window stages the window's light postings in
//     shared memory (n_alt * P pairs: 32 for an N at P = 8, 160 for a
//     protein X; a window past kStage reads them from its light rows
//     instead) and scores only the columns they hit, one lane per distinct
//     hit column, every alternative's term in order (a heavy row's value
//     there plus the alternative's postings on that column, in posting
//     order, as the scatter adds them; 0 for an alternative that misses:
//     exp2(0) = 1).  An alternative whose heavy row is the zero row nh
//     never reads heavy_dense.  Only a window with a heavy alternative
//     needs the other columns: the whole block then sweeps them (kTileCols
//     at a time, the hit columns masked by a bitmap), a thread with
//     kColsPerThread columns' loads in flight per alternative, light
//     alternatives contributing exp2(0) = 1 there.  Each (window, column)
//     is scored once and adds at most one atomic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "loads.cuh"
#include "parts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2Of10 = 3.32192809488736235f;      // f32(log2(10))
constexpr float kInvLog2Of10 = 0.301029995663981195f;  // f32(1 / log2(10))
constexpr float kDeltaTiny = 1e-30f;                   // db.DELTA_TINY
constexpr float kSumFloor = 1e-30f;

// direct: alternatives whose row loads are issued together
constexpr int kAltBatch = 8;
// postings: windows per block (a warp each), staged pairs per window,
// columns per tile of the heavy sweep, columns per thread in flight there
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 256;
constexpr int kTileCols = 8192;
constexpr int kColsPerThread = 8;

// one alternative's term at a column: delta d into the running sum of
// 10^delta and the max
__device__ __forceinline__ void add_term(float& sum, float& mx, float d) {
  sum = __fadd_rn(sum, exp2f(__fmul_rn(d, kLog2Of10)));
  mx = fmaxf(mx, d);
}

// a window's contribution at one column, added when the column is hit
__device__ __forceinline__ void add_window(float* out, float sum, float mx,
                                           bool mean, float inv_w) {
  if (!(mx > 0.f)) return;
  const float c =
      mean ? __fmul_rn(log2f(fmaxf(__fmul_rn(sum, inv_w), kSumFloor)),
                       kInvLog2Of10)
           : mx;
  atomicAdd(out, fmaxf(c, kDeltaTiny));
}

// ---- direct (K4, A1 split) -------------------------------------------- //

// K4: alternative i's row of the direct or compact table D
template <class T>
struct DirectRows {
  const T* D;
  int E;
  const int32_t* alt_rows;
  __device__ void stage(int64_t*) {}
  __device__ const T* row(int i) const {
    return D + static_cast<int64_t>(__ldg(alt_rows + i)) * E;
  }
};

// A1 (K4 on a split direct table): global row of alternative i in its part
template <class T>
struct SplitRows {
  Parts parts;
  int E;
  const int32_t* alt_rows;
  __device__ void stage(int64_t* s_meta) { parts = stage_parts(parts, s_meta); }
  __device__ const T* row(int i) const {
    const int r = __ldg(alt_rows + i);
    const int p = parts.part_of(r);
    const int64_t local = clip(r - parts.first(p), parts.height(p));
    return static_cast<const T*>(parts.base(p)) + local * E;
  }
};

// grid ceil(n_win / (kThreads / group)), kThreads threads: thread g of a
// window's group owns the VEC-column chunks g, g + group, ...
template <class Rows, class T, int VEC>
__global__ void __launch_bounds__(kThreads)
ambiguous_direct_kernel(Rows rows, int E, float scale, int group,
                        const int32_t* __restrict__ win_off,
                        const int32_t* __restrict__ win_dest,
                        const float* __restrict__ win_inv_w,
                        const uint8_t* __restrict__ win_is_mean, int n_win,
                        float* __restrict__ acc) {
  __shared__ int64_t s_meta[3 * kMaxParts];
  rows.stage(s_meta);
  __syncthreads();
  const int per_block = kThreads / group;
  const int slot = threadIdx.x / group;  // the block's window of this thread
  const int w = blockIdx.x * per_block + slot;
  if (slot >= per_block || w >= n_win) return;
  const int g = threadIdx.x - slot * group;
  const int lo = __ldg(win_off + w);
  const int hi = __ldg(win_off + w + 1);
  const float inv_w = __ldg(win_inv_w + w);
  const bool mean = __ldg(win_is_mean + w) != 0;
  float* out = acc + static_cast<int64_t>(__ldg(win_dest + w)) * E;
  const uint64_t pol = table_policy(0);
  for (int c = g * VEC; c < E; c += group * VEC) {
    float sum[VEC], mx[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sum[v] = 0.f;
      mx[v] = -INFINITY;
    }
    for (int i0 = lo; i0 < hi; i0 += kAltBatch) {
      Words<kBytes<T, VEC>> x[kAltBatch];
#pragma unroll
      for (int j = 0; j < kAltBatch; ++j)
        if (i0 + j < hi) x[j].load(rows.row(i0 + j) + c, pol);
#pragma unroll
      for (int j = 0; j < kAltBatch; ++j)
        if (i0 + j < hi) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            add_term(sum[v], mx[v],
                     __fmul_rn(word_value<T, VEC>(x[j], v), scale));
        }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      add_window(out + c + v, sum[v], mx[v], mean, inv_w);
  }
}

template <class T, class Rows>
int launch_direct(Rows rows, int E, float scale, int vec, int group,
                  const int32_t* win_off, const int32_t* win_dest,
                  const float* win_inv_w, const uint8_t* win_is_mean,
                  int n_win, float* acc, cudaStream_t stream) {
  if (group < 1 || group > kThreads || vec < 1 || E % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_win <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  const int per_block = kThreads / group;
  const int grid = (n_win + per_block - 1) / per_block;
#define RP_DIRECT(V)                                                        \
  ambiguous_direct_kernel<Rows, T, V><<<grid, kThreads, 0, stream>>>(       \
      rows, E, scale, group, win_off, win_dest, win_inv_w, win_is_mean,     \
      n_win, acc)
  switch (vec) {
    case 1: RP_DIRECT(1); break;
    case 2: RP_DIRECT(2); break;
    case 4: RP_DIRECT(4); break;
    case 8:
      if constexpr (sizeof(T) == 2) {
        RP_DIRECT(8);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RP_DIRECT
  return static_cast<int>(cudaGetLastError());
}

// ---- postings (P2, P2 with an edge offset, A1 over parts) -------------- //

// P2's light row of an alternative: row r of one light table
struct OneLight {
  const int32_t* pairs;
  int P;
  __device__ void stage(int64_t*) {}
  __device__ const int32_t* row(int r) const {
    return pairs + static_cast<int64_t>(r) * 2 * P;
  }
};

// A1's: global row r of a split light table, in its part
struct PartLight {
  Parts parts;
  int P;
  __device__ void stage(int64_t* s_meta) { parts = stage_parts(parts, s_meta); }
  __device__ const int32_t* row(int r) const {
    const int p = parts.part_of(r);
    const int64_t local = clip(r - parts.first(p), parts.height(p) - 1);
    return static_cast<const int32_t*>(parts.base(p)) + local * 2 * P;
  }
};

// The light postings of one window, pair j = i * P + p being posting p of
// its alternative i: a column (edge - offset, or -1 for a pad or an edge
// outside [offset, offset + E)) and a delta, staged in shared memory, or
// read from the light rows when the window has more than kStage pairs
template <class Light>
struct Postings {
  Light light;
  const int32_t* alt_lrows;  // the window's first alternative's
  int P, E, offset, n;       // n = n_alt * P pairs
  const int* s_col;          // null: not staged
  const float* s_delta;

  __device__ int column(int edge) const {
    const int64_t c = static_cast<int64_t>(edge) - offset;
    return (c >= 0 && c < E) ? static_cast<int>(c) : -1;
  }
  __device__ const int32_t* row(int j) const {
    return light.row(__ldg(alt_lrows + j / P));
  }
  __device__ int col(int j) const {
    return s_col != nullptr ? s_col[j] : column(__ldg(row(j) + j % P));
  }
  __device__ float delta(int j) const {
    return s_delta != nullptr ? s_delta[j]
                              : __int_as_float(__ldg(row(j) + P + j % P));
  }
};

// the window's columns that its light postings hit, a lane per distinct
// column (its first pair): every alternative's term in order, the heavy
// row's value there (0 on the zero row nh) plus the alternative's postings
// on the column in posting order
template <class Light>
__device__ void score_light_columns(const Postings<Light>& post, int lane,
                                    const float* __restrict__ H, int nh,
                                    const int32_t* __restrict__ alt_hrows,
                                    bool mean, float inv_w, float* out) {
  const int n_alt = post.P > 0 ? post.n / post.P : 0;
  for (int j = lane; j < post.n; j += 32) {
    const int e = post.col(j);
    if (e < 0) continue;
    bool first = true;
    for (int jj = 0; jj < j && first; ++jj) first = post.col(jj) != e;
    if (!first) continue;
    float sum = 0.f, mx = -INFINITY;
    for (int i = 0; i < n_alt; ++i) {
      const int h = __ldg(alt_hrows + i);
      float v = h != nh ? __ldg(H + static_cast<int64_t>(h) * post.E + e)
                        : 0.f;
      for (int p = 0; p < post.P; ++p)
        if (post.col(i * post.P + p) == e)
          v = __fadd_rn(v, post.delta(i * post.P + p));
      add_term(sum, mx, v);
    }
    add_window(out + e, sum, mx, mean, inv_w);
  }
}

// window w: its alternatives lo .. hi, mode, 1 / W and destination row
struct Window {
  int lo, hi;
  bool mean;
  float inv_w;
  float* out;
};

__device__ __forceinline__ Window load_window(
    int w, const int32_t* __restrict__ win_off,
    const int32_t* __restrict__ win_dest, const float* __restrict__ win_inv_w,
    const uint8_t* __restrict__ win_is_mean, float* acc, int E) {
  return Window{__ldg(win_off + w), __ldg(win_off + w + 1),
                __ldg(win_is_mean + w) != 0, __ldg(win_inv_w + w),
                acc + static_cast<int64_t>(__ldg(win_dest + w)) * E};
}

// the window's postings, staged in s_col / s_delta when they fit kStage
template <class Light>
__device__ __forceinline__ Postings<Light> window_postings(
    Light light, const int32_t* alt_lrows, const Window& win, int P, int E,
    int offset, const int* s_col, const float* s_delta) {
  const int n = (win.hi - win.lo) * P;
  const bool staged = n <= kStage;
  return Postings<Light>{light, alt_lrows + win.lo, P, E, offset, n,
                         staged ? s_col : nullptr,
                         staged ? s_delta : nullptr};
}

// grid ceil(n_win / kWarps), kThreads threads: warp s scores window
// blockIdx.x * kWarps + s on the columns its light postings hit; then the
// block sweeps the other columns of each of its windows that has a heavy
// alternative
template <class Light>
__global__ void __launch_bounds__(kThreads)
ambiguous_postings_kernel(const float* __restrict__ H, int E, int nh,
                          Light light, int P,
                          const int32_t* __restrict__ alt_lrows,
                          const int32_t* __restrict__ alt_hrows, int offset,
                          const int32_t* __restrict__ win_off,
                          const int32_t* __restrict__ win_dest,
                          const float* __restrict__ win_inv_w,
                          const uint8_t* __restrict__ win_is_mean, int n_win,
                          float* __restrict__ acc) {
  __shared__ int64_t s_meta[3 * kMaxParts];
  __shared__ int s_col[kWarps][kStage];
  __shared__ float s_delta[kWarps][kStage];
  __shared__ int s_heavy[kWarps];
  __shared__ uint32_t s_bits[kTileCols / 32];
  light.stage(s_meta);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * kWarps;

  if (w0 + warp < n_win) {
    const Window win = load_window(w0 + warp, win_off, win_dest, win_inv_w,
                                   win_is_mean, acc, E);
    const Postings<Light> post = window_postings(
        light, alt_lrows, win, P, E, offset, s_col[warp], s_delta[warp]);
    bool heavy = false;
    for (int i = win.lo + lane; i < win.hi; i += 32)
      heavy |= __ldg(alt_hrows + i) != nh;
    heavy = __any_sync(0xffffffffu, heavy);
    if (post.s_col != nullptr) {
      for (int j = lane; j < post.n; j += 32) {
        const int32_t* r = post.row(j);
        s_col[warp][j] = post.column(__ldg(r + j % P));
        s_delta[warp][j] = __int_as_float(__ldg(r + P + j % P));
      }
      __syncwarp();
    }
    score_light_columns(post, lane, H, nh, alt_hrows + win.lo, win.mean,
                        win.inv_w, win.out);
    if (lane == 0) s_heavy[warp] = heavy;
  } else if (lane == 0) {
    s_heavy[warp] = 0;
  }
  __syncthreads();

  // the block over each heavy window's columns that no light posting hits
  for (int s = 0; s < kWarps; ++s) {
    if (!s_heavy[s]) continue;  // uniform: shared, written before the sync
    const Window win = load_window(w0 + s, win_off, win_dest, win_inv_w,
                                   win_is_mean, acc, E);
    const Postings<Light> post = window_postings(
        light, alt_lrows, win, P, E, offset, s_col[s], s_delta[s]);
    const int lo = win.lo, hi = win.hi;
    const bool mean = win.mean;
    const float inv_w = win.inv_w;
    float* out = win.out;
    for (int t0 = 0; t0 < E; t0 += kTileCols) {
      const int t1 = min(E, t0 + kTileCols);
      __syncthreads();  // the previous tile's bitmap is consumed
      for (int i = threadIdx.x; i < kTileCols / 32; i += kThreads)
        s_bits[i] = 0u;
      __syncthreads();
      for (int j = threadIdx.x; j < post.n; j += kThreads) {
        const int e = post.col(j);
        if (e >= t0 && e < t1)
          atomicOr(&s_bits[(e - t0) >> 5], 1u << ((e - t0) & 31));
      }
      __syncthreads();
      for (int e0 = t0 + threadIdx.x; e0 < t1;
           e0 += kThreads * kColsPerThread) {
        float sum[kColsPerThread], mx[kColsPerThread];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) {
          sum[k] = 0.f;
          mx[k] = -INFINITY;
        }
        for (int i = lo; i < hi; ++i) {
          const int h = __ldg(alt_hrows + i);
          float v[kColsPerThread];
#pragma unroll
          for (int k = 0; k < kColsPerThread; ++k) {
            const int e = e0 + k * kThreads;
            v[k] = (h != nh && e < t1)
                       ? __ldg(H + static_cast<int64_t>(h) * E + e)
                       : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kColsPerThread; ++k) add_term(sum[k], mx[k], v[k]);
        }
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) {
          const int e = e0 + k * kThreads;
          if (e < t1 && !((s_bits[(e - t0) >> 5] >> ((e - t0) & 31)) & 1u))
            add_window(out + e, sum[k], mx[k], mean, inv_w);
        }
      }
    }
  }
}

template <class Light>
int launch_postings(const float* H, int E, int nh, Light light, int P,
                    const int32_t* alt_lrows, const int32_t* alt_hrows,
                    int offset, const int32_t* win_off,
                    const int32_t* win_slot, const float* win_inv_w,
                    const uint8_t* win_is_mean, int n_win, float* acc_c,
                    cudaStream_t stream) {
  if (P < 0 || nh < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_win > 0 && E > 0)
    ambiguous_postings_kernel<Light>
        <<<(n_win + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
            H, E, nh, light, P, alt_lrows, alt_hrows, offset, win_off,
            win_slot, win_inv_w, win_is_mean, n_win, acc_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// the kernel cannot take.  win_off: int32[n_win + 1] ascending CSR offsets
// of each window's alternatives; win_read / win_slot: int32[n_win] rows of
// acc; win_inv_w: f32[n_win]; win_is_mean: uint8[n_win].

// K4.  D: f32 (u16 = 0) or uint16 (u16 = 1) [R, E]; alt_rows:
// int32[n_alt]; acc: f32[B, E], updated in place; vec: values per load
// (E % vec == 0, D 16-byte aligned to vec values); group: threads per
// window (<= kThreads).
int rp_ambiguous_pass(const void* D, int u16, int E, float scale,
                      const int32_t* alt_rows, const int32_t* win_off,
                      const int32_t* win_read, const float* win_inv_w,
                      const uint8_t* win_is_mean, int n_win, float* acc,
                      int vec, int group, cudaStream_t stream) {
  if (u16)
    return launch_direct<uint16_t>(
        DirectRows<uint16_t>{static_cast<const uint16_t*>(D), E, alt_rows},
        E, scale, vec, group, win_off, win_read, win_inv_w, win_is_mean,
        n_win, acc, stream);
  return launch_direct<float>(
      DirectRows<float>{static_cast<const float*>(D), E, alt_rows}, E, scale,
      vec, group, win_off, win_read, win_inv_w, win_is_mean, n_win, acc,
      stream);
}

// P2.  H: f32[nh + 1, E] heavy dense table (row nh zero); pairs:
// int32[nl + 1, 2P]; alt_lrows / alt_hrows: int32[n_alt] light row (nl =
// miss) and heavy row (nh = the zero row) per alternative; offset: global
// id of column 0 (postings of edges outside offset .. offset + E - 1 add
// nothing); acc_c: f32[n_slots, E], updated in place.
int rp_ambiguous_postings(const float* H, int E, int nh, const int32_t* pairs,
                          int P, const int32_t* alt_lrows,
                          const int32_t* alt_hrows, const int32_t* win_off,
                          const int32_t* win_slot, const float* win_inv_w,
                          const uint8_t* win_is_mean, int n_win, int offset,
                          float* acc_c, cudaStream_t stream) {
  return launch_postings(H, E, nh, OneLight{pairs, P}, P, alt_lrows,
                         alt_hrows, offset, win_off, win_slot, win_inv_w,
                         win_is_mean, n_win, acc_c, stream);
}

// A1, K4 on a split direct table.  meta: int64[3, n] (parts.cuh, n <=
// kMaxParts) of the parts, f32 (u16 = 0) or uint16 (u16 = 1) [H_i + 1, E],
// heights H_i; alt_rows: int32[n_alt] global body rows; the rest as K4's
// (every part aligned to vec values).
int rp_ambiguous_pass_split(const int64_t* meta, int n, int u16, int E,
                            float scale, const int32_t* alt_rows,
                            const int32_t* win_off, const int32_t* win_read,
                            const float* win_inv_w,
                            const uint8_t* win_is_mean, int n_win,
                            float* acc, int vec, int group,
                            cudaStream_t stream) {
  if (n < 1 || n > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  if (u16)
    return launch_direct<uint16_t>(
        SplitRows<uint16_t>{Parts{meta, n}, E, alt_rows}, E, scale, vec,
        group, win_off, win_read, win_inv_w, win_is_mean, n_win, acc, stream);
  return launch_direct<float>(SplitRows<float>{Parts{meta, n}, E, alt_rows},
                              E, scale, vec, group, win_off, win_read,
                              win_inv_w, win_is_mean, n_win, acc, stream);
}

// A1, P2 on a split light table.  meta: int64[3, n] (n <= kMaxParts) of
// the light parts, int32[H_i, 2P]; alt_lrows: global light rows (nl =
// miss, the last part's last row); the rest as P2's at offset 0.
int rp_ambiguous_postings_parts(const float* H, int E, int nh,
                                const int64_t* meta, int n, int P,
                                const int32_t* alt_lrows,
                                const int32_t* alt_hrows,
                                const int32_t* win_off,
                                const int32_t* win_slot,
                                const float* win_inv_w,
                                const uint8_t* win_is_mean, int n_win,
                                float* acc_c, cudaStream_t stream) {
  if (n < 1 || n > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_postings(H, E, nh, PartLight{Parts{meta, n}, P}, P,
                         alt_lrows, alt_hrows, 0, win_off, win_slot,
                         win_inv_w, win_is_mean, n_win, acc_c, stream);
}

}  // extern "C"
