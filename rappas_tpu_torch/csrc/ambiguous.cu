// K4 ambiguous_pass and P2 ambiguous_postings: IUPAC-ambiguous k-mer
// windows scored and added into an accumulator, IN PLACE.  One template,
// four row sources: K4's and P2's, and A1's instances of each on a table
// height-split into parts (parts.cuh).
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
// column; a k-mer is light or heavy, never both, so one of the two terms
// is zero), and window w adds into acc_c[win_dest[w]] with win_dest = the
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
// One device: edge offset 0.  What bounds A1: as K4 and P2.
//
// For window w with alternatives win_off[w] .. win_off[w+1]:
//
//   mean mode: c = log10(sum_alt 10^delta / W)   (W = 1 / win_inv_w)
//   max mode:  c = max_alt delta
//   hit = max_alt delta > 0
//   acc[win_dest[w], e] += hit ? max(c, DELTA_TINY) : 0
//
// (PlacementProcess.java:1129-1236; a hit is floored at DELTA_TINY so an
// edge hit only at threshold still joins the candidate list.)  10^x is
// exp2f(x * log2 10), log10 is log2f(.) / log2 10; the build uses no
// fast math, so DELTA_TINY = 1e-30 (a normal f32) is never flushed.
//
// The destination is updated with atomicAdd, because several windows of
// one read add into one row: the order of those adds varies from run to
// run and changes the f32 sum in its last bits.
//
// What bounds it on an H100: bytes (each alternative reads one E-wide
// row; P2 also reads P posting pairs per alternative, the same words for
// every thread, served by L1).  Ambiguous windows are rare in real reads.
//
// Design: one block per window, threads over E, a loop over the window's
// alternatives (a few: 4 for N); an edge no alternative hits adds
// nothing and issues no atomic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "parts.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kLog2Of10 = 3.32192809488736235f;      // f32(log2(10))
constexpr float kInvLog2Of10 = 0.301029995663981195f;  // f32(1 / log2(10))
constexpr float kDeltaTiny = 1e-30f;                   // db.DELTA_TINY
constexpr float kSumFloor = 1e-30f;

// K4: delta rows of a direct or compact table of f32 or uint16 values
template <class T>
struct DirectRows {
  const T* D;
  int E;
  float scale;
  const int32_t* alt_rows;
  __device__ float operator()(int i, int e) const {
    return __fmul_rn(static_cast<float>(
                         __ldg(D + static_cast<int64_t>(alt_rows[i]) * E + e)),
                     scale);
  }
};

// A1 (K4 on a split direct table): global rows, each in its part
template <class T>
struct SplitRows {
  Parts parts;
  int E;
  float scale;
  const int32_t* alt_rows;
  __device__ float operator()(int i, int e) const {
    const int r = alt_rows[i];
    const int p = parts.part_of(r);
    const int64_t local = clip(r - parts.first(p), parts.height(p));
    const T* D = static_cast<const T*>(parts.base(p));
    return __fmul_rn(static_cast<float>(__ldg(D + local * E + e)), scale);
  }
};

// P2's light row of an alternative: row r of one light table
struct OneLight {
  const int32_t* pairs;
  int P;
  __device__ const int32_t* row(int r) const {
    return pairs + static_cast<int64_t>(r) * 2 * P;
  }
};

// A1's: global row r of a split light table, in its part
struct PartLight {
  Parts parts;
  int P;
  __device__ const int32_t* row(int r) const {
    const int p = parts.part_of(r);
    const int64_t local = clip(r - parts.first(p), parts.height(p) - 1);
    return static_cast<const int32_t*>(parts.base(p)) + local * 2 * P;
  }
};

// P2: heavy dense row plus the light row's postings scattered over E; a
// posting of global edge g lands on column g - offset (offset 0 on one
// device, the shard's first edge under edge-range sharding)
template <class Light>
struct PostingsRows {
  const float* H;
  int E;
  const int32_t* alt_hrows;
  Light light;
  int P;
  const int32_t* alt_lrows;
  int offset;
  __device__ float operator()(int i, int e) const {
    float v = __ldg(H + static_cast<int64_t>(alt_hrows[i]) * E + e);
    const int32_t* row = light.row(alt_lrows[i]);
    for (int p = 0; p < P; ++p)
      if (__ldg(row + p) == e + offset)
        v = __fadd_rn(v, __int_as_float(__ldg(row + P + p)));
    return v;
  }
};

template <class Rows>
__global__ void __launch_bounds__(kThreads)
ambiguous_kernel(Rows rows, int E, const int32_t* __restrict__ win_off,
                 const int32_t* __restrict__ win_dest,
                 const float* __restrict__ win_inv_w,
                 const uint8_t* __restrict__ win_is_mean,
                 float* __restrict__ acc) {
  const int w = blockIdx.x;
  const int lo = win_off[w];
  const int hi = win_off[w + 1];
  const float inv_w = win_inv_w[w];
  const bool mean = win_is_mean[w] != 0;
  float* out = acc + static_cast<int64_t>(win_dest[w]) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float sum = 0.f;
    float mx = -INFINITY;
    for (int i = lo; i < hi; ++i) {
      const float d = rows(i, e);
      sum = __fadd_rn(sum, exp2f(__fmul_rn(d, kLog2Of10)));
      mx = fmaxf(mx, d);
    }
    if (!(mx > 0.f)) continue;
    const float c =
        mean ? __fmul_rn(log2f(fmaxf(__fmul_rn(sum, inv_w), kSumFloor)),
                         kInvLog2Of10)
             : mx;
    atomicAdd(out + e, fmaxf(c, kDeltaTiny));
  }
}

}  // namespace

extern "C" {

// K4.  D: f32 (u16 = 0) or uint16 (u16 = 1) [R, E]; alt_rows:
// int32[n_alt]; win_off: int32[n_win + 1] ascending; win_read:
// int32[n_win]; win_inv_w: f32[n_win]; win_is_mean: uint8[n_win]; acc:
// f32[B, E], updated in place.
int rp_ambiguous_pass(const void* D, int u16, int E, float scale,
                      const int32_t* alt_rows, const int32_t* win_off,
                      const int32_t* win_read, const float* win_inv_w,
                      const uint8_t* win_is_mean, int n_win, float* acc,
                      cudaStream_t stream) {
  if (n_win > 0) {
    if (u16)
      ambiguous_kernel<<<n_win, kThreads, 0, stream>>>(
          DirectRows<uint16_t>{static_cast<const uint16_t*>(D), E, scale,
                               alt_rows},
          E, win_off, win_read, win_inv_w, win_is_mean, acc);
    else
      ambiguous_kernel<<<n_win, kThreads, 0, stream>>>(
          DirectRows<float>{static_cast<const float*>(D), E, scale,
                            alt_rows},
          E, win_off, win_read, win_inv_w, win_is_mean, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

// P2.  H: f32[nh + 1, E] heavy dense table; pairs: int32[nl + 1, 2P];
// alt_lrows / alt_hrows: int32[n_alt] light row (nl = miss) and heavy row
// (nh = the zero row) per alternative; win_slot: int32[n_win] slot of the
// window's read; offset: global id of column 0 (postings of edges outside
// offset .. offset + E - 1 add nothing); acc_c: f32[n_slots, E], updated
// in place.
int rp_ambiguous_postings(const float* H, int E, const int32_t* pairs, int P,
                          const int32_t* alt_lrows, const int32_t* alt_hrows,
                          const int32_t* win_off, const int32_t* win_slot,
                          const float* win_inv_w, const uint8_t* win_is_mean,
                          int n_win, int offset, float* acc_c,
                          cudaStream_t stream) {
  if (n_win > 0)
    ambiguous_kernel<<<n_win, kThreads, 0, stream>>>(
        PostingsRows<OneLight>{H, E, alt_hrows, OneLight{pairs, P}, P,
                               alt_lrows, offset},
        E, win_off, win_slot, win_inv_w, win_is_mean, acc_c);
  return static_cast<int>(cudaGetLastError());
}

// A1, K4 on a split direct table.  meta: int64[3, n] (parts.cuh) of the
// parts, f32 (u16 = 0) or uint16 (u16 = 1) [H_i + 1, E], heights H_i;
// alt_rows: int32[n_alt] global body rows; the rest as K4's.
int rp_ambiguous_pass_split(const int64_t* meta, int n, int u16, int E,
                            float scale, const int32_t* alt_rows,
                            const int32_t* win_off, const int32_t* win_read,
                            const float* win_inv_w,
                            const uint8_t* win_is_mean, int n_win,
                            float* acc, cudaStream_t stream) {
  if (n_win > 0) {
    if (u16)
      ambiguous_kernel<<<n_win, kThreads, 0, stream>>>(
          SplitRows<uint16_t>{Parts{meta, n}, E, scale, alt_rows}, E,
          win_off, win_read, win_inv_w, win_is_mean, acc);
    else
      ambiguous_kernel<<<n_win, kThreads, 0, stream>>>(
          SplitRows<float>{Parts{meta, n}, E, scale, alt_rows}, E, win_off,
          win_read, win_inv_w, win_is_mean, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

// A1, P2 on a split light table.  meta: int64[3, n] of the light parts,
// int32[H_i, 2P]; alt_lrows: global light rows (nl = miss, the last part's
// last row); the rest as P2's at offset 0.
int rp_ambiguous_postings_parts(const float* H, int E, const int64_t* meta,
                                int n, int P, const int32_t* alt_lrows,
                                const int32_t* alt_hrows,
                                const int32_t* win_off,
                                const int32_t* win_slot,
                                const float* win_inv_w,
                                const uint8_t* win_is_mean, int n_win,
                                float* acc_c, cudaStream_t stream) {
  if (n_win > 0)
    ambiguous_kernel<<<n_win, kThreads, 0, stream>>>(
        PostingsRows<PartLight>{H, E, alt_hrows, PartLight{Parts{meta, n}, P},
                                P, alt_lrows, 0},
        E, win_off, win_slot, win_inv_w, win_is_mean, acc_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
