// K4 ambiguous_pass: IUPAC-ambiguous k-mer windows scored and added into
// the accumulator, IN PLACE.
//
// Replaces (rappas_tpu/place/engine.py) alt_delta_rows (:907) +
// ambiguous_contrib (:967) + ambiguous_pass (:1005).  For window w with
// alternatives alt_rows[win_off[w] .. win_off[w+1]) (delta rows of D,
// times scale):
//
//   mean mode: c = log10(sum_alt 10^delta / W)   (W = 1 / win_inv_w)
//   max mode:  c = max_alt delta
//   hit = max_alt delta > 0;  acc[win_read[w], e] += hit ? max(c, DELTA_TINY) : 0
//
// (PlacementProcess.java:1129-1236; a hit is floored at DELTA_TINY so an
// edge hit only at threshold still joins the candidate list.)  10^x is
// exp2f(x * log2 10), log10 is log2f(.) / log2 10; the build uses no
// fast math, so DELTA_TINY = 1e-30 (a normal f32) is never flushed.
//
// acc is updated with atomicAdd, because several windows of one read add
// into one row: the order of those adds varies from run to run and
// changes the f32 sum in its last bits.
//
// What bounds it on an H100: bytes (each alternative reads one E-wide row
// of D); ambiguous windows are rare in real reads, so this kernel is
// small next to K1/K2.
//
// Design: one block per window, threads over E, a loop over the window's
// alternatives (a few: 4 for N); an edge no alternative hits adds
// nothing and issues no atomic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2Of10 = 3.32192809488736235f;      // f32(log2(10))
constexpr float kInvLog2Of10 = 0.301029995663981195f;  // f32(1 / log2(10))
constexpr float kDeltaTiny = 1e-30f;                   // db.DELTA_TINY
constexpr float kSumFloor = 1e-30f;

__global__ void __launch_bounds__(kThreads)
ambiguous_pass_kernel(const float* __restrict__ D, int E, float scale,
                      const int32_t* __restrict__ alt_rows,
                      const int32_t* __restrict__ win_off,
                      const int32_t* __restrict__ win_read,
                      const float* __restrict__ win_inv_w,
                      const uint8_t* __restrict__ win_is_mean,
                      float* __restrict__ acc) {
  const int w = blockIdx.x;
  const int lo = win_off[w];
  const int hi = win_off[w + 1];
  const float inv_w = win_inv_w[w];
  const bool mean = win_is_mean[w] != 0;
  float* out = acc + static_cast<int64_t>(win_read[w]) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float sum = 0.f;
    float mx = -INFINITY;
    for (int i = lo; i < hi; ++i) {
      const float d = __fmul_rn(
          __ldg(D + static_cast<int64_t>(alt_rows[i]) * E + e), scale);
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

// D: f32[R, E]; alt_rows: int32[n_alt]; win_off: int32[n_win + 1]
// ascending; win_read: int32[n_win]; win_inv_w: f32[n_win]; win_is_mean:
// uint8[n_win]; acc: f32[B, E], updated in place.
int rp_ambiguous_pass(const float* D, int E, float scale,
                      const int32_t* alt_rows, const int32_t* win_off,
                      const int32_t* win_read, const float* win_inv_w,
                      const uint8_t* win_is_mean, int n_win, float* acc,
                      cudaStream_t stream) {
  if (n_win > 0)
    ambiguous_pass_kernel<<<n_win, kThreads, 0, stream>>>(
        D, E, scale, alt_rows, win_off, win_read, win_inv_w, win_is_mean,
        acc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
