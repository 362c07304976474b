// K3 finalize_wire: per-read top-K of the matched edges, written straight
// into the one-array wire format.
//
// Replaces (rappas_tpu/place/engine.py) finalize (:453) + pack_wire (:68):
//
//   S[b, e] = Q_b * thr + acc[b, e]        (Q_b = len_b - k + 1)
//   matched = acc > 0;  |L| = number of matched edges
//   top-K of S over matched edges, descending, ties to the LOWER edge
//   index (as lax.top_k); slots past |L| hold score -inf and no edge
//
// wire row (int32[K + ceil(K/2) + 1]): K scores bit-cast from f32, the K
// edge ids as two u16 per word (low half first, 65535 = no edge), |L|.
// LWR is not computed here: the host recomputes it from the exact
// scores (unpack_wire), as the JAX engine does with its wire.
//
// S is formed with __fmul_rn/__fadd_rn so that no fused multiply-add
// changes its bits against the plain PyTorch version (two roundings).
//
// What bounds it on an H100: bytes (one read of acc, B * E * 4, and a
// small write); the work is K passes of compares over a row in L1.
//
// Design: one warp per read, 8 reads per block.  Round j takes a warp
// arg-max over the edges ordered strictly below round j-1's pick in the
// order (score descending, edge ascending), so no pick needs a mark and
// nothing is staged in shared memory; the row stays in L1 across the K
// rounds.  Once a round finds nothing matched, the rest of the row is
// empty slots.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
finalize_wire_kernel(const float* __restrict__ acc, int B, int E,
                     const int32_t* __restrict__ lengths, float thr, int k,
                     int K, int W, int32_t* __restrict__ wire) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave; only warp-level sync below
  const float* a = acc + static_cast<int64_t>(b) * E;
  const float qthr =
      __fmul_rn(static_cast<float>(lengths[b] - (k - 1)), thr);

  int n = 0;
  for (int e = lane; e < E; e += 32) n += a[e] > 0.f;
  for (int off = 16; off; off >>= 1) n += __shfl_xor_sync(kFull, n, off);

  int32_t* w = wire + static_cast<int64_t>(b) * W;
  uint16_t* ew = reinterpret_cast<uint16_t*>(w + K);
  float pv = INFINITY;  // previous pick (score, edge)
  int pi = -1;
  for (int j = 0; j < K; ++j) {
    float bv = -INFINITY;
    int bi = E;
    if (pv > -INFINITY) {  // uniform over the warp
      for (int e = lane; e < E; e += 32) {
        const float x = a[e];
        if (!(x > 0.f)) continue;
        const float v = __fadd_rn(qthr, x);
        const bool below = v < pv || (v == pv && e > pi);
        if (below && v > bv) {  // ascending e: lowest index wins a tie
          bv = v;
          bi = e;
        }
      }
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
    }
    if (lane == 0) {
      w[j] = __float_as_int(bv);
      ew[j] = bv > -INFINITY ? static_cast<uint16_t>(bi) : 0xffff;
    }
    pv = bv;
    pi = bi;
  }
  if (lane == 0) {
    if (K & 1) ew[K] = 0xffff;
    w[K + (K + 1) / 2] = n;
  }
}

}  // namespace

extern "C" {

// acc: f32[B, E]; lengths: int32[B]; K = min(keep_at_most, E) <= E and
// E < 65535; wire: int32[B, K + ceil(K/2) + 1].
int rp_finalize_wire(const float* acc, int B, int E, const int32_t* lengths,
                     float thr, int k, int K, int32_t* wire,
                     cudaStream_t stream) {
  const int W = K + (K + 1) / 2 + 1;
  if (B > 0)
    finalize_wire_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                           stream>>>(acc, B, E, lengths, thr, k, K, W, wire);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
