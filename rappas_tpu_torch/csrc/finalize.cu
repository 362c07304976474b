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
// When E >= 65535 the ids do not fit u16 and the row is the wide form
// (int32[2K + 1]): K scores, K int32 edge ids (-1 = no edge), |L|.
// LWR is not computed here: the host recomputes it from the exact
// scores (unpack_wire), as the JAX engine does with its wire.
//
// S is formed with __fmul_rn/__fadd_rn so that no fused multiply-add
// changes its bits against the plain PyTorch version (two roundings).
// Candidates are ranked by S, never by acc: two different acc values can
// round to the same S, and the tie then goes to the lower edge.
//
// What bounds it on an H100: bytes (one read of acc, B * E * 4, and a
// small write: 0.0061 ms at config 1's B = 16,384, E = 300).  The first
// design (a warp per read, K + 1 scalar passes over the row, each a
// 5-step shuffle arg-max) took 7.5x that: a chain of dependent L1 loads
// and shuffles per pick.
//
// Design: the row read once, as P3 reads its dense slot row (topk.cuh):
// scalar loads up to the row's first 16-byte boundary, then 16-byte loads, a
// batch of 80 per group in flight (kBatch per lane: config 1's whole
// 300-column row), then a scalar tail.  The same pass counts acc > 0 (|L|)
// and keeps each lane's best kLaneTop (S, e) in registers.  Config 1's rows
// are dense (227 of 300 columns matched on average): unfiltered, nearly
// every value would enter a lane's list.  So each batch first finds a bound,
// the K-th best of the lanes' batch maxima (G shuffles).  A value below it
// has K better ones in the batch and cannot be a pick, so only the few at or
// above it are inserted, reloaded from L1 one at a time; a lane sees its
// edges in ascending order, so an insert compares scores only
// (insert_after).  K rounds of a shuffle arg-max over the lane heads then
// take the picks (warp_take).  K past kLaneTop (e.g. --keep-at-most 20)
// takes K scanning rounds over S instead (warp_scan_take, the row in L1);
// the picks are the same.  Group lane 0 writes the wire.
//
// Shape: G = 8 lanes per read, 32 reads a 256-thread block.  8 lanes
// take the K rounds for four reads at once and hold a 300-column row in
// one batch of ten loads a lane: the fastest of 8, 16 and 32 lanes per
// read on the card at config 1 (PERF.md), where 32 took about twice as
// long.
// Tried and dropped on the card: the raw loads kept live beside S (127
// registers), a warp reduction (__reduce_*_sync) in place of the shuffle
// arg-max, a register cap for one wave (spills), and inserts straight
// from registers in place of the L1 reloads (40 guarded insert sites).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int G = 8;  // lanes per read (Shape above)

// the K-th best of the group's values m (K <= G; -inf counts as a value);
// every lane of the group returns it
__device__ __forceinline__ float group_kth(float m, int K, unsigned mask) {
  int ge = 0;
#pragma unroll
  for (int l = 0; l < G; ++l) ge += __shfl_sync(mask, m, l, G) >= m;
  float t = ge >= K ? m : -INFINITY;
#pragma unroll
  for (int off = G / 2; off; off >>= 1)
    t = fmaxf(t, __shfl_xor_sync(mask, t, off));
  return t;
}

// insert (x, i) into a lane's list whose ids are all below i: the order
// is then by score alone (an equal score stays ahead)
__device__ __forceinline__ void insert_after(LaneTop& t, float x, int i) {
  if (!(x > t.v[kLaneTop - 1])) return;
  bool c[kLaneTop];
#pragma unroll
  for (int j = 0; j < kLaneTop; ++j) c[j] = x > t.v[j];
#pragma unroll
  for (int j = kLaneTop - 1; j > 0; --j)
    if (c[j]) {
      t.v[j] = c[j - 1] ? t.v[j - 1] : x;
      t.e[j] = c[j - 1] ? t.e[j - 1] : i;
    }
  if (c[0]) {
    t.v[0] = x;
    t.e[0] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_wire_kernel(const float* __restrict__ acc, int B, int E,
                     const int32_t* __restrict__ lengths, float thr, int k,
                     int K, int W, int wide, int32_t* __restrict__ wire) {
  constexpr int kBatch = (80 + G - 1) / G;  // 16-byte loads per lane
  const int lane = threadIdx.x & (G - 1);
  const int b = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (b >= B) return;  // whole groups leave; only group-level sync below
  const unsigned mask = ((1u << G) - 1) << (threadIdx.x & 31 & ~(G - 1));
  const float* a = acc + static_cast<int64_t>(b) * E;
  const float qthr =
      __fmul_rn(static_cast<float>(lengths[b] - (k - 1)), thr);
  int32_t* w = wire + static_cast<int64_t>(b) * W;
  uint16_t* ew = reinterpret_cast<uint16_t*>(w + K);
  auto put = [&](int j, float v, int e) {
    w[j] = __float_as_int(v);
    if (wide)
      w[K + j] = e;
    else
      ew[j] = static_cast<uint16_t>(e);
  };

  int cnt = 0;
  int n = 0;
  if (K <= kLaneTop) {
    LaneTop top;
    top.clear();
    auto one = [&](int e) {  // a scalar load of the head or the tail
      const float x = __ldg(a + e);
      if (x > 0.f) {
        ++cnt;
        top.insert(__fadd_rn(qthr, x), e);
      }
    };
    const int head = min(
        E, static_cast<int>(
               ((16 - (reinterpret_cast<uintptr_t>(a) & 15)) & 15) >> 2));
    for (int e = lane; e < head; e += G) one(e);
    const int n4 = (E - head) >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a + head);
    for (int f0 = 0; f0 < n4; f0 += kBatch * G) {  // uniform over the group
      float sv[4 * kBatch];  // S, or -inf where acc <= 0
      {
        float4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int f = f0 + G * u + lane;
          v[u] = f < n4 ? __ldg(a4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float c4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cnt += c4[j] > 0.f;
            sv[4 * u + j] =
                c4[j] > 0.f ? __fadd_rn(qthr, c4[j]) : -INFINITY;
          }
        }
      }
      float m = -INFINITY;  // the lane's best S of the batch
#pragma unroll
      for (int i = 0; i < 4 * kBatch; ++i) m = fmaxf(m, sv[i]);
      const float bound = group_kth(m, K, mask);
      // the matched values at or above the bound, as bits (load,
      // component), inserted one at a time from one call site (their
      // loads hit L1)
      unsigned long long pass = 0;
#pragma unroll
      for (int i = 0; i < 4 * kBatch; ++i)
        if (sv[i] > -INFINITY && sv[i] >= bound) pass |= 1ull << i;
      while (pass != 0) {
        const int bit = __ffsll(pass) - 1;
        pass &= pass - 1;
        const int e = head + 4 * (f0 + G * (bit >> 2) + lane) + (bit & 3);
        insert_after(top, __fadd_rn(qthr, __ldg(a + e)), e);
      }
    }
    for (int e = head + 4 * n4 + lane; e < E; e += G) one(e);
    n = warp_take<G>(top, K, put, lane, mask);
  } else {
    for (int e = lane; e < E; e += G) cnt += __ldg(a + e) > 0.f;
    n = warp_scan_take<G>(
        E,
        [&](int e) {
          const float x = __ldg(a + e);
          return x > 0.f ? __fadd_rn(qthr, x) : -INFINITY;
        },
        [](int e) { return e; }, [](float v) { return v > -INFINITY; }, K,
        put, lane, mask);
  }
  const int n_matched = __reduce_add_sync(mask, cnt);
  if (lane == 0) {
    for (int j = n; j < K; ++j) {  // slots past |L|: -inf, no edge
      w[j] = __float_as_int(-INFINITY);
      if (wide)
        w[K + j] = -1;
      else
        ew[j] = 0xffff;
    }
    if (!wide && (K & 1)) ew[K] = 0xffff;
    w[W - 1] = n_matched;
  }
}

}  // namespace

extern "C" {

// acc: f32[B, E]; lengths: int32[B]; K = min(keep_at_most, E) <= E;
// wire: int32[B, W].  K, W and wide come from the caller's one
// definition of the wire (kernels.wire_format): W = K + ceil(K/2) + 1,
// or 2K + 1 when wide (E >= 65535).
int rp_finalize_wire(const float* acc, int B, int E, const int32_t* lengths,
                     float thr, int k, int K, int W, int wide,
                     int32_t* wire, cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (B * G + kThreads - 1) / kThreads;
  finalize_wire_kernel<<<blocks, kThreads, 0, stream>>>(
      acc, B, E, lengths, thr, k, K, W, wide, wire);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
