// Top-K selection in a warp, or in a group of G lanes of one (G = 8, 16
// or 32), shared by P3/R1 (postings.cu) and K3 (finalize.cu).  Candidates
// are (score, edge) pairs ordered score descending, edge ascending, the
// order of lax.top_k over a row (before()).  Every lane keeps its best
// kLaneTop in registers (LaneTop); K <= kLaneTop rounds of a shuffle-only
// arg-max over the lane heads take the group's best K (warp_take); K past
// kLaneTop takes K rounds that each scan the candidates (warp_scan_take).
// The group's lanes are `mask` (its G lanes of the warp); `lane` is the
// lane's index in its group, and its lane 0 hands the picks to `put`.

#pragma once

#include <cmath>
#include <cstdint>

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneTop = 8;

// (v desc, i asc): true when (v, i) comes before (bv, bi)
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// the group's best (v, i); every lane of the group returns the same pair
template <int G = 32>
__device__ __forceinline__ void warp_best(float& v, int& i,
                                          unsigned mask = kFull) {
#pragma unroll
  for (int off = G / 2; off; off >>= 1) {
    const float ov = __shfl_xor_sync(mask, v, off);
    const int oi = __shfl_xor_sync(mask, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// A lane's best kLaneTop candidates, best first in (score desc, edge asc);
// empty entries hold (-inf, INT_MAX).
struct LaneTop {
  float v[kLaneTop];
  int e[kLaneTop];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kLaneTop; ++j) {
      v[j] = -INFINITY;
      e[j] = 0x7fffffff;
    }
  }
  __device__ __forceinline__ void insert(float x, int i) {
    if (!before(x, i, v[kLaneTop - 1], e[kLaneTop - 1])) return;
    bool done = false;
#pragma unroll
    for (int j = kLaneTop - 1; j > 0; --j) {
      if (!done) {
        if (before(x, i, v[j - 1], e[j - 1])) {
          v[j] = v[j - 1];
          e[j] = e[j - 1];
        } else {
          v[j] = x;
          e[j] = i;
          done = true;
        }
      }
    }
    if (!done) {
      v[0] = x;
      e[0] = i;
    }
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < kLaneTop; ++j) {
      v[j] = v[j + 1];
      e[j] = e[j + 1];
    }
    v[kLaneTop - 1] = -INFINITY;
    e[kLaneTop - 1] = 0x7fffffff;
  }
};

// K rounds of a shuffle-only arg-max over the lane heads (K <= kLaneTop:
// the group's best K are among the lanes' lists); lane 0 calls put(j, v,
// e) for pick j.  Returns the number of picks.
template <int G = 32, class Put>
__device__ int warp_take(LaneTop& top, int K, Put put, int lane,
                         unsigned mask = kFull) {
  int n = 0;
  for (int j = 0; j < K; ++j) {
    float bv = top.v[0];
    int be = top.e[0];
    warp_best<G>(bv, be, mask);
    if (!(bv > -INFINITY)) break;  // uniform: every lane has bv
    if (top.e[0] == be) top.pop();  // the one lane that held it
    if (lane == 0) put(n, bv, be);
    ++n;
  }
  return n;
}

// K scanning rounds (K > kLaneTop): round j takes the best strictly after
// pick j-1 among val(i) (i < n) whose id is id_of(i); `keep(v)` says which
// values are candidates.  Lane 0 hands the picks to put as warp_take does.
template <int G = 32, class Val, class Id, class Keep, class Put>
__device__ int warp_scan_take(int n, Val val, Id id_of, Keep keep, int K,
                              Put put, int lane, unsigned mask = kFull) {
  int m = 0;
  float pv = INFINITY;
  int pe = -1;
  for (int j = 0; j < K; ++j) {
    float bv = -INFINITY;
    int be = 0x7fffffff;
    for (int i = lane; i < n; i += G) {
      const float v = val(i);
      if (!keep(v)) continue;
      const int e = id_of(i);
      if (before(pv, pe, v, e) && before(v, e, bv, be)) {
        bv = v;
        be = e;
      }
    }
    warp_best<G>(bv, be, mask);
    if (!(bv > -INFINITY)) break;
    if (lane == 0) put(m, bv, be);
    ++m;
    pv = bv;
    pe = be;
  }
  return m;
}
