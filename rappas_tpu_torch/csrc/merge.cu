// M1 merge_candidates_wire: the exact global top-K of edge-range shards'
// candidate wires.
//
// Replaces the tail of the shard step of rappas_tpu/parallel/
// postings_sharded.py:192-206 (_step :217, _step_amb :223), after each
// shard's finalize_postings_local:
//
//   nm_tot = psum(nm, "mp")
//   ts_all = all_gather(ts, "mp", axis=1, tiled=True)   (te_all likewise)
//   top_s, ti = lax.top_k(ts_all, K);  top_e = te_all[ti]
//
// and pack_wire (rappas_tpu/place/engine.py:68).  The all-gather itself is
// a copy outside any kernel (the caller stacks the shards' wires); this
// kernel reads them.  Shard j's wire row for read b holds K_in scores (f32
// bits, descending, -inf = no edge), the K_in global edge ids (u16 pairs,
// 65535 = none, or int32 when wide, -1 = none) and |L| of its edge range.
// Candidate c = j * K_in + s (the tiled all-gather's column order).  Per
// read:
//
//   1. the K best candidates by (score desc, c asc): lax.top_k's order,
//      ties to the lower index, so to the lower shard first;
//   2. a -inf pick stays "no edge";
//   3. |L| = the sum over shards (edges are partitioned, so no edge is
//      counted twice), or -1 when a shard wrote -1 (P3 could not sort a
//      read there; the host decode rejects it);
//   4. the merged wire in the same form (the host recomputes LWR from it,
//      as for every wire).
//
// What bounds it on an H100: bytes (each shard's wire read once, the merged
// wire written once: a few dozen bytes per read and shard).  The selection
// is K passes over mp * K_in candidates, a few hundred compares per read.
//
// Design: one thread per read, the K passes in registers: round j takes the
// best candidate strictly after pick j-1 in the (score desc, c asc) order,
// which is total, so no candidate is taken twice and -inf candidates follow
// in index order.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// (v desc, i asc): true when (v, i) comes before (bv, bi)
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int32_t* __restrict__ wires, int mp, int B, int K_in,
             int w_in, int K, int w_out, int wide,
             int32_t* __restrict__ out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int M = mp * K_in;
  auto row = [&](int j) {
    return wires + (static_cast<int64_t>(j) * B + b) * w_in;
  };

  int nm = 0;
  bool failed = false;
  for (int j = 0; j < mp; ++j) {
    const int v = __ldg(row(j) + w_in - 1);
    failed |= v < 0;
    nm += v;
  }

  int32_t* o = out + static_cast<int64_t>(b) * w_out;
  uint16_t* ew = reinterpret_cast<uint16_t*>(o + K);
  float pv = INFINITY;
  int pi = -1;
  for (int s = 0; s < K; ++s) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = 0; c < M; ++c) {
      const float v = __int_as_float(__ldg(row(c / K_in) + c % K_in));
      if (before(pv, pi, v, c) && before(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    int e = -1;
    if (bi != INT_MAX && bv > -INFINITY) {
      const int32_t* r = row(bi / K_in);
      const int t = bi % K_in;
      if (wide) {
        e = __ldg(r + K_in + t);
      } else {
        const uint16_t u = reinterpret_cast<const uint16_t*>(r + K_in)[t];
        e = u == 0xffff ? -1 : static_cast<int>(u);
      }
    }
    const bool ok = e >= 0;
    o[s] = __float_as_int(ok ? bv : -INFINITY);
    if (wide)
      o[K + s] = ok ? e : -1;
    else
      ew[s] = ok ? static_cast<uint16_t>(e) : 0xffff;
    pv = bv;
    pi = bi;
  }
  if (!wide && (K & 1)) ew[K] = 0xffff;
  o[w_out - 1] = failed ? -1 : nm;
}

}  // namespace

extern "C" {

// M1.  wires: int32[mp, B, w_in], shard j's wire of K_in candidates; out:
// int32[B, w_out], the merged wire of K candidates (K <= mp * K_in); wide:
// int32 edge ids in both (the global edge count is >= 65535).
int rp_merge_candidates(const int32_t* wires, int mp, int B, int K_in,
                        int w_in, int K, int w_out, int wide, int32_t* out,
                        cudaStream_t stream) {
  if (B > 0)
    merge_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        wires, mp, B, K_in, w_in, K, w_out, wide, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
