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
//   top_e = where(isfinite(top_s), top_e, -1)
//
// and pack_wire (rappas_tpu/place/engine.py:68).  The all-gather itself is
// a copy outside any kernel (the caller stacks the shards' wires); this
// kernel reads them.  Shard j's wire row for read b holds K_in scores (f32
// bits, -inf = no edge), the K_in global edge ids (u16 pairs, 65535 = none,
// or int32 when wide, -1 = none) and |L| of its edge range.  Candidate c =
// j * K_in + s (the tiled all-gather's column order).  Per read:
//
//   1. the K best candidates by (score desc, c asc): lax.top_k's order,
//      ties to the lower index, so to the lower shard first;
//   2. a pick keeps its score bits; a pick whose score is not finite (-inf:
//      the shard had no edge there) has edge "none";
//   3. |L| = the sum over shards (edges are partitioned, so no edge is
//      counted twice), or -1 when a shard wrote a negative value (P3 could
//      not sort a read there; the host decode rejects it);
//   4. the merged wire in the same form (the host recomputes LWR from it,
//      as for every wire).
//
// What bounds it on an H100: bytes (each shard's wire read once, the merged
// wire written once: a few dozen bytes per read and shard), a few hundred
// KB at the sharded engine's shapes, 0.2 us at 3.35 TB/s -- below a
// launch.  So the time is latency: the launch, one round trip to memory for
// the inputs, the selection, the stores.
//
// Design: a group of kGroup lanes per read, kReads reads per block.  Lane l
// loads candidate c = l (then l + kGroup, ... when M = mp * K_in is more
// than kGroup): its score and edge together, one round trip.  There are
// no K dependent passes: each candidate's rank is the number of candidates
// before it in the total (score desc, c asc) order, counted over the group
// with shuffles, and a candidate of rank < K is pick number rank.  The
// order is total, so the ranks are 0 .. M-1 once each and every slot of the
// output row is written once; nothing assumes a shard's list is sorted.
// Pad candidates (c >= M) carry -inf and come after every real one in the
// order, so they never count.  The picks write the block's output rows into
// shared memory (edges as u16 halves there), and the block copies them out
// as whole words, the rows of its reads being one contiguous run.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int kGroup = 16;                  // lanes per read
constexpr int kThreads = 128;
constexpr int kReads = kThreads / kGroup;   // reads per block

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int32_t* __restrict__ wires, int mp, int B, int K_in,
             int w_in, int K, int w_out, int wide,
             int32_t* __restrict__ out) {
  extern __shared__ int32_t s_out[];  // [kReads, w_out]: the block's rows
  const int b0 = blockIdx.x * kReads;
  const int r = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int b = b0 + r;
  const bool live = b < B;  // a group past B only takes part in shuffles
  const int M = mp * K_in;
  auto row = [&](int j) {
    return wires + (static_cast<int64_t>(j) * B + b) * w_in;
  };
  auto score = [&](int c) {
    if (!live || c >= M) return -INFINITY;
    const int j = c / K_in;
    return __int_as_float(__ldg(row(j) + c - j * K_in));
  };

  // |L|: the group's sum (wrapping, as the int32 cast of an int64 sum),
  // -1 when any shard's is negative
  unsigned nm = 0;
  int failed = 0;
  for (int j = lane; live && j < mp; j += kGroup) {
    const int v = __ldg(row(j) + w_in - 1);
    failed |= v < 0;
    nm += static_cast<unsigned>(v);
  }
#pragma unroll
  for (int off = kGroup / 2; off; off >>= 1) {
    nm += __shfl_xor_sync(kFull, nm, off, kGroup);
    failed |= __shfl_xor_sync(kFull, failed, off, kGroup);
  }

  int32_t* o = s_out + r * w_out;
  uint16_t* ew = reinterpret_cast<uint16_t*>(o + K);
  for (int c0 = 0; c0 < M; c0 += kGroup) {
    const int c = c0 + lane;
    const float v = score(c);
    int e = -1;  // the candidate's edge word (u16 or int32), read with v
    if (live && c < M) {
      const int j = c / K_in;
      const int32_t* src = row(j) + K_in;
      e = wide ? __ldg(src + c - j * K_in)
               : __ldg(reinterpret_cast<const uint16_t*>(src) + c -
                       j * K_in);
    }
    int rank = 0;
    for (int d0 = 0; d0 < M; d0 += kGroup) {
      const float vd = d0 == c0 ? v : score(d0 + lane);
#pragma unroll
      for (int s = 0; s < kGroup; ++s)
        rank += before(__shfl_sync(kFull, vd, s, kGroup), d0 + s, v, c);
    }
    if (live && c < M && rank < K) {
      const bool none = !isfinite(v);
      o[rank] = __float_as_int(v);
      if (wide)
        o[K + rank] = none ? -1 : e;
      else
        ew[rank] = none ? 0xffff : static_cast<uint16_t>(e);
    }
  }
  if (lane == 0) {
    if (!wide && (K & 1)) ew[K] = 0xffff;
    o[w_out - 1] = failed ? -1 : static_cast<int>(nm);
  }
  __syncthreads();
  const int n = min(kReads, B - b0) * w_out;
  int32_t* dst = out + static_cast<int64_t>(b0) * w_out;
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = s_out[i];
}

}  // namespace

extern "C" {

// M1.  wires: int32[mp, B, w_in], shard j's wire of K_in candidates; out:
// int32[B, w_out], the merged wire of K candidates (K <= mp * K_in); wide:
// int32 edge ids in both (the global edge count is >= 65535).  The block's
// output rows take kReads * w_out words of shared memory (past 48 KB, up to
// the card's 227 KB, by the kernel's attribute: K up to about 4,800).
int rp_merge_candidates(const int32_t* wires, int mp, int B, int K_in,
                        int w_in, int K, int w_out, int wide, int32_t* out,
                        cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(int32_t) * kReads * w_out;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_kernel<<<(B + kReads - 1) / kReads, kThreads, smem, stream>>>(
      wires, mp, B, K_in, w_in, K, w_out, wide, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
