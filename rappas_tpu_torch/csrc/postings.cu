// P1 dense_side and P3 finalize_postings_wire: the postings layout's dense
// side and its per-read scoring, top-K and wire; R1, P3's instances on a
// height-split light table, and G1 gather_compact.
//
// P1 replaces (rappas_tpu/place/engine.py) gather_rows (:484) + the dense
// scatter of finalize_postings_local (:773-780):
//
//   acc_c[s, e] = sum_{i in hoff[s] .. hoff[s+1]} H[hrows[i], e]
//
// H is the heavy dense table f32[nh + 1, E] (last row zero).  The host
// emits heavy hits grouped by read (row-major np.nonzero) and gives each
// read with dense content one slot, so a slot's sources are one CSR range.
// One block per slot sums its sources in order, in registers, and writes
// the whole row: deterministic (no atomics), and acc_c needs no zeroing.
// What bounds it on an H100: bytes (each source row read once, each slot
// row written once).
//
// P3 replaces light_gather (single part, :654-672) + the rest of
// finalize_postings_local (:684-904) + pack_wire (:68).  For read b with
// light rows lrows[b, :W] (rows of pairs[nl + 1, 2P]: P edge ids, then P
// bit-cast f32 deltas; pads carry LIGHT_PAD_EDGE; row `miss` is all pads)
// and dense row acc_c[slot_of[b]] (none when slot_of[b] < 0):
//
//   1. gather the read's real (edge, delta) postings;
//   2. sort them by (edge, delta bits): one 64-bit key each, so the order
//      is canonical whatever the gather order, and pads never enter;
//   3. sum each edge's segment directly (ascending deltas);
//   4. light total = segment sum + acc_c[slot, e] (0 without a slot);
//   5. top-K light totals, (score desc, edge asc);
//   6. top-K of the dense row where it is > 0, (score desc, edge asc);
//   7. merge: ties put light before dense (JAX's stable argsort over
//      [light tops, dense tops]); a dense pick whose edge is a light pick
//      is the later duplicate and drops; keep K;
//   8. |L| = #(acc_c row > 0) + #(light edges whose dense value is <= 0);
//   9. S = Q * thr + total with __fmul_rn/__fadd_rn (as K3);
//  10. the wire: K scores, the K edge ids as u16 pairs (65535 = none) or,
//      when E >= 65535, as K int32 (-1 = none), then |L|.
//
// Under edge-range sharding (rappas_tpu/parallel/postings_sharded.py:188,
// finalize_postings_local's edge_offset, :739-741, :840-868) one launch
// scores one shard: acc_c holds the columns offset .. offset + E - 1, the
// dense value at light edge e is acc_c[slot, e - offset], and dense picks
// are emitted as column + offset, so the wire carries global edge ids (its
// wide form is chosen by the caller from the global edge count).  Offset 0
// is the single-device launch.
//
// Membership is exact: a light edge counts when it has a real posting,
// never because its sum is > 0 (a DELTA_TINY posting stays a member).
// JAX forms segment sums as cumsum - cummax(start), with an error of about
// one ulp of the running total (:732-737); the direct sums here are at
// least as exact, so the two agree within that bound.
//
// What bounds it on an H100: bytes (the gathered light rows, each read
// once, and the dense rows of the reads that have a slot).  The sort and
// the K arg-max rounds are a few dozen block barriers per read.
//
// Design: one block of 256 threads per read.  The sort region lives in
// dynamic shared memory, sized per launch for the largest read the host's
// plan keeps there; a read whose postings exceed one block's shared memory
// gets a region of a global scratch buffer instead (scratch_off[b] ..
// scratch_off[b + 1]) and runs the same code there.  Gather positions come
// from a shared atomic counter: the sort by full key makes the result
// independent of that order.  A read with more postings than its region
// writes |L| = -1, which the host decode rejects.
//
// R1: P3 with another row source for step 1 (as K4 and P2 share one
// template in ambiguous.cu), on a light table height-split into parts
// (parts.cuh); every later step, and so the wire, is P3's:
//   finalize_postings_wire_routed replaces routed_light_gather (:609) +
//     finalize_postings_routed (:632): each part's [B, W] part-local rows,
//     pads >= the part's height;
//   finalize_postings_wire_parts replaces light_gather over N parts
//     (:654-681) + finalize_postings_v2 with uniq_rows=None (:535), the
//     select fallback: global rows, each read from its own part.
// Because step 2 sorts by the full (edge, delta bits) key, a read's wire is
// the same bits whichever source gathered its postings and in whatever
// order: routed, select, the two-stage compact table (P3 itself, on G1's
// output) and one table agree bitwise.  What bounds R1: as P3.
//
// G1 gather_compact replaces _gather_compact / gather_compact (:557-570):
// the batch-unique compact table of the two-stage and pipelined paths,
//
//   out[u, :] = part_p[uniq[u], :]   for uniq_off[p] <= u < uniq_off[p+1]
//
// each unique row fetched from its own part only (a single slow table is
// one part).  A plain row copy: one thread per output word, neighbouring
// threads on neighbouring words of a row.  What bounds it: bytes (each
// unique row read once and written once).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "parts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPadEdge = 0x7fffffffu;  // db.LIGHT_PAD_EDGE
constexpr uint64_t kEmpty = ~0ull;          // sort padding, past any key

__global__ void __launch_bounds__(kThreads)
dense_side_kernel(const float* __restrict__ H, int E,
                  const int32_t* __restrict__ hrows,
                  const int32_t* __restrict__ hoff,
                  float* __restrict__ acc_c) {
  const int s = blockIdx.x;
  const int lo = hoff[s];
  const int hi = hoff[s + 1];
  float* out = acc_c + static_cast<int64_t>(s) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float a = 0.f;
    for (int i = lo; i < hi; ++i)
      a += __ldg(H + static_cast<int64_t>(hrows[i]) * E + e);
    out[e] = a;
  }
}

// (v desc, i asc): true when (v, i) comes before (bv, bi)
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// block-wide best (v, i); every thread returns the same pair
__device__ void block_best(float& v, int& i, float* red_v, int* red_i) {
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  __syncthreads();  // the previous call's readers are done
  if ((threadIdx.x & 31) == 0) {
    red_v[threadIdx.x >> 5] = v;
    red_i[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  for (int w = 1; w < kWarps; ++w)
    if (before(red_v[w], red_i[w], v, i)) {
      v = red_v[w];
      i = red_i[w];
    }
}

// Where P3 finds read b's light postings: width() slots per read, slot s
// holding one light row of 2P words (P edge ids, then P bit-cast deltas),
// or none (null).
//
// P3: rows of one light table; row `miss` (all pads) holds none.
struct OneTable {
  const int32_t* pairs;
  int P, miss;
  const int32_t* lrows;  // [B, W]
  int W;
  __device__ int width() const { return W; }
  __device__ const int32_t* row(int b, int s) const {
    const int r = lrows[static_cast<int64_t>(b) * W + s];
    return r == miss ? nullptr : pairs + static_cast<int64_t>(r) * 2 * P;
  }
};

// R1, the select fallback: global rows of a split light table, each in the
// part that JAX's light_gather selects (clipped into it, as there); the
// global miss row `miss` (nl, the last part's last row) holds none.
struct PartRows {
  Parts parts;
  int P, miss;
  const int32_t* lrows;  // [B, W]
  int W;
  __device__ int width() const { return W; }
  __device__ const int32_t* row(int b, int s) const {
    const int r = lrows[static_cast<int64_t>(b) * W + s];
    if (r == miss) return nullptr;
    const int p = parts.part_of(r);
    const int64_t local = clip(r - parts.first(p), parts.height(p) - 1);
    return static_cast<const int32_t*>(parts.base(p)) + local * 2 * P;
  }
};

// R1, routed: part p's part-LOCAL rows of read b at routed[p, b, :W]; a pad
// slot (>= the part's height) holds none.  Slot s is part s / W's window
// s % W: the windows come part-major, which the sort makes irrelevant.
struct RoutedRows {
  Parts parts;
  int P;
  const int32_t* routed;  // [n, B, W]
  int B, W;
  __device__ int width() const { return parts.n * W; }
  __device__ const int32_t* row(int b, int s) const {
    const int p = s / W;
    const int r = routed[(static_cast<int64_t>(p) * B + b) * W + s % W];
    if (r >= parts.height(p)) return nullptr;
    return static_cast<const int32_t*>(parts.base(p)) +
           static_cast<int64_t>(r) * 2 * P;
  }
};

template <class Rows>
__global__ void __launch_bounds__(kThreads)
finalize_postings_kernel(Rows rows, int P,
                         const float* __restrict__ acc_c, int E,
                         const int32_t* __restrict__ slot_of,
                         const int32_t* __restrict__ lengths, float thr,
                         int k, int K, int cap,
                         const int64_t* __restrict__ scratch_off,
                         uint64_t* __restrict__ scratch_keys,
                         float* __restrict__ scratch_tot, int wire_w,
                         int wide, int offset, int32_t* __restrict__ wire) {
  extern __shared__ uint64_t smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_n;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  int32_t* w = wire + static_cast<int64_t>(b) * wire_w;

  // sort region: shared memory, or this read's slice of the scratch
  uint64_t* keys = smem;
  float* tot = reinterpret_cast<float*>(smem + cap);
  float* cand_v = tot + cap;           // [2K]: light picks, dense picks
  int* cand_e = reinterpret_cast<int*>(cand_v + 2 * K);
  int64_t region = cap;
  if (scratch_off != nullptr && scratch_off[b + 1] > scratch_off[b]) {
    keys = scratch_keys + scratch_off[b];
    tot = scratch_tot + scratch_off[b];
    region = scratch_off[b + 1] - scratch_off[b];
  }

  // 1. gather the real postings
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int j = tid; j < rows.width() * P; j += kThreads) {
    const int32_t* row = rows.row(b, j / P);
    if (row == nullptr) continue;
    const uint32_t e = static_cast<uint32_t>(__ldg(row + j % P));
    if (e == kPadEdge) continue;
    const uint32_t d = static_cast<uint32_t>(__ldg(row + P + j % P));
    const int pos = atomicAdd(&s_n, 1);
    if (pos < region) keys[pos] = (static_cast<uint64_t>(e) << 32) | d;
  }
  __syncthreads();
  const int n = s_n;
  int n_sort = n > 0 ? 1 : 0;
  while (n_sort < n) n_sort <<= 1;
  if (n_sort > region) {  // the host's plan was wrong for this read
    if (tid == 0) w[wire_w - 1] = -1;
    return;
  }

  // 2. bitonic sort of keys[0 .. n_sort), ascending
  for (int i = n + tid; i < n_sort; i += kThreads) keys[i] = kEmpty;
  __syncthreads();
  for (int size = 2; size <= n_sort; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n_sort / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = keys[lo];
        const uint64_t c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // 3-4. segment sums at segment starts, plus the dense value there
  const int slot = slot_of[b];
  const float* arow =
      slot >= 0 ? acc_c + static_cast<int64_t>(slot) * E : nullptr;
  int n_light_only = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    bool only = false;
    if (i < n) {
      const uint32_t e = static_cast<uint32_t>(keys[i] >> 32);
      float t = -INFINITY;
      if (i == 0 || static_cast<uint32_t>(keys[i - 1] >> 32) != e) {
        float s = 0.f;
        for (int j = i; j < n && static_cast<uint32_t>(keys[j] >> 32) == e;
             ++j)
          s += __uint_as_float(static_cast<uint32_t>(keys[j]));
        const uint32_t col = e - static_cast<uint32_t>(offset);
        const float da = (arow != nullptr && col < static_cast<uint32_t>(E))
                             ? arow[col]
                             : 0.f;
        t = __fadd_rn(s, da);
        only = !(da > 0.f);
      }
      tot[i] = t;
    }
    n_light_only += __syncthreads_count(only);
  }
  __syncthreads();

  // 5. top-K light totals: round j takes the best strictly after pick j-1
  int n_l = 0;
  {
    float pv = INFINITY;
    int pe = -1;
    for (int j = 0; j < K; ++j) {
      float bv = -INFINITY;
      int be = 0x7fffffff;
      for (int i = tid; i < n; i += kThreads) {
        const float v = tot[i];
        if (!(v > -INFINITY)) continue;
        const int e = static_cast<int>(keys[i] >> 32);
        if (before(pv, pe, v, e) && before(v, e, bv, be)) {
          bv = v;
          be = e;
        }
      }
      block_best(bv, be, red_v, red_i);
      if (!(bv > -INFINITY)) break;  // uniform: every thread has bv
      if (tid == 0) {
        cand_v[n_l] = bv;
        cand_e[n_l] = be;
      }
      ++n_l;
      pv = bv;
      pe = be;
    }
  }

  // 6. top-K of the dense row where it is > 0, and its count
  int n_d = 0;
  int n_dense = 0;
  if (arow != nullptr) {
    for (int base = 0; base < E; base += kThreads) {
      const int e = base + tid;
      n_dense += __syncthreads_count(e < E && arow[e] > 0.f);
    }
    float pv = INFINITY;
    int pe = -1;
    for (int j = 0; j < K; ++j) {
      float bv = -INFINITY;
      int be = 0x7fffffff;
      for (int e = tid; e < E; e += kThreads) {
        const float v = arow[e];
        if (!(v > 0.f)) continue;
        if (before(pv, pe, v, e) && before(v, e, bv, be)) {
          bv = v;
          be = e;
        }
      }
      block_best(bv, be, red_v, red_i);
      if (!(bv > -INFINITY)) break;
      if (tid == 0) {
        cand_v[K + n_d] = bv;
        cand_e[K + n_d] = be + offset;  // column -> global edge id
      }
      ++n_d;
      pv = bv;
      pe = be;
    }
  }
  __syncthreads();

  // 7, 9, 10. merge, score and write the wire (one thread: 2K entries)
  if (tid == 0) {
    const float qthr =
        __fmul_rn(static_cast<float>(lengths[b] - (k - 1)), thr);
    uint16_t* ew = reinterpret_cast<uint16_t*>(w + K);
    int il = 0;
    int id = 0;
    for (int j = 0; j < K; ++j) {
      for (; id < n_d; ++id) {  // skip dense picks that are light picks
        bool dup = false;
        for (int x = 0; x < n_l; ++x) dup |= cand_e[x] == cand_e[K + id];
        if (!dup) break;
      }
      float v = -INFINITY;
      int e = -1;
      if (il < n_l && (id >= n_d || cand_v[il] >= cand_v[K + id])) {
        v = cand_v[il];
        e = cand_e[il++];
      } else if (id < n_d) {
        v = cand_v[K + id];
        e = cand_e[K + id++];
      }
      const bool ok = e >= 0;
      w[j] = __float_as_int(ok ? __fadd_rn(qthr, v) : -INFINITY);
      if (wide)
        w[K + j] = ok ? e : -1;
      else
        ew[j] = ok ? static_cast<uint16_t>(e) : 0xffff;
    }
    if (!wide && (K & 1)) ew[K] = 0xffff;
    w[wire_w - 1] = n_dense + n_light_only;  // 8.
  }
}

__global__ void gather_compact_kernel(Parts parts, int w,
                                      const int32_t* __restrict__ uniq,
                                      const int32_t* __restrict__ uniq_off,
                                      int U, int32_t* __restrict__ out) {
  const int64_t total = static_cast<int64_t>(U) * w;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int u = static_cast<int>(i / w);
    int p = parts.n - 1;
    while (p > 0 && u < uniq_off[p]) --p;
    const int32_t* part = static_cast<const int32_t*>(parts.base(p));
    out[i] = __ldg(part + static_cast<int64_t>(uniq[u]) * w + i % w);
  }
}

// one P3 launch of B blocks with the row source `rows`
template <class Rows>
int launch_p3(Rows rows, int P, int B, const float* acc_c, int E,
              const int32_t* slot_of, const int32_t* lengths, float thr,
              int k, int K, int cap, const int64_t* scratch_off,
              uint64_t* scratch_keys, float* scratch_tot, int wire_w,
              int wide, int offset, int32_t* wire, cudaStream_t stream) {
  // keys (8 B) and totals (4 B) per sort slot, 2K candidate (score, edge)
  const size_t smem =
      static_cast<size_t>(cap) * 12 + static_cast<size_t>(K) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        finalize_postings_kernel<Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0)
    finalize_postings_kernel<Rows><<<B, kThreads, smem, stream>>>(
        rows, P, acc_c, E, slot_of, lengths, thr, k, K, cap, scratch_off,
        scratch_keys, scratch_tot, wire_w, wide, offset, wire);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// P1.  H: f32[nh + 1, E]; hrows: int32[n_h] heavy rows grouped by slot;
// hoff: int32[n_slots + 1] CSR offsets; acc_c: f32[n_slots, E], written.
int rp_dense_side(const float* H, int E, const int32_t* hrows,
                  const int32_t* hoff, int n_slots, float* acc_c,
                  cudaStream_t stream) {
  if (n_slots > 0)
    dense_side_kernel<<<n_slots, kThreads, 0, stream>>>(H, E, hrows, hoff,
                                                        acc_c);
  return static_cast<int>(cudaGetLastError());
}

// P3.  pairs: int32[R, 2P] (row miss all pads, skipped; -1: none); lrows:
// int32[B, W]; acc_c: f32[n_slots, E]; slot_of: int32[B] (-1: no slot);
// lengths: int32[B]; cap: sort slots in shared memory (a power of two);
// scratch_off: int64[B + 1] offsets into scratch_keys/scratch_tot (an
// empty range keeps read b in shared memory) or null; wire: int32[B,
// wire_w], K, wire_w and wide as the caller's kernels.wire_format gives
// them (as K3's; K at most E, wide from the global edge count); offset:
// the global edge id of acc_c's column 0.
int rp_finalize_postings(const int32_t* pairs, int P, int miss,
                         const int32_t* lrows, int B, int W,
                         const float* acc_c, int E, const int32_t* slot_of,
                         const int32_t* lengths, float thr, int k, int K,
                         int cap, const int64_t* scratch_off,
                         uint64_t* scratch_keys, float* scratch_tot,
                         int wire_w, int wide, int offset, int32_t* wire,
                         cudaStream_t stream) {
  return launch_p3(OneTable{pairs, P, miss, lrows, W}, P, B, acc_c, E,
                   slot_of, lengths, thr, k, K, cap, scratch_off,
                   scratch_keys, scratch_tot, wire_w, wide, offset, wire,
                   stream);
}

// R1.  meta: int64[3, n] (parts.cuh) of the light parts, each int32[H_i,
// 2P]; routed = 1: rows int32[n, B, W] part-local rows (pads >= H_i),
// miss unused; routed = 0: rows int32[B, W] global rows, miss the global
// miss row (or -1).  The rest as P3's.
int rp_finalize_postings_split(int routed, const int64_t* meta, int n, int P,
                               int miss, const int32_t* rows, int B, int W,
                               const float* acc_c, int E,
                               const int32_t* slot_of, const int32_t* lengths,
                               float thr, int k, int K, int cap,
                               const int64_t* scratch_off,
                               uint64_t* scratch_keys, float* scratch_tot,
                               int wire_w, int wide, int offset,
                               int32_t* wire, cudaStream_t stream) {
  const Parts parts{meta, n};
  if (routed)
    return launch_p3(RoutedRows{parts, P, rows, B, W}, P, B, acc_c, E,
                     slot_of, lengths, thr, k, K, cap, scratch_off,
                     scratch_keys, scratch_tot, wire_w, wide, offset, wire,
                     stream);
  return launch_p3(PartRows{parts, P, miss, rows, W}, P, B, acc_c, E, slot_of,
                   lengths, thr, k, K, cap, scratch_off, scratch_keys,
                   scratch_tot, wire_w, wide, offset, wire, stream);
}

// G1.  meta: int64[3, n] of the light parts, rows of w = 2P int32 words;
// uniq: int32[U] part-local rows, part p's at uniq_off[p] .. uniq_off[p+1]
// (uniq_off: int32[n + 1]); out: int32[U, w], written.
int rp_gather_compact(const int64_t* meta, int n, int w, const int32_t* uniq,
                      const int32_t* uniq_off, int U, int32_t* out,
                      cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(U) * w;
  if (total > 0) {
    const int64_t blocks = (total + 255) / 256;
    gather_compact_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                            256, 0, stream>>>(Parts{meta, n}, w, uniq,
                                              uniq_off, U, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
