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
// What bounds it on an H100: bytes (each distinct source row read once,
// each slot row written once).  Config 5's batch of 8,192 reads has 2,497
// slots of 1.3 sources on average (at most 5) over 1,781 distinct rows of
// 7,999 columns.  The first design, a 256-thread block per slot, a thread
// per column stride, one scalar load per source and column and the CSR
// range re-read per column, kept few bytes in flight.
//
// Design: a warp per (column tile, slot), warps ordered tile-major, so
// that the warps in flight together read the same columns of the batch's
// rows and a row that recurs across slots comes from L2.  Each lane adds
// the slot's sources in CSR order from 0 into 16 sums in registers: the
// plain in-order f32 sums bitwise, no atomics, acc_c needs no zeroing,
// and a slot without sources writes a zero row.  The row ids are staged
// in registers 32 at a time and broadcast by shuffles.  Per source a lane
// issues kQuads 16-byte loads together before adding them: with slots of
// one or two sources the bytes in flight come from columns, not sources.
// A tile is kQuads groups of 31 output quads of the slot's row (the
// aligned 16 bytes at columns 4q - osh .., osh = the output row's word
// offset from a 16-byte boundary); lane l owns quad 31 (kQuads tile + g)
// + l of group g, and lane 31 only loads.  A source row starts at word
// offset sh (3r mod 4 for row r at E = 7,999), so a lane loads the aligned
// quad that holds its first column and takes the rest from lane + 1's
// quad by shuffles (d = (sh - osh) mod 4 words; none when d = 0).  A quad
// is loaded only where it holds a word of the row: an aligned 16 bytes
// with one valid word never crosses a page.
// Measured on the card and dropped (PERF.md): 4-byte loads (a little
// slower), L2 evict_last on H (about 2% faster on config 5, but it would
// hold up to 57 MB of heavy rows over the light table that the next
// kernels read), and two sources in flight per lane (registers).
// Staging each source row through shared memory instead would add a
// shared store, a shared load and a barrier to the same global loads.
//
// P3 replaces light_gather (single part, :654-672) + the rest of
// finalize_postings_local (:684-904) + pack_wire (:68).  For read b with
// light rows lrows[b, :W] (rows of pairs[nl + 1, w] as light.cuh lays
// them out: P edge ids, u16 below 65,535 edge slots and int32 at or above
// (a template argument of every instance), then P bit-cast f32 deltas;
// row `miss` is all pads) and dense row acc_c[slot_of[b]] (none when
// slot_of[b] < 0):
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
// What bounds it on an H100: barriers and scans, not bytes.  The bytes
// (the gathered light rows, each read once, 6 B a posting with u16 ids
// and 8 B with int32 ones, and the dense rows of the
// reads that have a slot) take about 0.03 ms for 8,192 config-5 reads
// (about 308 real postings each, at most 663).  A design of one 256-thread
// block per read pays per read a shared atomic per posting, a bitonic sort
// with a block barrier per stage (45 stages at 512 keys), K rounds of a
// block-wide arg-max (2 barriers each) and K + 1 scans of the 7,999-column
// dense row: each slot row read 8 times, about 1 GB per batch.
//
// Design: a warp per read for the reads the host's plan keeps on chip
// (kernels.postings_plan: at most WARP_PAIRS = kWarpMaxPairs postings),
// blocks of one or two warps, each with its own shared-memory region (so
// no warp waits long for a slower read of its block):
//   * the gather walks the read's row slots, a lane per light row (16-byte
//     loads of its edge ids, 8 u16 or 4 int32 a load, and its deltas
//     where aligned), and compacts
//     the real postings with a warp prefix sum of the lanes' counts: no
//     shared atomic;
//   * the same canonical sort of the 64-bit (edge, delta bits) keys, a
//     bitonic network with no block barrier: strides below
//     32 in registers through warp shuffles (sizes 2 .. 32 in one pass
//     over the keys, then one pass per larger size), strides of 32 and
//     more in shared memory, __syncwarp between stages -- a third of the
//     shared-memory passes of the block design's sort;
//   * each edge's segment is summed directly from its start, in ascending
//     order (the bits of the block design);
//   * top-K in one pass each: every lane keeps its best kLaneTop light
//     totals (and then its best dense values) in registers, and K rounds
//     of a shuffle-only arg-max over the lane heads, ordered (score desc,
//     edge asc) as before() orders them, take the picks; the dense slot
//     row is read once, 16 bytes a load, its count of entries > 0 taken in
//     the same pass.  K beyond kLaneTop takes K scanning rounds instead
//     (the picks are the same);
//   * the merge, |L| and the wire are the block design's (write_wire).
// A read with more postings than its region writes |L| = -1 there.  The
// reads past WARP_PAIRS keep the block design below, in a second launch
// over the plan's list of them (block_reads), after the warp launch: the
// sort region lives in dynamic shared memory, sized per launch for the
// largest such read, or, for a read whose postings exceed one block's
// shared memory, in its region of a global scratch buffer (scratch_off[b]
// .. scratch_off[b + 1], as many slots as the read has postings: the
// network skips the comparators past them, so no pad is stored); gather
// positions come from a shared atomic counter, which the sort by full key
// makes irrelevant.  The warp launch
// writes |L| = -1 for those reads and the block launch overwrites it, so
// a read that the plan misplaced stays rejected by the host decode.
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
// one part).  What bounds it: bytes (each unique row read once, at random,
// and written once, in order).  Design: rows, not words.  A block is
// kGatherThreads threads in (lanes x rows) -- one lane per load of a row,
// 16-byte loads where the row's w words allow it, else 8 or 4 bytes
// (chosen from w at launch; a copy is the same whatever the edge ids'
// width) -- and each thread first finds its kRowsInFlight
// rows' parts and source addresses, then issues all their loads before
// any store.  A row's part is a binary search over uniq_off
// staged in shared memory with the part bases (at most kMaxParts parts;
// empty runs take no row).  The stores are normal ones: P3 reads the table
// right after (on the other stream in the pipelined path), so it should
// stay in L2.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "light.cuh"
#include "parts.cuh"
#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kPadEdge = 0x7fffffffu;  // past any edge id
constexpr uint64_t kEmpty = ~0ull;          // sort padding, past any key

// the warp path: the largest region a read may take (kernels.WARP_PAIRS),
// reads (warps) per block at most, and an SM's shared memory
constexpr int kWarpMaxPairs = 1024;
constexpr int kMaxWarpReads = 2;
constexpr size_t kSmemPerSM = 228 * 1024;

// P1: the 16-byte quads of a source row a lane loads
constexpr int kQuads = 4;

// four row words from a quad a and the next quad b, starting at word d of
// a (d is the same in every lane), added in order into s
__device__ __forceinline__ void add_shifted(float* s, float4 a, float4 b,
                                            int d) {
  float w[4];
  switch (d) {
    case 0: w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; break;
    case 1: w[0] = a.y; w[1] = a.z; w[2] = a.w; w[3] = b.x; break;
    case 2: w[0] = a.z; w[1] = a.w; w[2] = b.x; w[3] = b.y; break;
    default: w[0] = a.w; w[1] = b.x; w[2] = b.y; w[3] = b.z; break;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) s[t] += w[t];
}

__global__ void __launch_bounds__(kThreads)
dense_side_kernel(const float* __restrict__ H, int E,
                  const int32_t* __restrict__ hrows,
                  const int32_t* __restrict__ hoff, int n_slots, int tiles,
                  float* __restrict__ acc_c) {
  constexpr int kSums = 4 * kQuads;
  const int64_t wid =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (wid >= static_cast<int64_t>(n_slots) * tiles) return;  // whole warps
  const int s = static_cast<int>(wid % n_slots);
  const int tile = static_cast<int>(wid / n_slots);
  const int lane = threadIdx.x & 31;
  const int lo = hoff[s];
  const int hi = hoff[s + 1];
  float* out = acc_c + static_cast<int64_t>(s) * E;
  float sum[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) sum[t] = 0.f;
  const int osh =
      static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  const int q0 = 31 * kQuads * tile + lane;  // the quad of group 0
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int mine = i0 + lane < hi ? __ldg(hrows + i0 + lane) : 0;
    const int n = min(32, hi - i0);
    for (int u = 0; u < n; ++u) {  // the sources in CSR order
      const float* row =
          H + static_cast<int64_t>(__shfl_sync(kFull, mine, u)) * E;
      const int sh =
          static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
      const int d = (sh - osh) & 3;
      const float4* base = reinterpret_cast<const float4*>(row - sh);
      float4 x[kQuads];
#pragma unroll
      for (int g = 0; g < kQuads; ++g) {
        const int qi = q0 + 31 * g - (sh < osh);
        x[g] = qi >= 0 && 4 * qi < E + sh ? __ldg(base + qi)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < kQuads; ++g) {
        float4 nx = x[g];
        if (d != 0) {  // uniform
          nx.x = __shfl_down_sync(kFull, nx.x, 1);
          nx.y = __shfl_down_sync(kFull, nx.y, 1);
          nx.z = __shfl_down_sync(kFull, nx.z, 1);
          nx.w = __shfl_down_sync(kFull, nx.w, 1);
        }
        add_shifted(sum + 4 * g, x[g], nx, d);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kQuads; ++g) {
    const int q = q0 + 31 * g;
    const int c = 4 * q - osh;  // the column of the quad's word 0
    const float* v = sum + 4 * g;
    if (lane < 31 && c >= 0 && c + 4 <= E) {
      reinterpret_cast<float4*>(out - osh)[q] =
          make_float4(v[0], v[1], v[2], v[3]);
    } else if (lane < 31) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (c + t >= 0 && c + t < E) out[c + t] = v[t];
    }
  }
}

// block-wide best (v, i); every thread returns the same pair
__device__ void block_best(float& v, int& i, float* red_v, int* red_i) {
  warp_best(v, i);
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
// holding one light row of w words (light.cuh: P edge ids, then P
// bit-cast deltas), or none (null).
//
// P3: rows of one light table; row `miss` (all pads) holds none.
struct OneTable {
  const int32_t* pairs;
  int w, miss;
  const int32_t* lrows;  // [B, W]
  int W;
  __device__ int width() const { return W; }
  __device__ const int32_t* row(int b, int s) const {
    const int r = lrows[static_cast<int64_t>(b) * W + s];
    return r == miss ? nullptr : pairs + static_cast<int64_t>(r) * w;
  }
};

// R1, the select fallback: global rows of a split light table, each in the
// part that JAX's light_gather selects (clipped into it, as there); the
// global miss row `miss` (nl, the last part's last row) holds none.
struct PartRows {
  Parts parts;
  int w, miss;
  const int32_t* lrows;  // [B, W]
  int W;
  __device__ int width() const { return W; }
  __device__ const int32_t* row(int b, int s) const {
    const int r = lrows[static_cast<int64_t>(b) * W + s];
    if (r == miss) return nullptr;
    const int p = parts.part_of(r);
    const int64_t local = clip(r - parts.first(p), parts.height(p) - 1);
    return static_cast<const int32_t*>(parts.base(p)) + local * w;
  }
};

// R1, routed: part p's part-LOCAL rows of read b at routed[p, b, :W]; a pad
// slot (>= the part's height) holds none.  Slot s is part s / W's window
// s % W: the windows come part-major, which the sort makes irrelevant.
struct RoutedRows {
  Parts parts;
  int w;
  const int32_t* routed;  // [n, B, W]
  int B, W;
  __device__ int width() const { return parts.n * W; }
  __device__ const int32_t* row(int b, int s) const {
    const int p = s / W;
    const int r = routed[(static_cast<int64_t>(p) * B + b) * W + s % W];
    if (r >= parts.height(p)) return nullptr;
    return static_cast<const int32_t*>(parts.base(p)) +
           static_cast<int64_t>(r) * w;
  }
};

// 7, 9, 10: merge the n_l light picks cand_v/e[0 ..) and the n_d dense
// picks cand_v/e[K ..), score and write read b's wire (one thread: 2K
// entries); 8: |L| = n_matched
__device__ void write_wire(int32_t* w, const float* cand_v, const int* cand_e,
                           int n_l, int n_d, int K, float qthr, int wide,
                           int wire_w, int n_matched) {
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
  w[wire_w - 1] = n_matched;
}

// the block path: one block per read of the list `reads` (null: read
// blockIdx.x)
template <class Rows, bool Narrow>
__global__ void __launch_bounds__(kThreads)
finalize_postings_kernel(Rows rows, int P,
                         const float* __restrict__ acc_c, int E,
                         const int32_t* __restrict__ slot_of,
                         const int32_t* __restrict__ lengths, float thr,
                         int k, int K, int cap,
                         const int64_t* __restrict__ scratch_off,
                         uint64_t* __restrict__ scratch_keys,
                         float* __restrict__ scratch_tot,
                         const int32_t* __restrict__ reads, int wire_w,
                         int wide, int offset, int32_t* __restrict__ wire) {
  extern __shared__ uint64_t smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_n;
  const int b = reads != nullptr ? reads[blockIdx.x] : blockIdx.x;
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
  using L = LightRow<Narrow>;
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int j = tid; j < rows.width() * P; j += kThreads) {
    const int32_t* row = rows.row(b, j / P);
    if (row == nullptr) continue;
    const uint32_t e = L::edge(row, j % P);
    if (e == L::kPad) continue;
    const uint32_t d = L::delta(row, P, j % P);
    const int pos = atomicAdd(&s_n, 1);
    if (pos < region) keys[pos] = (static_cast<uint64_t>(e) << 32) | d;
  }
  __syncthreads();
  const int n = s_n;
  if (n > region) {  // the host's plan was wrong for this read
    if (tid == 0) w[wire_w - 1] = -1;
    return;
  }
  int n_sort = n > 0 ? 1 : 0;
  while (n_sort < n) n_sort <<= 1;

  // 2. sort keys[0 .. n) ascending: the bitonic network of n_sort keys in
  // the form whose every comparator puts the smaller key at the lower
  // index (a merge's first step pairs each key with its mirror in the
  // block).  The n_sort - n keys past n would all be kEmpty, and no such
  // comparator moves a kEmpty down or anything else up past n, so the
  // comparators that reach past n are skipped and those keys never exist:
  // a read's region holds its n postings, not n_sort.  Comparator t's
  // lower key grows with t, so each step stops at the first t past the
  // last comparator below n: the end of the size-block that holds key
  // n - 1 (a first step), or the last lower key below n - stride
  for (int size = 2; size <= n_sort; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int m = n - stride;  // >= 1: stride < n
      const int t_end = 2 * stride == size
                            ? (n + size - 1) / size * stride
                            : m / (2 * stride) * stride +
                                  min(m % (2 * stride), stride);
      for (int t = tid; t < t_end; t += kThreads) {
        const int j = t & (stride - 1);
        const int lo = 2 * t - j;
        const int hi = 2 * stride == size ? lo + size - 1 - 2 * j
                                          : lo + stride;
        if (hi >= n) continue;
        const uint64_t a = keys[lo];
        const uint64_t c = keys[hi];
        if (a > c) {
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

  // 7-10. merge, score and write the wire (one thread: 2K entries)
  if (tid == 0)
    write_wire(w, cand_v, cand_e, n_l, n_d, K,
               __fmul_rn(static_cast<float>(lengths[b] - (k - 1)), thr),
               wide, wire_w, n_dense + n_light_only);
}

// ---- the warp path ------------------------------------------------------ //

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// a row's ids and deltas come in 16-byte loads when P is a multiple of
// the ids of one load and the row is aligned (its deltas then are too)
template <bool Narrow>
__device__ __forceinline__ bool vector_row(const int32_t* row, int P) {
  return P % LightRow<Narrow>::kVecIds == 0 && aligned16(row);
}

// real postings among n edge ids
template <bool Narrow, int N>
__device__ __forceinline__ int count_ids(const uint32_t* e) {
  int c = 0;
#pragma unroll
  for (int t = 0; t < N; ++t) c += e[t] != LightRow<Narrow>::kPad;
  return c;
}

// real postings of one light row
template <bool Narrow>
__device__ int count_real(const int32_t* row, int P) {
  using L = LightRow<Narrow>;
  int c = 0;
  if (vector_row<Narrow>(row, P)) {
    for (int j = 0; j < P; j += L::kVecIds) {
      uint32_t e[L::kVecIds];
      L::load_ids(row, j, e);
      c += count_ids<Narrow, L::kVecIds>(e);
    }
  } else {
    for (int j = 0; j < P; ++j) c += L::edge(row, j) != L::kPad;
  }
  return c;
}

template <bool Narrow>
__device__ __forceinline__ void put_key(uint64_t*& out, uint32_t e,
                                        uint32_t d) {
  if (e != LightRow<Narrow>::kPad)
    *out++ = (static_cast<uint64_t>(e) << 32) | d;
}

// the real postings of one light row as sort keys at out, in row order
template <bool Narrow>
__device__ void write_real(const int32_t* row, int P, uint64_t* out) {
  using L = LightRow<Narrow>;
  if (vector_row<Narrow>(row, P)) {
    const int32_t* deltas = row + L::edge_words(P);
    for (int j = 0; j < P; j += L::kVecIds) {
      uint32_t e[L::kVecIds];
      L::load_ids(row, j, e);
#pragma unroll
      for (int h = 0; h < L::kVecIds; h += 4) {
        const int4 d = __ldg(reinterpret_cast<const int4*>(deltas + j + h));
        put_key<Narrow>(out, e[h], d.x);
        put_key<Narrow>(out, e[h + 1], d.y);
        put_key<Narrow>(out, e[h + 2], d.z);
        put_key<Narrow>(out, e[h + 3], d.w);
      }
    }
  } else {
    for (int j = 0; j < P; ++j)
      put_key<Narrow>(out, L::edge(row, j), L::delta(row, P, j));
  }
}

// one compare-exchange of the bitonic network on key i (held by `lane`)
// and key i ^ stride (held by lane ^ stride): the lower index keeps the
// smaller key where its size-block ascends
__device__ __forceinline__ uint64_t exchange(uint64_t v, int i, int size,
                                             int stride, int lane) {
  const uint64_t o = __shfl_xor_sync(kFull, v, stride);
  const bool keep_min = ((lane & stride) == 0) == ((i & size) == 0);
  return (v < o) == keep_min ? v : o;
}

// ascending bitonic sort of keys[0 .. n), n <= cap, in a warp: the same
// sorted array as the block design's.  Strides below 32 run in
// registers, a key per lane at a time through warp shuffles (all of sizes
// 2 .. 32 in one pass, then one pass per larger size); strides of 32 and
// more compare-exchange in shared memory, neighbouring lanes on
// neighbouring keys.  n <= 32 never leaves the registers.
__device__ void warp_sort(uint64_t* keys, int n, int lane) {
  if (n <= 32) {
    uint64_t v = lane < n ? keys[lane] : kEmpty;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        v = exchange(v, lane, size, stride, lane);
    __syncwarp();
    if (lane < n) keys[lane] = v;
    return;
  }
  int n_sort = 64;
  while (n_sort < n) n_sort <<= 1;
  for (int i = n + lane; i < n_sort; i += 32) keys[i] = kEmpty;
  __syncwarp();
#pragma unroll 2
  for (int i = lane; i < n_sort; i += 32) {  // sizes 2 .. 32
    uint64_t v = keys[i];
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        v = exchange(v, i, size, stride, lane);
    keys[i] = v;
  }
  __syncwarp();
  for (int size = 64; size <= n_sort; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
#pragma unroll 2
      for (int t = lane; t < n_sort / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = keys[lo];
        const uint64_t c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncwarp();
    }
#pragma unroll 2
    for (int i = lane; i < n_sort; i += 32) {  // strides 16 .. 1
      uint64_t v = keys[i];
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1)
        v = exchange(v, i, size, stride, lane);
      keys[i] = v;
    }
    __syncwarp();
  }
}

// the warp path's picks: pick j as (cv[j], ce[j] + add)
__device__ __forceinline__ auto pick(float* cv, int* ce, int add) {
  return [=](int j, float v, int e) {
    cv[j] = v;
    ce[j] = e + add;
  };
}

// read b on the warp path, in the warp's region `mine`: keys[cap],
// tot[cap] (only for K past kLaneTop) and the 2K candidates
template <class Rows, bool Narrow>
__device__ void warp_score_read(const Rows& rows, int b, char* mine, int P,
                                const float* __restrict__ acc_c, int E,
                                const int32_t* __restrict__ slot_of,
                                const int32_t* __restrict__ lengths,
                                float thr, int k, int K, int cap,
                                int wire_w, int wide, int offset,
                                int32_t* __restrict__ wire, int lane) {
  int32_t* w = wire + static_cast<int64_t>(b) * wire_w;
  const bool in_regs = K <= kLaneTop;
  uint64_t* keys = reinterpret_cast<uint64_t*>(mine);
  float* tot = reinterpret_cast<float*>(keys + cap);
  float* cand_v = in_regs ? tot : tot + cap;  // [2K]: light, dense picks
  int* cand_e = reinterpret_cast<int*>(cand_v + 2 * K);

  // 1. gather: a lane per row slot, placed by a prefix sum of the counts;
  // the next 32 slots' rows are looked up while these load
  using L = LightRow<Narrow>;
  constexpr int kLoads8 = L::words(8) / 4;  // 16-byte loads of a P = 8 row
  const int W = rows.width();
  int n = 0;
  const int32_t* row = lane < W ? rows.row(b, lane) : nullptr;
  for (int s0 = 0; s0 < W; s0 += 32) {
    const int32_t* next =
        s0 + 32 + lane < W ? rows.row(b, s0 + 32 + lane) : nullptr;
    const bool eight = P == 8 && aligned16(row);
    // a P = 8 row in registers: its 8 edge ids (one load of u16 ids, two
    // of int32 ones), then deltas 0-3 and 4-7 in its last two loads
    uint4 q[kLoads8];
    uint32_t e8[8];
    int c = 0;
    if (row != nullptr && eight) {
#pragma unroll
      for (int j = 0; j < kLoads8; ++j)
        q[j] = __ldg(reinterpret_cast<const uint4*>(row) + j);
#pragma unroll
      for (int j = 0; j < kLoads8 - 2; ++j) L::ids(q[j], e8 + j * L::kVecIds);
      c = count_ids<Narrow, 8>(e8);
    } else if (row != nullptr) {
      c = count_real<Narrow>(row, P);
    }
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (row != nullptr && n + incl <= cap) {
      uint64_t* out = keys + n + incl - c;
      if (eight) {
        const uint4 d0 = q[kLoads8 - 2];
        const uint4 d1 = q[kLoads8 - 1];
        put_key<Narrow>(out, e8[0], d0.x);
        put_key<Narrow>(out, e8[1], d0.y);
        put_key<Narrow>(out, e8[2], d0.z);
        put_key<Narrow>(out, e8[3], d0.w);
        put_key<Narrow>(out, e8[4], d1.x);
        put_key<Narrow>(out, e8[5], d1.y);
        put_key<Narrow>(out, e8[6], d1.z);
        put_key<Narrow>(out, e8[7], d1.w);
      } else {
        write_real<Narrow>(row, P, out);
      }
    }
    n += __shfl_sync(kFull, incl, 31);
    row = next;
  }
  if (n > cap) {  // not this path's read (or the plan was wrong for it)
    if (lane == 0) w[wire_w - 1] = -1;
    return;
  }
  __syncwarp();

  // 2. the canonical sort
  if (n > 1) warp_sort(keys, n, lane);
  __syncwarp();

  // 3-5. segment sums at segment starts plus the dense value there; the
  // light totals go to the lanes' lists (or tot[] for the scanning rounds)
  const int slot = slot_of[b];
  const float* arow =
      slot >= 0 ? acc_c + static_cast<int64_t>(slot) * E : nullptr;
  LaneTop top;
  top.clear();
  int n_light_only = 0;
  for (int i0 = 0; i0 < n; i0 += 4 * 32) {  // 4 keys a lane, loads first
    uint32_t e[4];
    bool start[4];
    float da[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      e[u] = i < n ? static_cast<uint32_t>(keys[i] >> 32) : kPadEdge;
      start[u] = i < n && (i == 0 ||
                           static_cast<uint32_t>(keys[i - 1] >> 32) != e[u]);
      const uint32_t col = e[u] - static_cast<uint32_t>(offset);
      da[u] = start[u] && arow != nullptr && col < static_cast<uint32_t>(E)
                  ? __ldg(arow + col)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      bool only = false;
      if (start[u]) {
        float s = 0.f;
        for (int j = i; j < n && static_cast<uint32_t>(keys[j] >> 32) == e[u];
             ++j)
          s += __uint_as_float(static_cast<uint32_t>(keys[j]));
        const float t = __fadd_rn(s, da[u]);
        only = !(da[u] > 0.f);
        if (in_regs) top.insert(t, static_cast<int>(e[u]));
        else tot[i] = t;
      } else if (!in_regs && i < n) {
        tot[i] = -INFINITY;
      }
      n_light_only += __popc(__ballot_sync(kFull, only));
    }
  }
  __syncwarp();
  int n_l;
  if (in_regs) {
    n_l = warp_take(top, K, pick(cand_v, cand_e, 0), lane);
  } else {
    n_l = warp_scan_take(
        n, [&](int i) { return tot[i]; },
        [&](int i) { return static_cast<int>(keys[i] >> 32); },
        [](float v) { return v > -INFINITY; }, K, pick(cand_v, cand_e, 0),
        lane);
  }

  // 6. top-K of the dense row where it is > 0, and its count: one pass
  int n_d = 0;
  int n_dense = 0;
  if (arow != nullptr) {
    if (in_regs) {
      top.clear();
      int cnt = 0;
      const int head = min(
          E, static_cast<int>(
                 ((16 - (reinterpret_cast<uintptr_t>(arow) & 15)) & 15) >> 2));
      for (int e = lane; e < head; e += 32) {
        const float v = __ldg(arow + e);
        if (v > 0.f) {
          ++cnt;
          top.insert(v, e);
        }
      }
      const int n4 = (E - head) >> 2;
      const float4* a4 = reinterpret_cast<const float4*>(arow + head);
      for (int f0 = lane; f0 < n4; f0 += 8 * 32) {  // 8 loads in flight
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = f0 + 32 * u < n4 ? __ldg(a4 + f0 + 32 * u)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        // the values that beat the lane's last candidate so far, as bits
        // (load, component); they are inserted one at a time afterwards,
        // from one call site (their loads hit L1)
        unsigned beat = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float c4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
          const int e = head + 4 * (f0 + 32 * u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cnt += c4[j] > 0.f;
            if (c4[j] > 0.f && before(c4[j], e + j, top.v[kLaneTop - 1],
                                      top.e[kLaneTop - 1]))
              beat |= 1u << (4 * u + j);
          }
        }
        while (beat != 0) {
          const int bit = __ffs(beat) - 1;
          beat &= beat - 1;
          const int e = head + 4 * (f0 + 32 * (bit >> 2)) + (bit & 3);
          top.insert(__ldg(arow + e), e);
        }
      }
      for (int e = head + 4 * n4 + lane; e < E; e += 32) {
        const float v = __ldg(arow + e);
        if (v > 0.f) {
          ++cnt;
          top.insert(v, e);
        }
      }
      n_dense = __reduce_add_sync(kFull, cnt);
      n_d = warp_take(top, K, pick(cand_v + K, cand_e + K, offset), lane);
    } else {
      int cnt = 0;
      for (int e = lane; e < E; e += 32) cnt += __ldg(arow + e) > 0.f;
      n_dense = __reduce_add_sync(kFull, cnt);
      n_d = warp_scan_take(
          E, [&](int e) { return __ldg(arow + e); }, [](int e) { return e; },
          [](float v) { return v > 0.f; }, K,
          pick(cand_v + K, cand_e + K, offset), lane);
    }
  }
  __syncwarp();

  // 7-10. as the block path
  if (lane == 0)
    write_wire(w, cand_v, cand_e, n_l, n_d, K,
               __fmul_rn(static_cast<float>(lengths[b] - (k - 1)), thr),
               wide, wire_w, n_dense + n_light_only);
}

// the warp path: a warp per read, read b = blockIdx.x * (warps per block)
// + warp, in its region of `region` bytes
template <class Rows, bool Narrow>
__global__ void __launch_bounds__(32 * kMaxWarpReads)
finalize_postings_warp_kernel(Rows rows, int P,
                              const float* __restrict__ acc_c, int E,
                              const int32_t* __restrict__ slot_of,
                              const int32_t* __restrict__ lengths, float thr,
                              int k, int K, int cap, int region, int B,
                              int wire_w, int wide, int offset,
                              int32_t* __restrict__ wire) {
  extern __shared__ uint64_t smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps: the path has no block barrier
  warp_score_read<Rows, Narrow>(
      rows, b, reinterpret_cast<char*>(smem) + warp * region, P, acc_c, E,
      slot_of, lengths, thr, k, K, cap, wire_w, wide, offset, wire,
      threadIdx.x & 31);
}

constexpr int kGatherThreads = 256;
constexpr int kRowsInFlight = 4;

// T: one load (int4, int2 or int); blockDim = (lanes, kGatherThreads /
// lanes): lane x of row slot y copies loads x, x + lanes, ... of rows
// blockIdx.x * rows + k * blockDim.y + y
template <class T>
__global__ void __launch_bounds__(kGatherThreads)
gather_compact_kernel(Parts parts, int w, const int32_t* __restrict__ uniq,
                      const int32_t* __restrict__ uniq_off, int U,
                      int32_t* __restrict__ out) {
  __shared__ const int32_t* s_base[kMaxParts];
  __shared__ int s_off[kMaxParts];
  const int n = parts.n;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x * blockDim.y) {
    s_base[i] = static_cast<const int32_t*>(parts.base(i));
    s_off[i] = uniq_off[i];
  }
  __syncthreads();

  const int loads = w * 4 / static_cast<int>(sizeof(T));
  const int first = blockIdx.x * blockDim.y * kRowsInFlight + threadIdx.y;
  int row[kRowsInFlight];  // part-local rows, all loaded before the search
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
    const int u = first + k * blockDim.y;
    row[k] = u < U ? __ldg(uniq + u) : -1;
  }
  const T* src[kRowsInFlight];
  T* dst[kRowsInFlight];
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
    const int u = first + k * blockDim.y;
    src[k] = nullptr;
    dst[k] = nullptr;
    if (u < U) {
      int lo = 0, hi = n - 1;  // the last part whose run starts at or before u
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_off[mid] <= u) lo = mid; else hi = mid - 1;
      }
      src[k] = reinterpret_cast<const T*>(
          s_base[lo] + static_cast<int64_t>(row[k]) * w);
      dst[k] = reinterpret_cast<T*>(out + static_cast<int64_t>(u) * w);
    }
  }
  for (int x = threadIdx.x; x < loads; x += blockDim.x) {
    T v[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k)
      if (src[k]) v[k] = __ldg(src[k] + x);
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k)
      if (src[k]) dst[k][x] = v[k];
  }
}

template <class T>
void launch_gather(Parts parts, int w, const int32_t* uniq,
                   const int32_t* uniq_off, int U, int32_t* out,
                   cudaStream_t stream) {
  const int loads = w * 4 / static_cast<int>(sizeof(T));
  const int lanes = loads < kGatherThreads ? loads : kGatherThreads;
  const dim3 block(lanes, kGatherThreads / lanes);
  const int rows = block.y * kRowsInFlight;
  gather_compact_kernel<T><<<(U + rows - 1) / rows, block, 0, stream>>>(
      parts, w, uniq, uniq_off, U, out);
}

// one P3 call with the row source `rows`: the warp launch over all B
// reads (warp_cap >= 0: its regions' sort slots), then the block launch
// over the n_block reads of block_reads (cap sort slots of shared memory,
// or their scratch regions); Narrow: the rows' edge ids are u16
template <class Rows, bool Narrow>
int launch_p3(Rows rows, int P, int B, const float* acc_c, int E,
              const int32_t* slot_of, const int32_t* lengths, float thr,
              int k, int K, int warp_cap, int cap,
              const int64_t* scratch_off, uint64_t* scratch_keys,
              float* scratch_tot, const int32_t* block_reads, int n_block,
              int wire_w, int wide, int offset, int32_t* wire,
              cudaStream_t stream) {
  if (warp_cap >= 0 && B > 0) {
    if (warp_cap > kWarpMaxPairs)
      return static_cast<int>(cudaErrorInvalidValue);
    // keys (8 B) and, past kLaneTop, totals (4 B) per sort slot, 2K
    // candidates, 16-aligned
    const size_t region = (static_cast<size_t>(warp_cap) *
                               (K <= kLaneTop ? 8 : 12) +
                           static_cast<size_t>(K) * 16 + 15) / 16 * 16;
    // blocks of one warp, or two where shared memory would let an SM hold
    // more warps than its 32 blocks: no warp waits for a slower read of
    // its block
    const size_t fit = kSmemPerSM / (region > 0 ? region : 16);
    const size_t wpb = fit > 32 ? 2 : 1;
    const size_t smem = region * wpb;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          finalize_postings_warp_kernel<Rows, Narrow>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int nb = static_cast<int>((B + wpb - 1) / wpb);
    finalize_postings_warp_kernel<Rows, Narrow>
        <<<nb, static_cast<int>(32 * wpb), smem, stream>>>(
            rows, P, acc_c, E, slot_of, lengths, thr, k, K, warp_cap,
            static_cast<int>(region), B, wire_w, wide, offset, wire);
    const int launched = static_cast<int>(cudaGetLastError());
    if (launched) return launched;
  }
  if (n_block > 0) {
    // keys (8 B) and totals (4 B) per sort slot, 2K candidate (score, edge)
    const size_t smem =
        static_cast<size_t>(cap) * 12 + static_cast<size_t>(K) * 16;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          finalize_postings_kernel<Rows, Narrow>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    finalize_postings_kernel<Rows, Narrow>
        <<<n_block, kThreads, smem, stream>>>(
        rows, P, acc_c, E, slot_of, lengths, thr, k, K, cap, scratch_off,
        scratch_keys, scratch_tot, block_reads, wire_w, wide, offset, wire);
  }
  return static_cast<int>(cudaGetLastError());
}

// the words of a light row of P postings with u16 (narrow) or int32 ids
int row_words(int P, int narrow) {
  return narrow ? LightRow<true>::words(P) : LightRow<false>::words(P);
}

// one P3 call: launch_p3's instance for the rows' edge width
template <class Rows>
int launch_p3_of(int narrow, Rows rows, int P, int B, const float* acc_c,
                 int E, const int32_t* slot_of, const int32_t* lengths,
                 float thr, int k, int K, int warp_cap, int cap,
                 const int64_t* scratch_off, uint64_t* scratch_keys,
                 float* scratch_tot, const int32_t* block_reads, int n_block,
                 int wire_w, int wide, int offset, int32_t* wire,
                 cudaStream_t stream) {
  const auto launch =
      narrow ? &launch_p3<Rows, true> : &launch_p3<Rows, false>;
  return launch(rows, P, B, acc_c, E, slot_of, lengths, thr, k, K, warp_cap,
                cap, scratch_off, scratch_keys, scratch_tot, block_reads,
                n_block, wire_w, wide, offset, wire, stream);
}

}  // namespace

extern "C" {

// P1.  H: f32[nh + 1, E]; hrows: int32[n_h] heavy rows grouped by slot;
// hoff: int32[n_slots + 1] CSR offsets; acc_c: f32[n_slots, E], written.
int rp_dense_side(const float* H, int E, const int32_t* hrows,
                  const int32_t* hoff, int n_slots, float* acc_c,
                  cudaStream_t stream) {
  // tiles of kQuads x 31 output quads (a row's quads start up to 3 words
  // before its column 0)
  const int tiles = ((E + 3 + 3) / 4 + 31 * kQuads - 1) / (31 * kQuads);
  const int64_t warps = static_cast<int64_t>(n_slots) * tiles;
  if (warps > 0) {
    const unsigned blocks =
        static_cast<unsigned>((warps + kWarps - 1) / kWarps);
    dense_side_kernel<<<blocks, kThreads, 0, stream>>>(H, E, hrows, hoff,
                                                       n_slots, tiles, acc_c);
  }
  return static_cast<int>(cudaGetLastError());
}

// P3.  pairs: int32[R, w] light rows of P postings (light.cuh: w = ceil(P
// / 2) + P with u16 edge ids when narrow, 2P with int32 ones otherwise;
// row miss all pads, skipped; -1: none); lrows:
// int32[B, W]; acc_c: f32[n_slots, E]; slot_of: int32[B] (-1: no slot);
// lengths: int32[B]; the plan (kernels.postings_plan): warp_cap, the sort
// slots of a warp-path region (a power of two up to kWarpMaxPairs; -1: no
// warp launch), cap, the shared sort slots of a block-path read (a power
// of two), scratch_off, int64[B + 1] offsets into scratch_keys/scratch_tot
// (an empty range keeps read b in shared memory) or null, and block_reads,
// int32[n_block] the reads of the block path; wire: int32[B, wire_w], K,
// wire_w and wide as the caller's kernels.wire_format gives them (as K3's;
// K at most E, wide from the global edge count); offset: the global edge
// id of acc_c's column 0.
int rp_finalize_postings(const int32_t* pairs, int P, int narrow, int miss,
                         const int32_t* lrows, int B, int W,
                         const float* acc_c, int E, const int32_t* slot_of,
                         const int32_t* lengths, float thr, int k, int K,
                         int warp_cap, int cap, const int64_t* scratch_off,
                         uint64_t* scratch_keys, float* scratch_tot,
                         const int32_t* block_reads, int n_block,
                         int wire_w, int wide, int offset, int32_t* wire,
                         cudaStream_t stream) {
  return launch_p3_of(narrow, OneTable{pairs, row_words(P, narrow), miss,
                                       lrows, W},
                      P, B, acc_c, E, slot_of, lengths, thr, k, K, warp_cap,
                      cap, scratch_off, scratch_keys, scratch_tot,
                      block_reads, n_block, wire_w, wide, offset, wire,
                      stream);
}

// R1.  meta: int64[3, n] (parts.cuh) of the light parts, each int32[H_i, w] (w
// and narrow as P3's); routed = 1: rows int32[n, B, W] part-local rows (pads >=
// H_i), miss unused; routed = 0: rows int32[B, W] global rows, miss the global
// miss row (or -1).  The rest as P3's.
int rp_finalize_postings_split(int routed, const int64_t* meta, int n, int P,
                               int narrow, int miss, const int32_t* rows,
                               int B, int W,
                               const float* acc_c, int E,
                               const int32_t* slot_of, const int32_t* lengths,
                               float thr, int k, int K, int warp_cap, int cap,
                               const int64_t* scratch_off,
                               uint64_t* scratch_keys, float* scratch_tot,
                               const int32_t* block_reads, int n_block,
                               int wire_w, int wide, int offset,
                               int32_t* wire, cudaStream_t stream) {
  const Parts parts{meta, n};
  const int w = row_words(P, narrow);
  if (routed)
    return launch_p3_of(narrow, RoutedRows{parts, w, rows, B, W}, P, B,
                        acc_c, E, slot_of, lengths, thr, k, K, warp_cap, cap,
                        scratch_off, scratch_keys, scratch_tot, block_reads,
                        n_block, wire_w, wide, offset, wire, stream);
  return launch_p3_of(narrow, PartRows{parts, w, miss, rows, W}, P, B, acc_c,
                      E, slot_of, lengths, thr, k, K, warp_cap, cap,
                      scratch_off, scratch_keys, scratch_tot, block_reads,
                      n_block, wire_w, wide, offset, wire, stream);
}

// G1.  meta: int64[3, n] (n <= kMaxParts) of the light parts, rows of w
// int32 words (either edge width: the rows are copied whole), every
// part's base aligned to 16 bytes when w % 4 == 0, else to 8 when w % 2
// == 0; uniq: int32[U] part-local rows, part
// p's at uniq_off[p] .. uniq_off[p+1] (uniq_off: int32[n + 1]); out:
// int32[U, w], written.
int rp_gather_compact(const int64_t* meta, int n, int w, const int32_t* uniq,
                      const int32_t* uniq_off, int U, int32_t* out,
                      cudaStream_t stream) {
  if (n < 1 || n > kMaxParts || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (U > 0) {
    const Parts parts{meta, n};
    if (w % 4 == 0)
      launch_gather<int4>(parts, w, uniq, uniq_off, U, out, stream);
    else if (w % 2 == 0)
      launch_gather<int2>(parts, w, uniq, uniq_off, U, out, stream);
    else
      launch_gather<int>(parts, w, uniq, uniq_off, U, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
