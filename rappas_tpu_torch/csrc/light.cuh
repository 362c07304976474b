// A row of the postings layout's light table, as
// rappas_tpu_torch/db.py's LightLayout lays it out: P postings, their edge
// ids first, then their P bit-cast f32 deltas.  Narrow (below 65,535 edge
// slots, the wire's rule): two u16 ids a word, low half first, 0xFFFF a
// pad, the odd tail half-word a pad too; the deltas start at word
// ceil(P / 2).  Wide: one int32 id a word, 0x7FFFFFFF (LIGHT_PAD_EDGE) a
// pad; the deltas start at word P.  A real id is below either pad, so a
// posting's sort key (id << 32 | delta bits) is the same in both.
//
// Every reader of a light row (P3 and R1 in postings.cu, P2 and A1 in
// ambiguous.cu) is a template on Narrow: no posting takes a branch on the
// width.

#pragma once

#include <cstdint>

template <bool Narrow>
struct LightRow {
  static constexpr uint32_t kPad = Narrow ? 0xffffu : 0x7fffffffu;
  // ids in one 16-byte load of the id words
  static constexpr int kVecIds = Narrow ? 8 : 4;

  // the words of the ids: where the deltas start
  static __host__ __device__ constexpr int edge_words(int P) {
    return Narrow ? (P + 1) / 2 : P;
  }
  // the words of a row
  static __host__ __device__ constexpr int words(int P) {
    return edge_words(P) + P;
  }
  // id j of a row
  static __device__ __forceinline__ uint32_t edge(const int32_t* row, int j) {
    if constexpr (Narrow)
      return __ldg(reinterpret_cast<const unsigned short*>(row) + j);
    else
      return static_cast<uint32_t>(__ldg(row + j));
  }
  // the bits of delta j of a row
  static __device__ __forceinline__ uint32_t delta(const int32_t* row, int P,
                                                   int j) {
    return static_cast<uint32_t>(__ldg(row + edge_words(P) + j));
  }
  // the kVecIds ids of one 16-byte load of the id words
  static __device__ __forceinline__ void ids(uint4 q, uint32_t* e) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if constexpr (Narrow) {
        e[2 * t] = w[t] & 0xffffu;
        e[2 * t + 1] = w[t] >> 16;
      } else {
        e[t] = w[t];
      }
    }
  }
  // ids j .. j + kVecIds - 1 (j a multiple of kVecIds) of a 16-byte
  // aligned row whose P is a multiple of kVecIds
  static __device__ __forceinline__ void load_ids(const int32_t* row, int j,
                                                  uint32_t* e) {
    ids(__ldg(reinterpret_cast<const uint4*>(row + (Narrow ? j / 2 : j))),
        e);
  }
};
