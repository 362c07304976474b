// Table-row loads shared by the row sum (accumulate.cu) and the ambiguity
// passes (ambiguous.cu): BYTES of a row of f32 or uint16 values in one
// read-only global load with an L2 policy, and the values it holds.

#pragma once

#include <cstdint>

// the L2 policy of a table's loads: keep its lines past others
// (evict_last), or the normal priority
__device__ __forceinline__ uint64_t table_policy(int keep) {
  uint64_t pol;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(pol));
  return pol;
}

// BYTES of a table row (16, 8, 4 or 2) in one read-only load with an L2
// policy, as 32-bit words (a 2-byte load fills the low half of w[0])
template <int BYTES>
struct Words;

template <>
struct Words<16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p), "l"(pol));
  }
};

template <>
struct Words<8> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
        : "=r"(w[0]), "=r"(w[1])
        : "l"(p), "l"(pol));
  }
};

template <>
struct Words<4> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
        : "=r"(w[0])
        : "l"(p), "l"(pol));
  }
};

template <>
struct Words<2> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const void* p, uint64_t pol) {
    unsigned short h;
    asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
        : "=h"(h)
        : "l"(p), "l"(pol));
    w[0] = h;
  }
};

// the bytes of VEC values of T: one load
template <class T, int VEC>
constexpr int kBytes = VEC * static_cast<int>(sizeof(T));

// value i of the loaded words: f32, or uint16 widened exactly
template <class T, int VEC>
__device__ __forceinline__ float word_value(const Words<kBytes<T, VEC>>& x,
                                            int i) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(x.w[i]);
  else
    return static_cast<float>((x.w[i / 2] >> (16 * (i & 1))) & 0xffffu);
}
