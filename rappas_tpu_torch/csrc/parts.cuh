// A table height-split into parts on one device, as the wrappers of
// rappas_tpu_torch/place/kernels.py pass it (kernels.Parts): meta is
// int64[3, n] -- each part's base address, its height (the rows a global
// row may select in it) and its first global row (the heights summed
// before it, so 0 for part 0 and ascending).  The split kernels of
// postings.cu (R1, G1), accumulate.cu (D1) and ambiguous.cu (A1) read their
// rows through it.
//
// part_of(r) is the part that JAX's select chains pick for a global row r
// (rappas_tpu/place/engine.py:671-681, :939-947): the last part whose first
// row is <= r.  A part count is small (at most 64), so a linear scan.

#pragma once

#include <cstdint>

struct Parts {
  const int64_t* meta;
  int n;

  __device__ __forceinline__ const void* base(int p) const {
    return reinterpret_cast<const void*>(meta[p]);
  }
  __device__ __forceinline__ int64_t height(int p) const {
    return meta[n + p];
  }
  __device__ __forceinline__ int64_t first(int p) const {
    return meta[2 * n + p];
  }
  __device__ __forceinline__ int part_of(int64_t r) const {
    int p = n - 1;
    while (p > 0 && r < first(p)) --p;
    return p;
  }
};

// v clipped into [0, hi]
__device__ __forceinline__ int64_t clip(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}
