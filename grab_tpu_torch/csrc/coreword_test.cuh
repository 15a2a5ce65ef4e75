// The core-word compare shared by corewords.cu (one bucket, K, W and
// masked as template parameters, the table by value) and fused.cu (any
// number of buckets as runtime data).
//
// A (phase, literal) test against the word x0 and the next word x1:
//   masked:    ((x0 ^ v0) & m0 | (x1 ^ v1) & m1) == 0
//   unmasked:  x0 == v0 && x1 == v1
// (the second word only when W == 2).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace grab_word {

template <int W, bool MASKED>
__device__ __forceinline__ uint32_t core_pair_hit(uint32_t x0, uint32_t x1,
                                                  uint32_t v0, uint32_t m0,
                                                  uint32_t v1, uint32_t m1) {
  if (MASKED) {
    uint32_t acc = (x0 ^ v0) & m0;
    if (W > 1) acc |= (x1 ^ v1) & m1;
    return acc == 0u;
  }
  bool eq = x0 == v0;
  if (W > 1) eq = eq && x1 == v1;
  return eq;
}

// One bucket against R rows at once. tab is the bucket's table
// [val | mask][4 phases][k][W] (CoreWordTests.tab); every thread of a
// warp reads the same entry. → bit i set when row i hits.
template <int W, bool MASKED, int R>
__device__ __forceinline__ uint32_t core_bucket_hits_t(
    const uint32_t* __restrict__ tab, int k, const uint32_t (&x0)[R],
    const uint32_t (&x1)[R]) {
  uint32_t hits = 0;
  const uint32_t* mask = tab + 4 * k * W;
  for (int e = 0; e < 4 * k; ++e) {  // e = phase * k + literal
    const uint32_t v0 = tab[e * W], m0 = MASKED ? mask[e * W] : 0u;
    const uint32_t v1 = W > 1 ? tab[e * W + 1] : 0u;
    const uint32_t m1 = (W > 1 && MASKED) ? mask[e * W + 1] : 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      hits |= core_pair_hit<W, MASKED>(x0[i], x1[i], v0, m0, v1, m1) << i;
    }
  }
  return hits;
}

template <int R>
__device__ __forceinline__ uint32_t core_bucket_hits(
    const uint32_t* __restrict__ tab, int k, int n_words, bool masked,
    const uint32_t (&x0)[R], const uint32_t (&x1)[R]) {
  if (n_words > 1) {
    return masked ? core_bucket_hits_t<2, true, R>(tab, k, x0, x1)
                  : core_bucket_hits_t<2, false, R>(tab, k, x0, x1);
  }
  return masked ? core_bucket_hits_t<1, true, R>(tab, k, x0, x1)
                : core_bucket_hits_t<1, false, R>(tab, k, x0, x1);
}

}  // namespace grab_word
