// The XOR-filter membership test: the compact form of fused.cu
// (xor_members) and the copied-bank form of xorfilter.cu (copied_group).
//
// A filter is a list of groups; group g has arity a_g in 1..4 bank rows
// of 128 slots and one odd 32-bit multiplier per bank. A word x is a
// member when, for some group,
//   XOR_b bank[base_g + b][(x * c_b mod 2^32) >> 25] == x.
//
// The filter travels as one int32 "program" (ops/xorfilter.py
// xor_program), in global or shared memory:
//   [0] n_groups  [1] n_rows (sum of arities)
//   arity[n_groups]  consts[n_rows]  bank rows [n_rows][128]

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace grab_word {

constexpr int kXorSlots = 128;

struct XorView {
  int n_groups;
  const uint32_t* arity;
  const uint32_t* consts;
  const uint32_t* banks;
  __device__ __forceinline__ explicit XorView(const uint32_t* prog)
      : n_groups(static_cast<int>(prog[0])),
        arity(prog + 2),
        consts(prog + 2 + prog[0]),
        banks(prog + 2 + prog[0] + prog[1]) {}
};

// Host-side: the program's length in words, or -1 when its header is not
// a filter's.
inline int64_t xor_program_words(const uint32_t* prog, int64_t avail) {
  if (avail < 2) return -1;
  const int64_t g = prog[0], r = prog[1];
  if (g < 1 || r < g || r > 4 * g) return -1;
  const int64_t need = 2 + g + r + r * kXorSlots;
  if (need > avail) return -1;
  int64_t sum = 0;
  for (int64_t i = 0; i < g; ++i) {
    if (prog[2 + i] < 1 || prog[2 + i] > 4) return -1;
    sum += prog[2 + i];
  }
  return sum == r ? need : -1;
}

// R words at once: a thread reads each group's arity and each bank's
// multiplier once for R words, and the R shared reads of a bank are
// independent, so their latencies overlap. → bit i set when x[i] is a
// member.
template <int R>
__device__ __forceinline__ uint32_t xor_members(const uint32_t (&x)[R],
                                                const XorView& f) {
  const uint32_t* c = f.consts;
  const uint32_t* bank = f.banks;
  uint32_t hits = 0;
  for (int g = 0; g < f.n_groups; ++g) {
    const int a = static_cast<int>(f.arity[g]);
    uint32_t acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    for (int b = 0; b < a; ++b) {
      const uint32_t cb = c[b];
      const uint32_t* row = bank + b * kXorSlots;
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] ^= row[(x[i] * cb) >> 25];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) hits |= static_cast<uint32_t>(acc[i] == x[i]) << i;
    c += a;
    bank += a * kXorSlots;
  }
  return hits;
}

// The copied-bank form (xorfilter.cu). A block expands each bank row
// into shared memory as C = 2^kLogC interleaved copies, copy j of slot s
// at word s * C + j, and lane l reads copy l mod C: with C = 32 the 32
// lanes of a warp read 32 distinct shared-memory banks whatever slots
// they ask for, with C = 16 at most two lanes share one. C = 1 is the
// compact row, in shared memory or (kGlobal) in global memory. `row`
// points at the lane's copy of a bank row, `h` is x * c_b.
template <int kLogC, bool kGlobal>
__device__ __forceinline__ uint32_t copied_slot(const uint32_t* row, uint32_t h) {
  const uint32_t off = (h >> (25 - kLogC)) & (static_cast<uint32_t>(kXorSlots - 1) << kLogC);
  if constexpr (kGlobal) {
    return __ldg(row + off);
  } else {
    return row[off];
  }
}

// One group of A banks (multipliers c[0 .. A), expanded rows from `bank`
// on, kXorSlots << kLogC words apart) on the 4 words of each of the R
// rows a lane holds: sets bit i of hk[k] when word k of row i is a member.
template <int A, int kLogC, bool kGlobal, int R>
__device__ __forceinline__ void copied_group(const uint4 (&q)[R], const uint32_t* c,
                                             const uint32_t* bank, uint32_t (&hk)[4]) {
  constexpr int kRow = kXorSlots << kLogC;
  uint32_t cb[A];
#pragma unroll
  for (int b = 0; b < A; ++b) cb[b] = c[b];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t x[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t acc = 0;
#pragma unroll
      for (int b = 0; b < A; ++b) acc ^= copied_slot<kLogC, kGlobal>(bank + b * kRow, x[k] * cb[b]);
      hk[k] |= static_cast<uint32_t>(acc == x[k]) << i;
    }
  }
}

}  // namespace grab_word
