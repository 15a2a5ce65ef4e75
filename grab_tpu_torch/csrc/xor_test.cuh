// The XOR-filter membership test shared by xorfilter.cu and fused.cu.
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

}  // namespace grab_word
