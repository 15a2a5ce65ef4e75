// SWAR byte compares shared by the word kernels (classseq.cu,
// alpharun.cu, fused.cu): "byte >= b" for the 4 bytes of a word at once.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace grab_word {

constexpr uint32_t kH = 0x80808080u;   // each byte's high bit
constexpr uint32_t kL7 = 0x7f7f7f7fu;
constexpr uint32_t kL1 = 0x01010101u;

// "byte >= b" for the 4 bytes of x at once, into each byte's high bit
// (other bits are junk; xl = x & kL7; 0 <= b <= 256). For b <= 128,
// t = xl + (128 - b) per byte reaches 128 iff a byte below 128 is >= b,
// and a byte of 128 or more always is: t | x. For b > 128 only a byte of
// 128 or more can be, iff t = xl + (256 - b) reaches 128: t & x. keep
// (~0 or 0) selects the form without a branch. No carry crosses a
// byte: a 7-bit byte plus at most 128 stays below 256. b = 0 gives all
// four high bits, b = 256 none.
struct Bound {
  uint32_t add, keep;
  Bound() = default;
  __host__ __device__ __forceinline__ explicit Bound(int b)
      : add(static_cast<uint32_t>(b <= 128 ? 128 - b : 256 - b) * kL1),
        keep(b <= 128 ? ~0u : 0u) {}
  __device__ __forceinline__ uint32_t ge(uint32_t x, uint32_t xl) const {
    const uint32_t t = xl + add;
    return (t & (x | keep)) | (x & keep);
  }
};

}  // namespace grab_word
