// Alphabet-run prefilter for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_alpharun.py
// alpharun_word_bitmap (Pallas body _build_kernel) together with the
// lane-OR of packed_block_flags that follows it in XLA.
//
// What it computes. The scan buffer is viewed as int32 words
// [rows + 8, 128] (one 512-byte candidate block per row, 8 zero pad rows
// after it), a flat little-endian byte string. A byte is a member when it
// lies in one of up to 8 inclusive ranges (the pattern's alphabet).
//   coarse, units W' in {1, 2, 4, 8}: word w is a hit when the W' words
//     w .. w + W' - 1 consist of member bytes only;
//   fine, units L' in {1, 2, 4}: word w is a hit when a run of L' member
//     bytes starts at one of its 4 bytes (the run may reach into w + 1).
// The pad rows take part like any other bytes (a range that holds byte 0
// makes them members). Outputs, bit for bit as the TPU path produces them
// (word_epilogue.cuh): bm[g, c] bit r = hit at word (32g + r, c),
// packed[g] the OR of bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. Each word is read once (33.6 MB per 32 MiB buffer,
// ~10 us at 3.35 TB/s). The integer work is about 7 ops per range for
// the 4 bytes of a word (two SWAR compares, AND-NOT, OR), twice that in
// fine mode, plus a handful for the run: for one or two ranges the bytes
// bound it, for 8 ranges in fine mode the integer throughput.
//
// What the design does about it. The TPU kernel needed lane rolls and a
// one-row carry to see word w + a; here it is the next address. One block
// of 128 threads owns a 32-row group. Coarse: each thread tests its own
// word once per row (membership of the 4 bytes as one SWAR compare per
// range bound, swar.cuh; the bounds' constants are made once, on the
// host) and the warp's ballot puts "word wholly in the alphabet" as one bit per word into shared memory, 33 rows of 128 bits
// (the 33rd is the next group's or the pad's first row, of which only
// words 0..6 are needed); a run of W' words is then W' consecutive ones
// in that bit string, one funnel shift and a compare per word. So the
// W'-fold recomputation of the direct form is not paid. Fine: a thread
// reads words w and w + 1, builds the 64-bit membership mask of their 8
// bytes and halves the run by shifting (S &= S >> 8, S &= S >> 16); the
// low word's high bits say whether a run starts in w. The ranges travel
// by value as a kernel argument. The epilogue is shared with the other
// word kernels.
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "swar.cuh"
#include "word_epilogue.cuh"

namespace {

using grab_word::Bound;
using grab_word::kGroupRows;
using grab_word::kH;
using grab_word::kL7;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kMaxRanges = 8;
constexpr int kWarps = kLanes / 32;

struct Ranges {  // built by the entry point: byte in [lo, hi] of range t
  int n;            // iff from[t].ge && !to[t].ge
  Bound from[kMaxRanges];  // >= lo
  Bound to[kMaxRanges];    // >= hi + 1
};

// High bit of each byte of x that lies in one of the ranges.
__device__ __forceinline__ uint32_t members(uint32_t x, const Ranges& rg) {
  const uint32_t xl = x & kL7;
  uint32_t m = 0;
  for (int t = 0; t < rg.n; ++t) {
    m |= rg.from[t].ge(x, xl) & ~rg.to[t].ge(x, xl);
  }
  return m & kH;
}

__global__ void __launch_bounds__(kLanes)
    alpharun_coarse_kernel(const uint32_t* __restrict__ words, const Ranges rg,
                           const int units, int32_t* __restrict__ bm,
                           int32_t* __restrict__ packed,
                           int32_t* __restrict__ total) {
  // full[r * 4 + w]: bit l = word (r, 32w + l) wholly in the alphabet;
  // row 32 holds the following row's first 32 words
  __shared__ uint32_t full[(kGroupRows + 1) * kWarps];
  const int g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* col =
      words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
#pragma unroll 4
  for (int r = 0; r < kGroupRows; ++r) {
    const uint32_t m = members(__ldg(col + r * kLanes), rg);
    const uint32_t b = __ballot_sync(0xffffffffu, m == kH);
    if ((c & 31) == 0) full[r * kWarps + (c >> 5)] = b;
  }
  if (c < 32) {
    const uint32_t m = members(__ldg(col + kGroupRows * kLanes), rg);
    const uint32_t b = __ballot_sync(0xffffffffu, m == kH);
    if (c == 0) full[kGroupRows * kWarps] = b;
  }
  __syncthreads();
  const uint32_t want = units >= 32 ? ~0u : (1u << units) - 1u;
  uint32_t bits = 0;
#pragma unroll 4
  for (int r = 0; r < kGroupRows; ++r) {
    const int i = r * kWarps + (c >> 5);
    const uint32_t win = __funnelshift_r(full[i], full[i + 1], c & 31);
    bits |= static_cast<uint32_t>((win & want) == want) << r;
  }
  grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
}

__global__ void __launch_bounds__(kLanes)
    alpharun_fine_kernel(const uint32_t* __restrict__ words, const Ranges rg,
                         const int units, int32_t* __restrict__ bm,
                         int32_t* __restrict__ packed,
                         int32_t* __restrict__ total) {
  const int g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* col =
      words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
  uint32_t bits = 0;
#pragma unroll 4
  for (int r = 0; r < kGroupRows; ++r) {
    const uint32_t m0 = members(__ldg(col + r * kLanes), rg);
    const uint32_t m1 = units > 1 ? members(__ldg(col + r * kLanes + 1), rg) : 0u;
    uint64_t s = static_cast<uint64_t>(m0) | (static_cast<uint64_t>(m1) << 32);
    if (units >= 2) s &= s >> 8;
    if (units >= 4) s &= s >> 16;
    bits |= static_cast<uint32_t>((static_cast<uint32_t>(s) & kH) != 0u) << r;
  }
  grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
}

}  // namespace

extern "C" {

// words:  device int32 [32*groups + 8, 128], the last 8 rows zero
// lo, hi: HOST int32 [n_ranges], inclusive byte ranges (copied into the
//         launch); coarse != 0: units in {1, 2, 4, 8} words, else units in
//         {1, 2, 4} bytes
// bm:     device int32 [groups, 128]; packed: device int32 [groups];
// total:  device int32 [1] (zeroed here, on the stream, before the kernel)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_alpharun_scan(const void* words, const int32_t* lo, const int32_t* hi,
                     int n_ranges, int coarse, int units, int64_t groups,
                     void* bm, void* packed, void* total, int device,
                     void* stream) {
  const bool units_ok =
      units == 1 || units == 2 || units == 4 || (coarse && units == 8);
  if (groups <= 0 || groups > 0x7fffffff || n_ranges < 1 ||
      n_ranges > kMaxRanges || !units_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ranges rg;
  rg.n = n_ranges;
  for (int t = 0; t < kMaxRanges; ++t) {
    const int a = t < n_ranges ? lo[t] : 0, b = t < n_ranges ? hi[t] : 0;
    if (a < 0 || b > 255 || a > b) return static_cast<int>(cudaErrorInvalidValue);
    rg.from[t] = Bound(a);
    rg.to[t] = Bound(b + 1);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = grab_word::zero_total(total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(groups);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (coarse) {
    alpharun_coarse_kernel<<<grid, kLanes, 0, st>>>(
        w, rg, units, static_cast<int32_t*>(bm), static_cast<int32_t*>(packed),
        static_cast<int32_t*>(total));
  } else {
    alpharun_fine_kernel<<<grid, kLanes, 0, st>>>(
        w, rg, units, static_cast<int32_t*>(bm), static_cast<int32_t*>(packed),
        static_cast<int32_t*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
