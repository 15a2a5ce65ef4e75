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
// (group_count.cuh): bm[g, c] bit r = hit at word (32g + r, c), packed[g]
// the OR of bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. Each word is read once (33.6 MB per 32 MiB buffer,
// ~10 us at 3.35 TB/s). The integer work is 5 ops per range for the 4
// bytes of a word (two SWAR compares of an add and a 3-input logic op,
// AND-NOT-OR), plus a few for the run: for one or two ranges the bytes
// bound it, for 8 ranges the integer throughput.
//
// What the design does about it. One warp owns a 32-row group and a lane
// 4 adjacent words of each row, read as one 16-byte load; 8 rows are
// loaded while the 8 before them are tested, so a lane keeps 128 bytes in
// flight. The range count, the mode and whether a run reaches past the
// word are template parameters: the range loop unrolls and its bounds
// are immediate operands (no local memory). Each word's membership is
// computed once and folded into a code: coarse, 1 bit per word ("wholly
// in the alphabet"); fine, 1 bit per byte (for one-byte runs, 1 bit per
// word: "holds a member byte"). A run that starts in a lane's last word
// reads the codes of the next lane (and, for 8 words, the one after) by
// shuffle; lane 31 takes lane 0's code of the next row, which the warp
// computes anyway, so the rows go through in order with one row of
// look-ahead (row 32 is the next group's first row or a pad row).
// `total` is counted without a memset on the stream (group_count.cuh).
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "swar.cuh"
#include "group_count.cuh"

namespace {

using grab_count::kGroupRows;
using grab_count::kRowVecs;
using grab_count::kWarpThreads;
using grab_count::kWarps;
using grab_word::Bound;
using grab_word::kH;
using grab_word::kL7;
constexpr int kMaxRanges = 8;
constexpr int kLoadRows = 8;  // rows per load batch (two batches in registers)

template <int NR>
struct Ranges {  // byte in [lo, hi] of range t iff from[t].ge && !to[t].ge
  Bound from[NR];  // >= lo
  Bound to[NR];    // >= hi + 1
};

// High bit of each byte of x that lies in one of the ranges.
template <int NR>
__device__ __forceinline__ uint32_t members(uint32_t x, const Ranges<NR>& rg) {
  const uint32_t xl = x & kL7;
  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < NR; ++t) m |= rg.from[t].ge(x, xl) & ~rg.to[t].ge(x, xl);
  return m & kH;
}

// The 4 high bits of m (bits 7, 15, 23, 31) as bits 0..3: the partial
// products land on distinct bits below 28, so nothing carries into them.
__device__ __forceinline__ uint32_t byte_bits(uint32_t m) {
  return (m * 0x00204081u) >> 28;
}

// A lane's code of one row: coarse, bit k = word k wholly in the
// alphabet; fine runs of one byte, bit k = a member byte in word k;
// longer fine runs, bit 4k + b = byte b of word k a member.
template <int NR, bool kCoarse, bool kNext>
__device__ __forceinline__ uint32_t row_code(const uint4 q, const Ranges<NR>& rg) {
  const uint32_t m0 = members(q.x, rg), m1 = members(q.y, rg);
  const uint32_t m2 = members(q.z, rg), m3 = members(q.w, rg);
  if (kCoarse) {
    return static_cast<uint32_t>(m0 == kH) | static_cast<uint32_t>(m1 == kH) << 1 |
           static_cast<uint32_t>(m2 == kH) << 2 | static_cast<uint32_t>(m3 == kH) << 3;
  }
  if (!kNext) {
    return static_cast<uint32_t>(m0 != 0u) | static_cast<uint32_t>(m1 != 0u) << 1 |
           static_cast<uint32_t>(m2 != 0u) << 2 | static_cast<uint32_t>(m3 != 0u) << 3;
  }
  return byte_bits(m0) | byte_bits(m1) << 4 | byte_bits(m2) << 8 | byte_bits(m3) << 12;
}

// Hits of a lane's 4 words in one row (bit k = word k) from the row's
// code `cur` and the next row's `nxt` (used only by lanes 30 and 31),
// for runs past one word or byte (shorter ones: the code is the hits).
// All 32 lanes must call it together (shuffles).
template <bool kCoarse>
__device__ __forceinline__ uint32_t row_hits(uint32_t cur, uint32_t nxt,
                                             int units, int lane) {
  // low nibble: this row's first word (coarse: the first 4 words) of
  // the lane; high nibble: the next row's
  const uint32_t nb = (cur & 15u) | (nxt & 15u) << 4;
  const uint32_t s1 = __shfl_sync(0xffffffffu, nb, (lane + 1) & 31);
  const uint32_t next1 = lane < 31 ? s1 & 15u : s1 >> 4;
  uint32_t h = 0;
  if (kCoarse) {
    uint32_t win = cur | next1 << 4;  // words 4l .. 4l + 7
    if (units > 4) {
      const uint32_t s2 = __shfl_sync(0xffffffffu, nb, (lane + 2) & 31);
      win |= (lane < 30 ? s2 & 15u : s2 >> 4) << 8;  // .. 4l + 11
    }
    const uint32_t want = (1u << units) - 1u;
#pragma unroll
    for (int k = 0; k < 4; ++k) h |= static_cast<uint32_t>(((win >> k) & want) == want) << k;
  } else {
    uint32_t s = cur | next1 << 16;  // bytes 16l .. 16l + 19
    s &= s >> 1;
    if (units >= 4) s &= s >> 2;
#pragma unroll
    for (int k = 0; k < 4; ++k) h |= static_cast<uint32_t>(((s >> (4 * k)) & 15u) != 0u) << k;
  }
  return h;
}

__device__ __forceinline__ void set_row(uint32_t (&bits)[4], uint32_t h, int r) {
#pragma unroll
  for (int k = 0; k < 4; ++k) bits[k] |= ((h >> k) & 1u) << r;
}

template <int NR, bool kCoarse, bool kNext>
__global__ void __launch_bounds__(kWarpThreads)
    alpharun_kernel(const uint4* __restrict__ words, const Ranges<NR> rg,
                    const int units, const int64_t groups,
                    int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                    int32_t* __restrict__ scratch, int32_t* __restrict__ total) {
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const bool valid = g < groups;
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    // row r of the group, this lane's 16 bytes: col[r * kRowVecs]. With
    // runs past the word, rows 1 .. 32 are read, and row r - 1 is
    // finished once row r's code is known.
    const uint4* col = words + g * kGroupRows * kRowVecs + lane + (kNext ? kRowVecs : 0);
    uint32_t prev = kNext ? row_code<NR, kCoarse, kNext>(__ldg(col - kRowVecs), rg) : 0u;
    uint4 q[kLoadRows];
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) q[i] = __ldg(col + i * kRowVecs);
    // the loop stays rolled: fully unrolled, the compiler (CUDA 12.8,
    // sm_90a) dropped bits of rows at batch edges
#pragma unroll 1
    for (int r0 = 0; r0 < kGroupRows; r0 += kLoadRows) {
      uint4 nq[kLoadRows] = {};  // the next batch, in flight while this one is tested
      if (r0 + kLoadRows < kGroupRows) {
#pragma unroll
        for (int i = 0; i < kLoadRows; ++i) nq[i] = __ldg(col + (r0 + kLoadRows + i) * kRowVecs);
      }
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) {
        const uint32_t cur = row_code<NR, kCoarse, kNext>(q[i], rg);
        if (kNext) {
          set_row(bits, row_hits<kCoarse>(prev, cur, units, lane), r0 + i);
          prev = cur;
        } else {
          set_row(bits, cur, r0 + i);
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) q[i] = nq[i];
    }
  }
  grab_count::warp_group_epilogue(bits, valid, g, bm, packed, scratch, total);
}

template <int NR>
cudaError_t launch(const uint4* w, const int32_t* lo, const int32_t* hi,
                   bool coarse, int units, int64_t groups, int32_t* bm,
                   int32_t* packed, int32_t* scratch, int32_t* total,
                   cudaStream_t st) {
  Ranges<NR> rg;
  for (int t = 0; t < NR; ++t) {
    rg.from[t] = Bound(lo[t]);
    rg.to[t] = Bound(hi[t] + 1);
  }
  const unsigned grid = grab_count::warp_grid(groups);
  const bool next = units > 1;
  if (coarse && next) {
    alpharun_kernel<NR, true, true><<<grid, kWarpThreads, 0, st>>>(
        w, rg, units, groups, bm, packed, scratch, total);
  } else if (coarse) {
    alpharun_kernel<NR, true, false><<<grid, kWarpThreads, 0, st>>>(
        w, rg, units, groups, bm, packed, scratch, total);
  } else if (next) {
    alpharun_kernel<NR, false, true><<<grid, kWarpThreads, 0, st>>>(
        w, rg, units, groups, bm, packed, scratch, total);
  } else {
    alpharun_kernel<NR, false, false><<<grid, kWarpThreads, 0, st>>>(
        w, rg, units, groups, bm, packed, scratch, total);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// words:   device int32 [32*groups + 8, 128], the last 8 rows zero,
//          16-byte aligned
// lo, hi:  HOST int32 [n_ranges], inclusive byte ranges (copied into the
//          launch); coarse != 0: units in {1, 2, 4, 8} words, else units
//          in {1, 2, 4} bytes
// bm:      device int32 [groups, 128]; packed: device int32 [groups];
// total:   device int32 [1], written by the kernel
// scratch: device int32 [2], zero, used by no other stream (left zero)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_alpharun_scan(const void* words, const int32_t* lo, const int32_t* hi,
                     int n_ranges, int coarse, int units, int64_t groups,
                     void* bm, void* packed, void* total, void* scratch,
                     int device, void* stream) {
  const bool units_ok =
      units == 1 || units == 2 || units == 4 || (coarse && units == 8);
  if (groups <= 0 || groups > 0x7fffffff || n_ranges < 1 ||
      n_ranges > kMaxRanges || !units_ok ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int t = 0; t < n_ranges; ++t) {
    if (lo[t] < 0 || hi[t] > 255 || lo[t] > hi[t]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint4* w = static_cast<const uint4*>(words);
  int32_t* b = static_cast<int32_t*>(bm);
  int32_t* p = static_cast<int32_t*>(packed);
  int32_t* s = static_cast<int32_t*>(scratch);
  int32_t* tot = static_cast<int32_t*>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = coarse != 0;
  switch (n_ranges) {
    case 1: err = launch<1>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    case 2: err = launch<2>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    case 3: err = launch<3>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    case 4: err = launch<4>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    case 5: err = launch<5>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    case 6: err = launch<6>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    case 7: err = launch<7>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
    default: err = launch<8>(w, lo, hi, c, units, groups, b, p, s, tot, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
