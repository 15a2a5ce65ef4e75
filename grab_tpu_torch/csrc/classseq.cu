// Class-sequence prefilter for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_classseq.py
// classseq_word_bitmap (Pallas body _build_kernel) together with the
// lane-OR of packed_block_flags that follows it in XLA.
//
// What it computes. The scan buffer is viewed as int32 words
// [rows + 8, 128] (one 512-byte candidate block per row, 8 zero pad rows
// after it). A sequence is up to 8 byte classes, each class up to 8
// inclusive byte ranges. Byte position i is a hit when, for some
// sequence, byte i + j lies in class j for every j; a word is a hit when
// any of its 4 byte positions is (the word holds the start byte). Bytes
// past the buffer read the zero pad rows. Outputs, bit for bit as the
// TPU path produces them (word_epilogue.cuh):
//   bm[g, c]   bit r = hit at word (32g + r, c)
//   packed[g]  OR of bm[g, :] over the 128 lanes
//   total      number of nonzero packed[g]
//
// What bounds it. Each word is read once (words w+1 and w+2, which hold
// bytes 4..11 of the window, are the same or the next cache line), so a
// 32 MiB buffer moves ~33.6 MB: ~10 us at 3.35 TB/s. The integer work is
// data dependent: a (sequence, phase) test stops at its first class that
// fails, so on text most words cost one class test per sequence (the 4
// phases at once); a buffer where the sequences' leading classes match
// everywhere costs up to the full AND chains.
//
// What the design does about it. The TPU kernel rolled lanes to build 3
// word planes and memoized every (byte position, class) test at trace
// time; here thread c of a block reads word (r, c) and the next two
// flat words directly (lane 127 reads the next row's lanes 0 and 1, the
// last row the zero pad rows), and the sequences are runtime data in
// __constant__ memory: every thread of a warp reads the same descriptor
// entry, which the constant cache broadcasts. The 4 phases are tested
// at once: class j of a sequence applies to window bytes j..j+3 (one
// funnel shift of the window), and a range test on 4 bytes is a SWAR
// compare into each byte's high bit (ge(lo) & ~ge(hi + 1), as the TPU
// path's alphabet-run kernel does it), ~6 ops for the 4 phases. A thread
// tests 8 rows against each range it reads from the descriptor, so the
// constant-cache reads (the limit when there are many sequences) are
// shared by 8 words, and the 8 rows' loads are in flight together. A
// sequence's AND chain stops when no phase of the 8 rows is left, and
// the rows at their first matching sequence, so the test costs what the
// data needs. The epilogue (row bitmap, lane-OR, exact count) is shared
// with corewords.cu.
//
// The descriptor is copied into __constant__ memory on the caller's
// stream right before the launch (cudaMemcpyToSymbolAsync from the
// wrapper's pinned copy), so launches of different sequence sets queued
// on one stream each see their own. The kernel allocates nothing; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "classseq_test.cuh"
#include "word_epilogue.cuh"

namespace {

using grab_word::kGroupRows;
using grab_word::SeqDesc;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kRows = grab_word::kSeqRows;

__constant__ SeqDesc c_desc;

__global__ void __launch_bounds__(kLanes)
    classseq_kernel(const uint32_t* __restrict__ words,
                    int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                    int32_t* __restrict__ total) {
  const int g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* col =
      words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
  const bool two = c_desc.span + 3 > 4;  // window reaches word w+1
  const bool three = c_desc.span + 3 > 8;  // ... and word w+2
  uint32_t bits = 0;
  for (int r0 = 0; r0 < kGroupRows; r0 += kRows) {
    uint32_t w0[kRows], w1[kRows], w2[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint32_t* p = col + (r0 + i) * kLanes;
      w0[i] = __ldg(p);
      w1[i] = two ? __ldg(p + 1) : 0u;
      w2[i] = three ? __ldg(p + 2) : 0u;
    }
    // bit i: row r0 + i hit
    const uint32_t hits = grab_word::classseq_hits(c_desc, w0, w1, w2, 0u);
    bits |= hits << r0;
  }
  grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
}

}  // namespace

extern "C" {

// words:  device int32 [32*groups + 8, 128], the last 8 rows zero
// desc:   HOST bytes of a SeqDesc (pinned, so the copy is asynchronous)
// bm:     device int32 [groups, 128]; packed: device int32 [groups];
// total:  device int32 [1] (zeroed here, on the stream, before the kernel)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_classseq_scan(const void* words, const void* desc, int64_t desc_bytes,
                     int64_t groups, void* bm, void* packed, void* total,
                     int device, void* stream) {
  if (groups <= 0 || groups > 0x7fffffff ||
      !grab_word::seq_desc_valid(desc, desc_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemcpyToSymbolAsync(c_desc, desc, sizeof(SeqDesc), 0,
                                cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = grab_word::zero_total(total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  classseq_kernel<<<static_cast<unsigned>(groups), kLanes, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(bm),
      static_cast<int32_t*>(packed), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
