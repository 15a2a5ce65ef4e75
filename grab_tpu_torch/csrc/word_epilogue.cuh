// Shared epilogue of the word-bitmap kernels (corewords.cu, fused.cu,
// bloom.cu; alpharun.cu, classseq.cu and xorfilter.cu use group_count.cuh).
//
// Each kernel runs one block of kWordLanes threads per 32-row group of
// the int32 word buffer [rows + 8, 128]: thread c walks the group's 32
// rows at lane c and builds its bitmap word in a register (bit r = hit
// at word (32g + r, c)). This epilogue writes, bit for bit as the TPU
// path produces them (pallas_corewords._bitmap_rows + the XLA lane-OR
// of packed_block_flags):
//   bm[g, c]   the thread's bitmap word
//   packed[g]  OR of bm[g, :] over the 128 lanes (one __reduce_or_sync
//              per warp, then four shared words)
//   total      number of nonzero packed[g], an exact atomicAdd count, so
//              the result is deterministic
// The C entry points zero `total` on the stream before the launch
// (zero_total).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace grab_word {

constexpr int kWordLanes = 128;  // words per row (one candidate block)
constexpr int kGroupRows = 32;   // rows folded into one bitmap word

// Must be called by all kWordLanes threads of the block. A kernel that
// calls it for several groups in a loop puts a __syncthreads() between
// two calls (warp_or is reused).
__device__ __forceinline__ void row_bitmap_epilogue(
    uint32_t bits, int g, int c, int32_t* __restrict__ bm,
    int32_t* __restrict__ packed, int32_t* __restrict__ total) {
  bm[static_cast<size_t>(g) * kWordLanes + c] = static_cast<int32_t>(bits);
  __shared__ uint32_t warp_or[kWordLanes / 32];
  const uint32_t w_or = __reduce_or_sync(0xffffffffu, bits);
  if ((c & 31) == 0) warp_or[c >> 5] = w_or;
  __syncthreads();
  if (c == 0) {
    const uint32_t any = warp_or[0] | warp_or[1] | warp_or[2] | warp_or[3];
    packed[g] = static_cast<int32_t>(any);
    if (any) atomicAdd(total, 1);
  }
}

inline cudaError_t zero_total(void* total, cudaStream_t stream) {
  return cudaMemsetAsync(total, 0, sizeof(int32_t), stream);
}

}  // namespace grab_word
