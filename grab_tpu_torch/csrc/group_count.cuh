// Epilogues of the word kernels that count `total` without a memset
// (alpharun.cu, classseq.cu, xorfilter.cu).
//
// The int32 word buffer [rows + 8, 128] is cut into 32-row groups; a
// kernel builds each lane's bitmap word of a group in registers (bit r =
// hit at row r) and writes, bit for bit as the TPU path produces them
// (the same outputs as word_epilogue.cuh):
//   bm[g, c]   the bitmap word of lane c
//   packed[g]  OR of bm[g, :]
//   total      the number of nonzero packed[g]
// `total` needs no memset on the stream before the launch: each block
// adds its count into a two-word device scratch (count, blocks done), and
// the last block to finish moves the count into `total` and leaves the
// scratch at zero for the next launch. One 64-bit atomic add carries both
// words, so no fence orders them. Launches that share a scratch must
// therefore run one after another: the wrappers keep one scratch per
// (device, stream), zeroed once (ops/corewords.py count_scratch).
//
// Two geometries:
//   warp per group (warp_group_epilogue): lane l owns words 4l .. 4l + 3
//     of each row (one 16-byte load per row), a block kWarps groups; a
//     persistent block that walks several groups per warp stores each
//     with warp_group_store and counts once, at its end, with block_count;
//   block per group (lane_group_epilogue): thread c owns word c of each
//     row, a block of kWordLanes threads one group.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace grab_count {

constexpr int kWordLanes = 128;  // words per row (one candidate block)
constexpr int kGroupRows = 32;   // rows folded into one bitmap word
constexpr int kRowVecs = kWordLanes / 4;  // 16-byte vectors per row
constexpr int kWarps = 8;        // groups per block, warp per group
constexpr int kWarpThreads = 32 * kWarps;

// Blocks of the warp-per-group geometry.
inline unsigned warp_grid(int64_t groups) {
  return static_cast<unsigned>((groups + kWarps - 1) / kWarps);
}

// Thread 0 of each block, once: add the block's nonzero groups (low
// word of the 8-byte scratch) and count the block done (high word); the
// last block moves the sum into `total` and zeroes the scratch. The count
// stays below 2^31, so the low word never carries into the high one.
__device__ __forceinline__ void finish_count(int n, int32_t* __restrict__ scratch,
                                             int32_t* __restrict__ total) {
  unsigned long long* both = reinterpret_cast<unsigned long long*>(scratch);
  const unsigned long long was =
      atomicAdd(both, (1ull << 32) | static_cast<unsigned>(n));
  if ((was >> 32) == gridDim.x - 1) {
    *total = static_cast<int32_t>(static_cast<uint32_t>(was) + static_cast<uint32_t>(n));
    atomicExch(both, 0ull);
  }
}

// Warp per group: the outputs of group g from the bitmap words of the
// warp's 32 lanes (bits[k]: lane 4 * (threadIdx.x % 32) + k). Called by
// the whole warp; → whether the group has a hit, in every lane.
__device__ __forceinline__ bool warp_group_store(const uint32_t (&bits)[4], int64_t g,
                                                 int32_t* __restrict__ bm,
                                                 int32_t* __restrict__ packed) {
  const int lane = threadIdx.x & 31;
  reinterpret_cast<uint4*>(bm + g * kWordLanes)[lane] =
      make_uint4(bits[0], bits[1], bits[2], bits[3]);
  const uint32_t any = __reduce_or_sync(0xffffffffu, bits[0] | bits[1] | bits[2] | bits[3]);
  if (lane == 0) packed[g] = static_cast<int32_t>(any);
  return any != 0u;
}

// Warp per group: the block's count. Called by every thread of the block
// exactly once; n is the number of groups with a hit that the thread's
// warp stored (read from lane 0).
__device__ __forceinline__ void block_count(int n, int32_t* __restrict__ scratch,
                                            int32_t* __restrict__ total) {
  __shared__ int32_t hit_groups[kWarps];
  if ((threadIdx.x & 31) == 0) hit_groups[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += hit_groups[w];
    finish_count(sum, scratch, total);
  }
}

// Warp per group, one group per warp. Called by every thread of the
// block exactly once. bits[k] is the bitmap word of lane
// 4 * (threadIdx.x % 32) + k of group g; valid is false for the warps
// past the last group.
__device__ __forceinline__ void warp_group_epilogue(
    const uint32_t (&bits)[4], bool valid, int64_t g,
    int32_t* __restrict__ bm, int32_t* __restrict__ packed,
    int32_t* __restrict__ scratch, int32_t* __restrict__ total) {
  const bool hit = valid && warp_group_store(bits, g, bm, packed);
  block_count(hit ? 1 : 0, scratch, total);
}

// Block per group (group g = blockIdx.x). Called by all kWordLanes
// threads of the block once; bits is thread c's bitmap word.
__device__ __forceinline__ void lane_group_epilogue(
    uint32_t bits, int64_t g, int c, int32_t* __restrict__ bm,
    int32_t* __restrict__ packed, int32_t* __restrict__ scratch,
    int32_t* __restrict__ total) {
  __shared__ uint32_t warp_or[kWordLanes / 32];
  bm[g * kWordLanes + c] = static_cast<int32_t>(bits);
  const uint32_t w_or = __reduce_or_sync(0xffffffffu, bits);
  if ((c & 31) == 0) warp_or[c >> 5] = w_or;
  __syncthreads();
  if (c == 0) {
    const uint32_t any = warp_or[0] | warp_or[1] | warp_or[2] | warp_or[3];
    packed[g] = static_cast<int32_t>(any);
    finish_count(any != 0u, scratch, total);
  }
}

}  // namespace grab_count
