// Bloom core-word prefilter for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_bloom.py
// bloom_word_bitmap (Pallas body _build_kernel) together with the lane-OR
// of packed_block_flags that follows it in XLA.
//
// What it computes. The scan buffer is viewed as int32 words
// [rows + 8, 128] (one 512-byte candidate block per row; the pad rows are
// not read: no test looks at a neighbouring word). Every literal of 7+
// bytes contributes, for each of the 4 byte phases, one aligned word that
// lies wholly inside it; each such key sets one bit in each of L <= 6
// independent 4096-bit tables (128 words of 32 bits per level). A buffer
// word x passes when, for every level l,
//   h = x * C_l mod 2^32;  (tbl[l][h >> 25] >> ((h >> 20) & 31)) & 1
// is set. Outputs, bit for bit as the TPU path produces them
// (word_epilogue.cuh): bm[g, c] bit r = hit at word (32g + r, c),
// packed[g] the OR of bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. Each word is read once (33.6 MB per 32 MiB buffer,
// ~10 us at 3.35 TB/s). Per word and level: a multiply, two shifts and a
// mask for the two hash fields, a shared-memory read at a data-dependent
// slot, a shift by the bit index and an AND: about 6 integer operations,
// so 5 levels (100 literals) are ~30 per word, above the bytes bound; the
// random slots also cost shared-memory bank conflicts.
//
// What the design does about it. On the TPU a level was one lane gather
// of a broadcast table row. Here the whole table (at most 6 x 128 words,
// 3 KiB) sits in shared memory, copied once per block (a random
// per-thread index would serialise in __constant__ memory); a block of
// 128 threads walks several 32-row groups (grid-stride), so the copy is
// paid once per block. A thread tests 8 rows per level, so the 8
// dependent hash -> shared read chains overlap. The level count is a
// template parameter: the loop unrolls and the multipliers are
// immediates.
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "word_epilogue.cuh"

namespace {

using grab_word::kGroupRows;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kSlots = 128;  // table words per level
constexpr int kRows = 8;     // rows tested together per level
constexpr int kMaxLevels = 6;
constexpr int kMaxBlocks = 132 * 8;

// the levels' odd multipliers (ops/bloom.py _HASH_CONSTS)
__host__ __device__ constexpr uint32_t hash_const(int l) {
  return l == 0   ? 0x9E3779B1u
         : l == 1 ? 0x85EBCA77u
         : l == 2 ? 0xC2B2AE3Du
         : l == 3 ? 0x27D4EB2Fu
         : l == 4 ? 0x165667B1u
                  : 0x9E3779B9u;
}

template <int L>
__global__ void __launch_bounds__(kLanes)
    bloom_kernel(const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ tbl, const int groups,
                 int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                 int32_t* __restrict__ total) {
  __shared__ uint32_t s_tbl[L * kSlots];
  const int c = threadIdx.x;
  for (int i = c; i < L * kSlots; i += kLanes) s_tbl[i] = __ldg(tbl + i);
  __syncthreads();
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const uint32_t* col =
        words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
    uint32_t bits = 0;
    for (int r0 = 0; r0 < kGroupRows; r0 += kRows) {
      uint32_t x[kRows], acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        x[i] = __ldg(col + (r0 + i) * kLanes);
        acc[i] = 1u;
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t cl = hash_const(l);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const uint32_t h = x[i] * cl;
          acc[i] &= s_tbl[l * kSlots + (h >> 25)] >> ((h >> 20) & 31u);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) bits |= (acc[i] & 1u) << (r0 + i);
    }
    grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
    __syncthreads();
  }
}

template <int L>
cudaError_t launch(const void* words, const void* tbl, int64_t groups, void* bm,
                   void* packed, void* total, cudaStream_t st) {
  const unsigned grid =
      static_cast<unsigned>(groups < kMaxBlocks ? groups : kMaxBlocks);
  bloom_kernel<L><<<grid, kLanes, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(tbl),
      static_cast<int>(groups), static_cast<int32_t*>(bm),
      static_cast<int32_t*>(packed), static_cast<int32_t*>(total));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// words:  device int32 [32*groups + 8, 128]
// tbl:    device int32 [levels, 128], levels in 1..6
// bm:     device int32 [groups, 128]; packed: device int32 [groups];
// total:  device int32 [1] (zeroed here, on the stream, before the kernel)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_bloom_scan(const void* words, const void* tbl, int levels, int64_t groups,
                  void* bm, void* packed, void* total, int device,
                  void* stream) {
  if (groups <= 0 || groups > 0x7fffffff || levels < 1 || levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = grab_word::zero_total(total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (levels) {
    case 1: err = launch<1>(words, tbl, groups, bm, packed, total, st); break;
    case 2: err = launch<2>(words, tbl, groups, bm, packed, total, st); break;
    case 3: err = launch<3>(words, tbl, groups, bm, packed, total, st); break;
    case 4: err = launch<4>(words, tbl, groups, bm, packed, total, st); break;
    case 5: err = launch<5>(words, tbl, groups, bm, packed, total, st); break;
    default: err = launch<6>(words, tbl, groups, bm, packed, total, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
