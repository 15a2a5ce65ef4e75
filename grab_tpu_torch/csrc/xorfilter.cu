// XOR-filter core-word prefilter for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_xorfilter.py
// xor_word_bitmap (Pallas body _build_kernel + xor_member_test) together
// with the lane-OR of packed_block_flags that follows it in XLA.
//
// What it computes. The scan buffer is viewed as int32 words
// [rows + 8, 128] (one 512-byte candidate block per row; the pad rows are
// not read). Every literal of 7+ bytes contributes, for each of the 4
// byte phases, one aligned word that lies wholly inside it; the filter
// answers exact membership of a buffer word x in that key set: for some
// group g of arity a_g in 1..4,
//   XOR_b bank[base_g + b][(x * c_b mod 2^32) >> 25] == x
// over banks of 128 slots (false positives ~2^-32 per group and word).
// Outputs, bit for bit as the TPU path produces them (word_epilogue.cuh):
// bm[g, c] bit r = hit at word (32g + r, c), packed[g] the OR of
// bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. Each word is read once (33.6 MB per 32 MiB buffer,
// ~10 us at 3.35 TB/s). Per word and bank: a multiply, a shift, a
// shared-memory read at a data-dependent slot and an XOR, plus a compare
// per group; 100 literals are 5 banks (~25 ops and 5 shared reads per
// word), 1000 literals 44. Small sets are bound by bytes, large ones by
// integer throughput and the shared reads' bank conflicts (random slots).
//
// What the design does about it. On the TPU the table rows were gathered
// along lanes, one broadcast row per bank; here the whole filter (arities,
// multipliers, bank rows: 2.6 KiB for 100 literals, 22 KiB for 1000) is
// one int32 program that every block copies into shared memory once, so a
// lookup is one shared read. A block of 128 threads then walks several
// 32-row groups (a grid-stride loop), so the copy is paid once per block,
// not once per 16 KiB of corpus. A thread tests 8 rows against each bank
// it reads, so the 8 lookups' latencies overlap and the arities and
// multipliers are read once for 8 words. A filter too large for shared memory is
// read from global memory by the same code (no cap on the literal count).
// The membership test is xor_test.cuh, shared with fused.cu.
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "word_epilogue.cuh"
#include "xor_test.cuh"

namespace {

using grab_word::kGroupRows;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kRows = 8;  // rows tested together per filter entry read
constexpr int kMaxBlocks = 132 * 8;
constexpr int64_t kSharedLimit = 200 * 1024;  // of 227 KiB a block may use

__global__ void __launch_bounds__(kLanes)
    xor_kernel(const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ prog, const int prog_words,
               const int in_shared, const int groups, int32_t* __restrict__ bm,
               int32_t* __restrict__ packed, int32_t* __restrict__ total) {
  extern __shared__ uint32_t s_prog[];
  const int c = threadIdx.x;
  const uint32_t* p = prog;
  if (in_shared) {
    for (int i = c; i < prog_words; i += kLanes) s_prog[i] = __ldg(prog + i);
    __syncthreads();
    p = s_prog;
  }
  const grab_word::XorView filter(p);
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const uint32_t* col =
        words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
    uint32_t bits = 0;
    for (int r0 = 0; r0 < kGroupRows; r0 += kRows) {
      uint32_t x[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) x[i] = __ldg(col + (r0 + i) * kLanes);
      bits |= grab_word::xor_members<kRows>(x, filter) << r0;
    }
    grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// words:  device int32 [32*groups + 8, 128]
// prog:   DEVICE int32 filter program (xor_test.cuh); host_prog: the same
//         words on the host, read here to check the header
// bm:     device int32 [groups, 128]; packed: device int32 [groups];
// total:  device int32 [1] (zeroed here, on the stream, before the kernel)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_xor_scan(const void* words, const void* prog, const uint32_t* host_prog,
                int64_t prog_words, int64_t groups, void* bm, void* packed,
                void* total, int device, void* stream) {
  if (groups <= 0 || groups > 0x7fffffff || prog_words > 0x7fffffff ||
      grab_word::xor_program_words(host_prog, prog_words) != prog_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bytes = prog_words * 4;
  const bool in_shared = bytes <= kSharedLimit;
  const size_t smem = in_shared ? static_cast<size_t>(bytes) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(xor_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSharedLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = grab_word::zero_total(total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(groups < kMaxBlocks ? groups : kMaxBlocks);
  xor_kernel<<<grid, kLanes, smem, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(prog),
      static_cast<int>(prog_words), in_shared ? 1 : 0,
      static_cast<int>(groups), static_cast<int32_t*>(bm),
      static_cast<int32_t*>(packed), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
