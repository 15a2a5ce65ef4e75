// Fused literal/class-sequence ensemble for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_fused.py
// fused_word_bitmap (Pallas body _build_kernel) together with the lane-OR
// of packed_block_flags that follows it in XLA.
//
// What it computes. One pass over the int32 word buffer [rows + 8, 128]
// (one 512-byte candidate block per row, 8 zero pad rows after it) that
// ORs three kinds of test into one row bitmap:
//   - any number of core-word compare buckets, each (k in {1, 2, 4, 8,
//     16} literals, W in {1, 2} words, masked or not): coreword_test.cuh,
//     the test of corewords.cu;
//   - an XOR filter over the 7+-byte literals' core words, on word w
//     alone: xor_test.cuh, the test of xorfilter.cu;
//   - up to 32 class sequences: classseq_test.cuh, the test of
//     classseq.cu.
// Outputs, bit for bit as the TPU path produces them (word_epilogue.cuh):
// bm[g, c] bit r = hit at word (32g + r, c), packed[g] the OR of
// bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. The words are read once whatever the member count
// (33.6 MB per 32 MiB buffer, ~10 us at 3.35 TB/s); the integer work is
// the sum of the members': 4 * k * (W or 2W) ops per word and bucket,
// ~5 per XOR bank, and the class sequences' data-dependent AND chains.
// Beyond a bucket or two it is bound by integer throughput.
//
// What the design does about it. On the TPU the bucket shapes, hash
// multipliers and sequences were trace-time structure, one compiled
// kernel per ensemble; here they are runtime data, one kernel for all.
// The compare tables and the filter travel as one int32 program
// (ops/fused.py fused_program) with no cap on the number of buckets or
// filter groups: a block copies the program into shared memory when it
// fits (a 100-literal filter with a few buckets is a few KiB; 63 full
// buckets are 63 KiB) and reads it from global memory at warp-uniform
// addresses otherwise, through the same pointer. The sequences are a
// SeqDesc in __constant__ memory as in classseq.cu. A thread reads words
// w, w + 1 and w + 2 directly (the TPU kernel built shifted planes with
// lane rolls) for 8 rows at a time, so every table entry it reads is used
// for 8 words, and a block walks several 32-row groups (grid-stride), so
// the program is copied once per block. The runtime loops over buckets do
// not unroll the way corewords.cu's templates do.
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "classseq_test.cuh"
#include "coreword_test.cuh"
#include "word_epilogue.cuh"
#include "xor_test.cuh"

namespace {

using grab_word::kGroupRows;
using grab_word::SeqDesc;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kRows = grab_word::kSeqRows;
constexpr int kMaxBlocks = 132 * 8;
constexpr int64_t kSharedLimit = 200 * 1024;  // of 227 KiB a block may use

// Program header (int32 words), shared with ops/fused.py fused_program:
//   [0] n_buckets  [1] offset of the XOR program, 0 = none
//   [2] planes: how many of the words w, w+1, w+2 the tests read
//   [3] 1 when the SeqDesc in constant memory applies
// then per bucket [k, n_words, masked, offset of its table], the tables
// ([2, 4, k, n_words] each) and the XOR program.
constexpr int kHeader = 4;

__constant__ SeqDesc c_desc;

__global__ void __launch_bounds__(kLanes)
    fused_kernel(const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ prog, const int prog_words,
                 const int in_shared, const int groups,
                 int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                 int32_t* __restrict__ total) {
  extern __shared__ uint32_t s_prog[];
  const int c = threadIdx.x;
  const uint32_t* p = prog;
  if (in_shared) {
    for (int i = c; i < prog_words; i += kLanes) s_prog[i] = __ldg(prog + i);
    __syncthreads();
    p = s_prog;
  }
  const int n_buckets = static_cast<int>(p[0]);
  const uint32_t xor_off = p[1];
  const bool two = p[2] > 1, three = p[2] > 2;
  const bool seqs = p[3] != 0;
  const uint32_t* buckets = p + kHeader;
  const grab_word::XorView filter(p + xor_off);  // read only when xor_off != 0
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const uint32_t* col =
        words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
    uint32_t bits = 0;
    for (int r0 = 0; r0 < kGroupRows; r0 += kRows) {
      uint32_t w0[kRows], w1[kRows], w2[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const uint32_t* q = col + (r0 + i) * kLanes;
        w0[i] = __ldg(q);
        w1[i] = two ? __ldg(q + 1) : 0u;
        w2[i] = three ? __ldg(q + 2) : 0u;
      }
      uint32_t hits = 0;  // bit i: row r0 + i hit
      for (int b = 0; b < n_buckets; ++b) {
        const uint32_t* h = buckets + 4 * b;
        hits |= grab_word::core_bucket_hits<kRows>(
            p + h[3], static_cast<int>(h[0]), static_cast<int>(h[1]),
            h[2] != 0, w0, w1);
      }
      if (xor_off) hits |= grab_word::xor_members<kRows>(w0, filter);
      if (seqs) hits = grab_word::classseq_hits(c_desc, w0, w1, w2, hits);
      bits |= hits << r0;
    }
    grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
    __syncthreads();
  }
}

// The program's structure, checked on the host copy before the launch.
bool program_valid(const uint32_t* p, int64_t n, bool has_desc) {
  if (n < kHeader) return false;
  const int64_t nb = p[0], xo = p[1];
  if (p[2] < 1 || p[2] > 3 || (p[3] != 0) != has_desc) return false;
  if (kHeader + 4 * nb > n) return false;
  for (int64_t b = 0; b < nb; ++b) {
    const uint32_t* h = p + kHeader + 4 * b;
    const int64_t k = h[0], w = h[1], off = h[3];
    if (!(k == 1 || k == 2 || k == 4 || k == 8 || k == 16)) return false;
    if (w < 1 || w > 2 || w > p[2]) return false;
    if (off < kHeader + 4 * nb || off + 8 * k * w > n) return false;
  }
  if (xo) {
    if (xo < kHeader + 4 * nb || xo >= n) return false;
    if (grab_word::xor_program_words(p + xo, n - xo) != n - xo) return false;
  }
  return nb > 0 || xo != 0 || has_desc;
}

}  // namespace

extern "C" {

// words:  device int32 [32*groups + 8, 128], the last 8 rows zero
// prog:   DEVICE int32 program (see kHeader); host_prog: the same words on
//         the host, read here to check the structure
// desc:   HOST bytes of a SeqDesc (pinned, so the copy is asynchronous),
//         or null when the ensemble has no class sequences
// bm:     device int32 [groups, 128]; packed: device int32 [groups];
// total:  device int32 [1] (zeroed here, on the stream, before the kernel)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_fused_scan(const void* words, const void* prog,
                  const uint32_t* host_prog, int64_t prog_words,
                  const void* desc, int64_t desc_bytes, int64_t groups,
                  void* bm, void* packed, void* total, int device,
                  void* stream) {
  if (groups <= 0 || groups > 0x7fffffff || prog_words > 0x7fffffff ||
      (desc != nullptr && !grab_word::seq_desc_valid(desc, desc_bytes)) ||
      !program_valid(host_prog, prog_words, desc != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (desc != nullptr) {
    err = cudaMemcpyToSymbolAsync(c_desc, desc, sizeof(SeqDesc), 0,
                                  cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t bytes = prog_words * 4;
  const bool in_shared = bytes <= kSharedLimit;
  const size_t smem = in_shared ? static_cast<size_t>(bytes) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSharedLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = grab_word::zero_total(total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(groups < kMaxBlocks ? groups : kMaxBlocks);
  fused_kernel<<<grid, kLanes, smem, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(prog),
      static_cast<int>(prog_words), in_shared ? 1 : 0,
      static_cast<int>(groups), static_cast<int32_t*>(bm),
      static_cast<int32_t*>(packed), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
