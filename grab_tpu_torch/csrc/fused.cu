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
//     16} literals, W in {1, 2} words, masked or not): the test of
//     coreword_test.cuh and corewords.cu;
//   - an XOR filter over the 7+-byte literals' core words, on word w
//     alone: xor_test.cuh, the test of xorfilter.cu;
//   - up to 32 class sequences: the range tests of classseq_test.cuh.
// Outputs, bit for bit as the TPU path produces them (word_epilogue.cuh):
// bm[g, c] bit r = hit at word (32g + r, c), packed[g] the OR of
// bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. The words are read once whatever the member count
// (33.6 MB per 32 MiB buffer, ~10 us at 3.35 TB/s); the integer work is
// the sum of the members': 4 * k * (W or 2W) ops per word and bucket,
// ~5 per XOR bank, and the class sequences' AND chains. Beyond a bucket
// or two it is bound by integer throughput.
//
// What the design does about it.
//   - Persistent blocks and a bulk-copy ring. The grid is as many blocks
//     as fit on the card at once; each walks 32-row groups g, g + grid,
//     .... Thread 0 keeps kStages group tiles in flight: 33 rows (the
//     group and the first row after it, which words w + 1 and w + 2 of
//     the group's last row reach) copied by cp.async.bulk, completing on
//     an mbarrier per stage. Every word is read from device memory once;
//     w + 1 and w + 2 come from shared memory.
//   - One thread per lane and group: each table entry or multiplier it
//     reads serves its whole 32-row bitmap word; the class sequences'
//     descriptor reads (constant memory, uniform across the warp, the
//     classes unrolled) serve 8 rows, whose chains need three planes each.
//   - Bucket shapes at compile time: each bucket dispatches to
//     bucket_hits<K, W, MASKED> (5 x 2 x 2 instantiations), whose
//     compare keeps per row the minimum of the masked differences (a
//     test hits when it is 0): 2W operations per (phase, literal) and
//     row, no compare or select per entry.
//   - The compare tables and the filter travel as one int32 program
//     (ops/fused.py fused_program) with no cap on the number of buckets
//     or filter groups: in shared memory beside the ring when it fits,
//     read from global memory at warp-uniform addresses otherwise.
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "classseq_test.cuh"
#include "word_epilogue.cuh"
#include "xor_test.cuh"

namespace {

using grab_word::kGroupRows;
using grab_word::SeqDesc;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kStages = 2;                              // group tiles in flight
constexpr int kTileWords = (kGroupRows + 1) * kLanes;   // the group + the next row
constexpr int kTileBytes = kTileWords * 4;              // 16896
constexpr int kMaxSmem = 227 * 1024 - 256;  // a block's shared memory, less the static part

// Program header (int32 words), shared with ops/fused.py fused_program:
//   [0] n_buckets  [1] offset of the XOR program, 0 = none
//   [2] planes: how many of the words w, w+1, w+2 the tests read
//   [3] 1 when the SeqDesc in constant memory applies
// then per bucket [k, n_words, masked, offset of its table], the tables
// ([2, 4, k, n_words] each) and the XOR program.
constexpr int kHeader = 4;

__constant__ SeqDesc c_desc;

// -- bulk copies and their barriers ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// tile ← kTileBytes from src; completes the barrier's current phase
__device__ __forceinline__ void bulk_load(uint32_t* tile, const uint32_t* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(kTileBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(tile)),
      "l"(src), "r"(kTileBytes), "r"(smem_addr(bar))
      : "memory");
}

// -- the tests, on a tile in shared memory --------------------------------

// One compare bucket against the 32 rows of lane c: tab is the bucket's
// table [val | mask][4 phases][K][W]. A (phase, literal) test hits a row
// when its masked difference is 0, so each row keeps the minimum.
template <int K, int W, bool MASKED>
__device__ __forceinline__ uint32_t bucket_hits(const uint32_t* __restrict__ tab,
                                                const uint32_t* tile, int c) {
  uint32_t x0[kGroupRows], x1[kGroupRows], mn[kGroupRows];
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) {
    x0[i] = tile[i * kLanes + c];
    x1[i] = W > 1 ? tile[i * kLanes + c + 1] : 0u;
    mn[i] = ~0u;
  }
  const uint32_t* mask = tab + 4 * K * W;
#pragma unroll 2
  for (int e = 0; e < 4 * K; ++e) {  // e = phase * K + literal
    const uint32_t v0 = tab[e * W], m0 = MASKED ? mask[e * W] : ~0u;
    const uint32_t v1 = W > 1 ? tab[e * W + 1] : 0u;
    const uint32_t m1 = (W > 1 && MASKED) ? mask[e * W + 1] : ~0u;
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      uint32_t d = MASKED ? (x0[i] ^ v0) & m0 : x0[i] ^ v0;
      if (W > 1) d |= MASKED ? (x1[i] ^ v1) & m1 : x1[i] ^ v1;
      mn[i] = min(mn[i], d);
    }
  }
  uint32_t hits = 0;
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) hits |= static_cast<uint32_t>(mn[i] == 0u) << i;
  return hits;
}

template <int K>
__device__ __forceinline__ uint32_t bucket_hits_k(const uint32_t* tab, int n_words, bool masked,
                                                  const uint32_t* tile, int c) {
  if (n_words > 1) {
    return masked ? bucket_hits<K, 2, true>(tab, tile, c) : bucket_hits<K, 2, false>(tab, tile, c);
  }
  return masked ? bucket_hits<K, 1, true>(tab, tile, c) : bucket_hits<K, 1, false>(tab, tile, c);
}

__device__ __forceinline__ uint32_t bucket_dispatch(const uint32_t* tab, int k, int n_words,
                                                    bool masked, const uint32_t* tile, int c) {
  switch (k) {
    case 1: return bucket_hits_k<1>(tab, n_words, masked, tile, c);
    case 2: return bucket_hits_k<2>(tab, n_words, masked, tile, c);
    case 4: return bucket_hits_k<4>(tab, n_words, masked, tile, c);
    case 8: return bucket_hits_k<8>(tab, n_words, masked, tile, c);
    default: return bucket_hits_k<16>(tab, n_words, masked, tile, c);
  }
}

// The XOR filter on word w of the 32 rows (xor_test.cuh, 32 rows per
// multiplier and bank read).
__device__ __forceinline__ uint32_t xor_hits(const grab_word::XorView& f, const uint32_t* tile,
                                             int c) {
  uint32_t x[kGroupRows];
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) x[i] = tile[i * kLanes + c];
  return grab_word::xor_members<kGroupRows>(x, f);
}

// The class sequences (classseq_test.cuh, the descriptor in constant
// memory), 8 rows per pass, on the rows not yet known to hit.
__device__ __forceinline__ uint32_t seq_hits(const uint32_t* tile, int c, bool three,
                                             uint32_t hits) {
  constexpr int kR = grab_word::kSeqRows;
#pragma unroll 1
  for (int r0 = 0; r0 < kGroupRows; r0 += kR) {
    uint32_t w0[kR], w1[kR], w2[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const uint32_t* q = tile + (r0 + i) * kLanes + c;
      w0[i] = q[0];
      w1[i] = q[1];
      w2[i] = three ? q[2] : 0u;
    }
    const uint32_t h = grab_word::classseq_hits(c_desc, w0, w1, w2, (hits >> r0) & 0xffu);
    hits |= h << r0;
  }
  return hits;
}

// Dynamic shared memory: the ring, its barriers and, when it fits, the
// program.
struct Layout {
  size_t bars, prog, total;
};

__host__ __device__ inline Layout layout(int64_t prog_words, bool in_shared) {
  Layout l;
  l.bars = static_cast<size_t>(kStages) * kTileBytes;
  l.prog = l.bars + kStages * sizeof(uint64_t);
  l.total = l.prog + (in_shared ? static_cast<size_t>(prog_words) * 4 : 0);
  return l;
}

__global__ void __launch_bounds__(kLanes)
    fused_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ prog,
                 const int prog_words, const int in_shared, const int seqs,
                 const int groups, int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                 int32_t* __restrict__ total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(prog_words, in_shared != 0);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const int c = threadIdx.x;
  const int n_mine = (groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto tile_of = [&](int i) {
    return words + static_cast<size_t>(blockIdx.x + static_cast<size_t>(i) * gridDim.x) *
                       kGroupRows * kLanes;
  };
  if (c == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < n_mine; ++i) {
      bulk_load(ring + i * kTileWords, tile_of(i), &full[i]);
    }
  }
  const uint32_t* p = prog;
  if (in_shared) {
    uint32_t* s_prog = reinterpret_cast<uint32_t*>(smem + lay.prog);
    for (int i = c; i < prog_words; i += kLanes) s_prog[i] = __ldg(prog + i);
    p = s_prog;
  }
  __syncthreads();
  const int n_buckets = static_cast<int>(p[0]);
  const uint32_t xor_off = p[1];
  const bool three = p[2] > 2;
  const uint32_t* buckets = p + kHeader;
  const grab_word::XorView filter(p + xor_off);  // read only when xor_off != 0

  for (int i = 0; i < n_mine; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], static_cast<uint32_t>(i / kStages) & 1u);
    const uint32_t* tile = ring + st * kTileWords;
    uint32_t hits = 0;
    for (int b = 0; b < n_buckets; ++b) {
      const uint32_t* h = buckets + 4 * b;
      hits |= bucket_dispatch(p + h[3], static_cast<int>(h[0]), static_cast<int>(h[1]),
                              h[2] != 0, tile, c);
    }
    if (xor_off) hits |= xor_hits(filter, tile, c);
    if (seqs) hits = seq_hits(tile, c, three, hits);
    const int g = blockIdx.x + i * gridDim.x;
    grab_word::row_bitmap_epilogue(hits, g, c, bm, packed, total);
    __syncthreads();  // the stage is read by every thread: refill it
    if (c == 0 && i + kStages < n_mine) bulk_load(ring + st * kTileWords, tile_of(i + kStages), &full[st]);
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

// words:  device int32 [32*groups + 8, 128], the last 8 rows zero, 16-byte
//         aligned
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
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
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
  const bool in_shared = layout(prog_words, true).total <= static_cast<size_t>(kMaxSmem);
  const size_t smem = layout(prog_words, in_shared).total;
  err = cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel, kLanes, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = grab_word::zero_total(total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(groups < resident ? groups : resident);
  fused_kernel<<<grid, kLanes, smem, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(prog),
      static_cast<int>(prog_words), in_shared ? 1 : 0, desc != nullptr ? 1 : 0,
      static_cast<int>(groups), static_cast<int32_t*>(bm),
      static_cast<int32_t*>(packed), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
