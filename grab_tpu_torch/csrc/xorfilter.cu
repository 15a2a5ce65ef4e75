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
// Outputs, bit for bit as the TPU path produces them (group_count.cuh):
// bm[g, c] bit r = hit at word (32g + r, c), packed[g] the OR of
// bm[g, :], total the number of nonzero packed[g].
//
// What bounds it. Each word is read once (33.6 MB per 32 MiB buffer,
// ~10 us at 3.35 TB/s). Per word and bank: a multiply, a shift, a mask,
// a shared-memory read at a data-dependent slot and an XOR; per group a
// compare. 100 literals are 4 + 1 banks, 1000 literals 43. The first
// version (one compact copy of the filter in shared memory, a block of
// 128 threads per 32-row group, 4-byte loads, a memset of `total`
// before each launch) added ~0.0035 ms per bank and 32 MiB at every bank
// count on the H100, 9.2 lookups per SM cycle: more than its integer
// work explains, and close to what bank conflicts allow. 32 lanes that
// read random slots of one 128-word row need 2.78 shared-memory
// wavefronts per read (a simulation; a same-slot read is a broadcast),
// 11.5 lookups per SM cycle at most. With no conflict the cap is 32.
//
// What the design does about it.
//   * Bank copies: each block expands the bank rows into shared memory
//     as C interleaved copies (xor_test.cuh copied_group): C = 32, one
//     wavefront per read, or 16, two (by the same simulation, 2, 4 and 8
//     copies conflict as much as 1). The host takes the most copies of 32, 16
//     and 1 that fit kSharedLimit (ops/xorfilter.py bank_copies): on the
//     card, 32 copies and one block per SM beat 16 copies and two. A
//     filter larger than kSharedLimit is read from global memory by the
//     same code (no cap on the literal count). The header (arities,
//     multipliers) stays one copy, read by broadcast.
//   * Geometry: a warp per 32-row group, lane l owns words 4l .. 4l + 3
//     of each row (one 16-byte load), 8 rows loaded at once and tested
//     in two passes of 4 over the filter while the next 8 are in flight
//     (registers: see batch_hits); persistent blocks of 8 warps, as many
//     as fit the card, so the expansion is paid once per block, and the
//     block's first loads go out before it. `total` is counted through a
//     per-stream scratch (group_count.cuh): no stream operation before
//     the launch.
//   * Compile-time shapes: the construction makes full 4-bank groups and
//     one remainder group of arity R (ops/xorfilter.py), so the 4-bank
//     body is unrolled and R is a template parameter; a program of any
//     other shape (the construction's split fallback) takes a loop that
//     dispatches each group's arity (kRem = 0).
// The 8-row batch loop stays rolled (#pragma unroll 1) and the next
// batch's loads are overlapped by hand: fully unrolled, the warp-per-group
// kernels of alpharun.cu and classseq.cu were miscompiled (CUDA 12.8).
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "group_count.cuh"
#include "xor_test.cuh"

namespace {

using grab_count::kGroupRows;
using grab_count::kRowVecs;
using grab_count::kWarpThreads;
using grab_count::kWarps;
using grab_word::kXorSlots;
constexpr int kLoadRows = 8;  // rows per load batch (two batches in registers)
constexpr int kPassRows = 4;  // rows per pass over the filter
constexpr int64_t kSharedLimit = 200 * 1024;  // of 227 KiB a block may use

// Shared memory: the header (arities, multipliers: prog[2 ..]) padded to
// 16 bytes, then the expanded bank rows.
__host__ __device__ inline int64_t head_words(int64_t n_groups, int64_t n_rows) {
  return (n_groups + n_rows + 3) & ~int64_t{3};
}

__device__ __forceinline__ void load_rows(uint4 (&q)[kLoadRows], const uint4* __restrict__ words,
                                          int64_t g, int r0, int lane) {
  const uint4* col = words + (g * kGroupRows + r0) * kRowVecs + lane;
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) q[i] = __ldg(col + i * kRowVecs);
}

// Membership of the lane's 4 x 4 words in the whole filter: bit i of
// hk[k] for word k of row i.
template <int kLogC, int kRem, bool kGlobal>
__device__ __forceinline__ void pass_hits(const uint4 (&q)[kPassRows], const uint32_t* arity,
                                          const uint32_t* c, const uint32_t* bank,
                                          int n_groups, uint32_t (&hk)[4]) {
  constexpr int kRow = kXorSlots << kLogC;
  if constexpr (kRem > 0) {
#pragma unroll 1
    for (int g = 1; g < n_groups; ++g) {  // the full groups
      grab_word::copied_group<4, kLogC, kGlobal>(q, c, bank, hk);
      c += 4;
      bank += 4 * kRow;
    }
    grab_word::copied_group<kRem, kLogC, kGlobal>(q, c, bank, hk);
  } else {
#pragma unroll 1
    for (int g = 0; g < n_groups; ++g) {
      const int a = static_cast<int>(arity[g]);
      switch (a) {
        case 1: grab_word::copied_group<1, kLogC, kGlobal>(q, c, bank, hk); break;
        case 2: grab_word::copied_group<2, kLogC, kGlobal>(q, c, bank, hk); break;
        case 3: grab_word::copied_group<3, kLogC, kGlobal>(q, c, bank, hk); break;
        default: grab_word::copied_group<4, kLogC, kGlobal>(q, c, bank, hk); break;
      }
      c += a;
      bank += a * kRow;
    }
  }
}

// The same for the 8 rows of a batch, in two passes: with one pass over
// 8 rows the compiler (CUDA 12.8) ran out of registers and issued the
// next batch's loads only after the loop over the 4-bank groups.
template <int kLogC, int kRem, bool kGlobal>
__device__ __forceinline__ void batch_hits(const uint4 (&q)[kLoadRows], const uint32_t* arity,
                                           const uint32_t* c, const uint32_t* bank,
                                           int n_groups, uint32_t (&hk)[4]) {
#pragma unroll
  for (int h = 0; h < kLoadRows; h += kPassRows) {
    uint4 rows[kPassRows];
#pragma unroll
    for (int i = 0; i < kPassRows; ++i) rows[i] = q[h + i];
    uint32_t ph[4] = {0u, 0u, 0u, 0u};
    pass_hits<kLogC, kRem, kGlobal>(rows, arity, c, bank, n_groups, ph);
#pragma unroll
    for (int k = 0; k < 4; ++k) hk[k] |= ph[k] << h;
  }
}

template <int kLogC, int kRem, bool kGlobal>
__global__ void __launch_bounds__(kWarpThreads, 2)
    xor_kernel(const uint4* __restrict__ words, const uint32_t* __restrict__ prog,
               const int n_groups, const int n_rows, const int64_t groups,
               int32_t* __restrict__ bm, int32_t* __restrict__ packed,
               int32_t* __restrict__ scratch, int32_t* __restrict__ total) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint4 q[kLoadRows];
  if (g < groups) load_rows(q, words, g, 0, lane);  // in flight during the expansion

  const int head = n_groups + n_rows;
  for (int i = threadIdx.x; i < head; i += kWarpThreads) smem[i] = __ldg(prog + 2 + i);
  const uint32_t* src = prog + 2 + head;  // compact bank rows
  uint32_t* s_banks = smem + head_words(n_groups, n_rows);
  if constexpr (!kGlobal) {
    const int n = n_rows * kXorSlots;
    if constexpr (kLogC >= 2) {  // 4 copies of one slot per 16-byte store
      uint4* dst = reinterpret_cast<uint4*>(s_banks);
      for (int o = threadIdx.x; o < (n << kLogC) / 4; o += kWarpThreads) {
        const uint32_t v = __ldg(src + ((o * 4) >> kLogC));
        dst[o] = make_uint4(v, v, v, v);
      }
    } else {
      static_assert(kLogC == 0, "1, 16 or 32 copies");
      for (int o = threadIdx.x; o < n; o += kWarpThreads) s_banks[o] = __ldg(src + o);
    }
  }
  __syncthreads();
  const uint32_t* arity = smem;
  const uint32_t* consts = smem + n_groups;
  const uint32_t* banks = kGlobal ? src : s_banks + (lane & ((1 << kLogC) - 1));

  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  int n_hit = 0;
  int r0 = 0;
#pragma unroll 1
  while (g < groups) {
    const bool last = r0 + kLoadRows == kGroupRows;
    const int64_t ng = last ? g + stride : g;
    const int nr0 = last ? 0 : r0 + kLoadRows;
    uint4 nq[kLoadRows] = {};  // the next batch, in flight while this one is tested
    if (ng < groups) load_rows(nq, words, ng, nr0, lane);
    uint32_t hk[4] = {0u, 0u, 0u, 0u};
    batch_hits<kLogC, kRem, kGlobal>(q, arity, consts, banks, n_groups, hk);
#pragma unroll
    for (int k = 0; k < 4; ++k) bits[k] |= hk[k] << r0;
    if (last) {
      n_hit += grab_count::warp_group_store(bits, g, bm, packed) ? 1 : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) bits[k] = 0u;
    }
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) q[i] = nq[i];
    g = ng;
    r0 = nr0;
  }
  grab_count::block_count(n_hit, scratch, total);
}

struct Launch {
  const uint4* words;
  const uint32_t* prog;
  int n_groups, n_rows;
  int64_t groups;
  int32_t *bm, *packed, *scratch, *total;
  int device;
  cudaStream_t stream;
  size_t smem;
};

// As many blocks as are resident on the card at once (each walks its
// groups in strides of the grid), at most one per 8 groups.
template <int kLogC, int kRem, bool kGlobal>
cudaError_t launch(const Launch& a) {
  auto* kernel = xor_kernel<kLogC, kRem, kGlobal>;
  cudaError_t err;
  if (a.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(a.smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpThreads, a.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int64_t blocks = grab_count::warp_grid(a.groups);
  const unsigned grid = static_cast<unsigned>(blocks < resident ? blocks : resident);
  xor_kernel<kLogC, kRem, kGlobal><<<grid, kWarpThreads, a.smem, a.stream>>>(
      a.words, a.prog, a.n_groups, a.n_rows, a.groups, a.bm, a.packed, a.scratch, a.total);
  return cudaGetLastError();
}

template <int kLogC, bool kGlobal>
cudaError_t launch_rem(int rem, const Launch& a) {
  switch (rem) {
    case 1: return launch<kLogC, 1, kGlobal>(a);
    case 2: return launch<kLogC, 2, kGlobal>(a);
    case 3: return launch<kLogC, 3, kGlobal>(a);
    case 4: return launch<kLogC, 4, kGlobal>(a);
    default: return launch<kLogC, 0, kGlobal>(a);
  }
}

}  // namespace

extern "C" {

// words:   device int32 [32*groups + 8, 128], 16-byte aligned
// prog:    DEVICE int32 filter program (xor_test.cuh); host_prog: the
//          same words on the host, read here to check the header
// copies:  32, 16 or 1: copies of each bank row in shared memory; 0: the
//          bank rows stay in global memory (ops/xorfilter.py bank_copies)
// rem:     1..4 when every group but the last has arity 4 and the last
//          arity rem; 0 for any shape
// bm:      device int32 [groups, 128]; packed: device int32 [groups];
// total:   device int32 [1], written by the kernel
// scratch: device int32 [2], zero, used by no other stream (left zero)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_xor_scan(const void* words, const void* prog, const uint32_t* host_prog,
                int64_t prog_words, int copies, int rem, int64_t groups, void* bm,
                void* packed, void* total, void* scratch, int device, void* stream) {
  if (groups <= 0 || groups > 0x7fffffff || prog_words > 0x7fffffff ||
      grab_word::xor_program_words(host_prog, prog_words) != prog_words ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      (copies != 0 && copies != 1 && copies != 16 && copies != 32) || rem < 0 || rem > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_groups = static_cast<int>(host_prog[0]);
  const int n_rows = static_cast<int>(host_prog[1]);
  if (rem > 0) {
    for (int g = 0; g < n_groups; ++g) {
      if (host_prog[2 + g] != (g + 1 < n_groups ? 4u : static_cast<uint32_t>(rem))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  const int64_t smem =
      4 * (head_words(n_groups, n_rows) + int64_t{n_rows} * kXorSlots * copies);
  if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch a{static_cast<const uint4*>(words), static_cast<const uint32_t*>(prog),
                 n_groups, n_rows, groups,
                 static_cast<int32_t*>(bm), static_cast<int32_t*>(packed),
                 static_cast<int32_t*>(scratch), static_cast<int32_t*>(total),
                 device, static_cast<cudaStream_t>(stream), static_cast<size_t>(smem)};
  switch (copies) {
    case 32: err = launch_rem<5, false>(rem, a); break;
    case 16: err = launch_rem<4, false>(rem, a); break;
    case 1: err = launch_rem<0, false>(rem, a); break;
    default: err = launch_rem<0, true>(rem, a); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
