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
// TPU path produces them (group_count.cuh):
//   bm[g, c]   bit r = hit at word (32g + r, c)
//   packed[g]  OR of bm[g, :] over the 128 lanes
//   total      number of nonzero packed[g]
//
// What bounds it. Each word is read once, so a 32 MiB buffer moves
// ~33.6 MB: ~10 us at 3.35 TB/s. The integer work is data dependent: a
// (sequence, phase) test stops at its first class that fails, so on text
// most words cost one class test per sequence; a buffer where the
// sequences' leading classes match everywhere costs up to the full AND
// chains. One sequence is bound by the bytes, many by the integer work.
//
// What the design does about it. Two kernels, chosen by the number of
// sequences (ops/classseq.py TABLE_MIN_SEQS); neither queues a stream
// operation before its launch: the sequences travel as a
// __grid_constant__ kernel parameter, and `total` is counted through a
// per-stream scratch (group_count.cuh). The former copy of the
// descriptor into __constant__ memory and the memset of `total` were two
// stream operations ahead of every launch, as long as the kernel itself.
//
// Up to 8 sequences: SWAR compares (classseq_swar_kernel). Thread c of a
// block reads word (r, c) and the next two flat words of 8 rows (lane
// 127 reads the next row's lanes 0 and 1, the last row the pad rows) and
// tests the 4 phases at once: class j applies to window bytes j..j+3 (one
// funnel shift), and a range test on 4 bytes is two SWAR compares ("byte
// >= b": an add and a 3-input logic op, swar.cuh) and an AND-NOT-OR. The
// SWAR constants of each bound are made on the host (SeqParams: the add
// word, the keep flag as one bit of a per-class mask), so the kernel
// reads two words per range from the parameter's constant bank, which
// broadcasts them to the warp, and the 8 rows share each read. A
// sequence's AND chain stops when no phase of the 8 rows is left, and
// the rows at their first matching sequence. This block-per-group form
// ran one and 8 sequences faster on the card than a warp per group with
// 16-byte loads.
//
// 9 to 32 sequences: per-position sequence masks (classseq_table_kernel).
// t[j][b] bit s is set when byte b lies in class j of sequence s (or j is
// past its end), so start position i hits when the AND over j of
// t[j][byte i + j] is not zero: every sequence at once, one shared-memory
// read per class and position, where the SWAR form costs a range test per
// sequence. The tables (8 KB) come as the kernel parameter and are
// staged to shared memory by each block. A warp owns a 32-row group, a
// lane 4 words of a row (one 16-byte load, the next 4 rows in flight
// while 4 are tested), the window's next two words by shuffle (lane 31:
// one 8-byte load of the next row, its address shared by the warp).
//
// fused.cu (B6) keeps its own descriptor, classseq_test.cuh. The kernels
// allocate nothing; the C entry point returns cudaGetLastError() after
// the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "swar.cuh"
#include "group_count.cuh"

namespace {

using grab_count::kGroupRows;
using grab_count::kRowVecs;
using grab_count::kWarpThreads;
using grab_count::kWarps;
using grab_count::kWordLanes;
using grab_word::kH;
using grab_word::kL7;
constexpr int kMaxSeqs = 32;
constexpr int kMaxClasses = 8;  // PREFIX_CAP atoms per sequence
constexpr int kMaxRanges = 8;   // mask_to_ranges' cap per class
constexpr int kSwarSeqs = 8;    // the most sequences of the SWAR form
constexpr int kTestRows = 8;    // rows tested together per descriptor read
constexpr int kLoadRows = 4;    // table kernel: rows per load batch

// Byte layout shared with grab_tpu_torch/ops/classseq.py seq_params
// (no padding inside; the size is rounded up to 4 bytes). Range t of
// class j of sequence s is "x >= lo and not x >= hi + 1": add[s][j][t]
// holds the add words of the two bounds (swar.cuh Bound), keep[s][j] bit
// 2t their keep flag for lo, bit 2t + 1 for hi + 1.
template <int S>
struct SeqParams {
  int32_t n_seqs;
  int32_t span;  // longest sequence, <= 8
  uint32_t add[S][kMaxClasses][kMaxRanges][2];
  uint16_t keep[S][kMaxClasses];
  uint8_t n_ranges[S][kMaxClasses];
  uint8_t len[S];
};
static_assert(sizeof(SeqParams<1>) == 548, "layout");
static_assert(sizeof(SeqParams<kSwarSeqs>) == 4304, "layout");

// The table form (ops/classseq.py seq_tables): t[j][b] bit s is set when
// byte b lies in class j of sequence s, or j is past its end. Start
// position i hits when the AND over j < span of t[j][byte i + j] is not
// zero: all sequences at once, one table read per class and position.
struct SeqTables {
  int32_t span;
  int32_t n_seqs;
  uint32_t t[kMaxClasses][256];
};
static_assert(sizeof(SeqTables) == 8 + 8192, "layout");

// "byte >= b" into each byte's high bit, with b's add word and keep
// mask (~0 or 0): swar.cuh Bound::ge.
__device__ __forceinline__ uint32_t ge(uint32_t x, uint32_t xl, uint32_t add,
                                       uint32_t keep) {
  const uint32_t t = xl + add;
  return (t & (x | keep)) | (x & keep);
}

// w0, w1, w2: the words holding window bytes 0..3, 4..7, 8..11 of each
// of the thread's kTestRows rows. → bit i: row i hits.
template <int S>
__device__ __forceinline__ uint32_t seq_hits(const SeqParams<S>& p,
                                             const uint32_t (&w0)[kTestRows],
                                             const uint32_t (&w1)[kTestRows],
                                             const uint32_t (&w2)[kTestRows]) {
  constexpr uint32_t kAll = (1u << kTestRows) - 1u;
  uint32_t hits = 0;
  const int n_seqs = p.n_seqs;
  for (int s = 0; s < n_seqs && hits != kAll; ++s) {
    const int len = p.len[s];
    // alive[i]: the phases of word i whose AND chain still holds
    uint32_t alive[kTestRows];
#pragma unroll
    for (int i = 0; i < kTestRows; ++i) alive[i] = (hits >> i) & 1u ? 0u : kH;
    uint32_t any = kH;
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) {
      if (j >= len || !any) break;
      // byte q of x is window byte q + j: class j at the 4 phases
      uint32_t x[kTestRows], xl[kTestRows], m[kTestRows];
#pragma unroll
      for (int i = 0; i < kTestRows; ++i) {
        const uint32_t lo = j < 4 ? w0[i] : w1[i];
        const uint32_t hi = j < 4 ? w1[i] : w2[i];
        x[i] = __funnelshift_r(lo, hi, 8 * (j & 3));
        xl[i] = x[i] & kL7;
        m[i] = 0;
      }
      const int n = p.n_ranges[s][j];
      const uint32_t keep = p.keep[s][j];
      for (int t = 0; t < n; ++t) {
        const uint32_t a_lo = p.add[s][j][t][0], a_hi = p.add[s][j][t][1];
        const uint32_t k_lo = 0u - ((keep >> (2 * t)) & 1u);
        const uint32_t k_hi = 0u - ((keep >> (2 * t + 1)) & 1u);
#pragma unroll
        for (int i = 0; i < kTestRows; ++i) {
          m[i] |= ge(x[i], xl[i], a_lo, k_lo) & ~ge(x[i], xl[i], a_hi, k_hi);
        }
      }
      any = 0;
#pragma unroll
      for (int i = 0; i < kTestRows; ++i) {
        alive[i] &= m[i];
        any |= alive[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kTestRows; ++i) hits |= static_cast<uint32_t>(alive[i] != 0) << i;
  }
  return hits;
}

template <int S>
__global__ void __launch_bounds__(kWordLanes)
    classseq_swar_kernel(const uint32_t* __restrict__ words,
                         const __grid_constant__ SeqParams<S> p,
                         int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                         int32_t* __restrict__ scratch, int32_t* __restrict__ total) {
  const int64_t g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* col = words + g * kGroupRows * kWordLanes + c;
  const bool two = p.span + 3 > 4;    // window reaches word w+1
  const bool three = p.span + 3 > 8;  // ... and word w+2
  uint32_t bits = 0;
  for (int r0 = 0; r0 < kGroupRows; r0 += kTestRows) {
    uint32_t w0[kTestRows], w1[kTestRows], w2[kTestRows];
#pragma unroll
    for (int i = 0; i < kTestRows; ++i) {
      const uint32_t* at = col + (r0 + i) * kWordLanes;
      w0[i] = __ldg(at);
      w1[i] = two ? __ldg(at + 1) : 0u;
      w2[i] = three ? __ldg(at + 2) : 0u;
    }
    bits |= seq_hits(p, w0, w1, w2) << r0;
  }
  grab_count::lane_group_epilogue(bits, g, c, bm, packed, scratch, total);
}

// Byte b of word x, zero-extended (one PRMT).
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int b) {
  return __byte_perm(x, 0u, 0x4440u | static_cast<uint32_t>(b));
}

// The 16 start positions of one row of a lane (word k, byte b: a[4k + b])
// against the tables: win holds the row's words 4l .. 4l + 5. → bit k:
// word k hits.
__device__ __forceinline__ uint32_t table_hits(const uint32_t (&tab)[kMaxClasses][256],
                                               int span, const uint32_t (&win)[6]) {
  uint32_t a[16];
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < kMaxClasses; ++j) {
    if (j > 0 && (j >= span || !any)) break;
    any = 0;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int at = s + j;  // window byte
      const uint32_t v = tab[j][byte_of(win[at >> 2], at & 3)];
      a[s] = j == 0 ? v : a[s] & v;
      any |= a[s];
    }
  }
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h |= static_cast<uint32_t>((a[4 * k] | a[4 * k + 1] | a[4 * k + 2] | a[4 * k + 3]) != 0u) << k;
  }
  return h;
}

__global__ void __launch_bounds__(kWarpThreads)
    classseq_table_kernel(const uint4* __restrict__ words,
                          const __grid_constant__ SeqTables p, const int64_t groups,
                          int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                          int32_t* __restrict__ scratch, int32_t* __restrict__ total) {
  __shared__ uint32_t tab[kMaxClasses][256];
  const int span = p.span;
  for (int i = threadIdx.x; i < span * 256; i += kWarpThreads) {
    tab[i >> 8][i & 255] = p.t[i >> 8][i & 255];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const bool valid = g < groups;
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    // row r of the group, this lane's 16 bytes: col[r * kRowVecs]; the
    // first 8 bytes of row r + 1: nxt[r * 2 * kRowVecs]
    const uint4* col = words + g * kGroupRows * kRowVecs + lane;
    const uint2* nxt =
        reinterpret_cast<const uint2*>(words + (g * kGroupRows + 1) * kRowVecs);
    uint4 q[kLoadRows];
    uint2 n[kLoadRows];
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) {
      q[i] = __ldg(col + i * kRowVecs);
      n[i] = __ldg(nxt + i * 2 * kRowVecs);
    }
    // the loop stays rolled: fully unrolled, the compiler (CUDA 12.8,
    // sm_90a) dropped bits of rows at batch edges
#pragma unroll 1
    for (int r0 = 0; r0 < kGroupRows; r0 += kLoadRows) {
      uint4 nq[kLoadRows] = {};  // the next batch, in flight while this one is tested
      uint2 nn[kLoadRows] = {};
      if (r0 + kLoadRows < kGroupRows) {
#pragma unroll
        for (int i = 0; i < kLoadRows; ++i) {
          nq[i] = __ldg(col + (r0 + kLoadRows + i) * kRowVecs);
          nn[i] = __ldg(nxt + (r0 + kLoadRows + i) * 2 * kRowVecs);
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) {
        const uint4 v = q[i];
        uint32_t a = __shfl_down_sync(0xffffffffu, v.x, 1);
        uint32_t b = __shfl_down_sync(0xffffffffu, v.y, 1);
        if (lane == 31) {
          a = n[i].x;
          b = n[i].y;
        }
        const uint32_t win[6] = {v.x, v.y, v.z, v.w, a, b};
        const uint32_t h = table_hits(tab, span, win);
#pragma unroll
        for (int k = 0; k < 4; ++k) bits[k] |= ((h >> k) & 1u) << (r0 + i);
      }
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) {
        q[i] = nq[i];
        n[i] = nn[i];
      }
    }
  }
  grab_count::warp_group_epilogue(bits, valid, g, bm, packed, scratch, total);
}

template <int S>
bool params_valid(const SeqParams<S>& p) {
  if (p.n_seqs < 1 || p.n_seqs > S || p.span < 1 || p.span > kMaxClasses) {
    return false;
  }
  for (int s = 0; s < p.n_seqs; ++s) {
    if (p.len[s] < 1 || p.len[s] > p.span) return false;
    for (int j = 0; j < p.len[s]; ++j) {
      if (p.n_ranges[s][j] < 1 || p.n_ranges[s][j] > kMaxRanges) return false;
    }
  }
  return true;
}

template <int S>
cudaError_t launch(const void* words, const void* params, int64_t groups,
                   int32_t* bm, int32_t* packed, int32_t* scratch,
                   int32_t* total, cudaStream_t st) {
  const SeqParams<S>& p = *static_cast<const SeqParams<S>*>(params);
  if (!params_valid(p)) return cudaErrorInvalidValue;
  classseq_swar_kernel<S><<<static_cast<unsigned>(groups), kWordLanes, 0, st>>>(
      static_cast<const uint32_t*>(words), p, bm, packed, scratch, total);
  return cudaGetLastError();
}

cudaError_t launch_tables(const void* words, const void* tables, int64_t groups,
                          int32_t* bm, int32_t* packed, int32_t* scratch,
                          int32_t* total, cudaStream_t st) {
  const SeqTables& p = *static_cast<const SeqTables*>(tables);
  if (p.n_seqs < 1 || p.n_seqs > kMaxSeqs || p.span < 1 || p.span > kMaxClasses) {
    return cudaErrorInvalidValue;
  }
  classseq_table_kernel<<<grab_count::warp_grid(groups), kWarpThreads, 0, st>>>(
      static_cast<const uint4*>(words), p, groups, bm, packed, scratch, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// words:   device int32 [32*groups + 8, 128], the last 8 rows zero,
//          16-byte aligned
// params:  HOST bytes of a SeqParams<S>, S in {1, 8}, or of a
//          SeqTables, told by their size (copied into the launch)
// bm:      device int32 [groups, 128]; packed: device int32 [groups];
// total:   device int32 [1], written by the kernel
// scratch: device int32 [2], zero, used by no other stream (left zero)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_classseq_scan(const void* words, const void* params, int64_t params_bytes,
                     int64_t groups, void* bm, void* packed, void* total,
                     void* scratch, int device, void* stream) {
  if (groups <= 0 || groups > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(params) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* b = static_cast<int32_t*>(bm);
  int32_t* pk = static_cast<int32_t*>(packed);
  int32_t* s = static_cast<int32_t*>(scratch);
  int32_t* tot = static_cast<int32_t*>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (params_bytes == sizeof(SeqParams<1>)) {
    err = launch<1>(words, params, groups, b, pk, s, tot, st);
  } else if (params_bytes == sizeof(SeqParams<kSwarSeqs>)) {
    err = launch<kSwarSeqs>(words, params, groups, b, pk, s, tot, st);
  } else if (params_bytes == sizeof(SeqTables)) {
    err = launch_tables(words, params, groups, b, pk, s, tot, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
