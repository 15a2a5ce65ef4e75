// Last-resort DFA walk for Hopper (sm_90a).
//
// Replaces the JAX package's device function grab_tpu/ops/dfa_scan.py
// dfa_scan_bitmap (a lax.scan, no Pallas kernel) together with
// bitmap_block_counts(bm, block) > 0 and the packing of those block flags
// into 32-bit words (ops/dfa_scan.py, DfaWalkMember).
//
// What it computes. A buffer of N bytes is split into S streams of
// seg = N / S bytes; h = min(halo, seg). Stream s walks the automaton
// from the start state over the bytes [s*seg, min(N, (s+1)*seg + h)),
// one transition per byte; position p is a candidate match end when the
// state after byte p accepts (the bit is not sticky). A stream's halo
// covers the first h positions of the next stream, whose own bits it ORs
// into; the reference's zero-padded halo of the last stream adds nothing
// to the output and is not walked. Block b (of `block` bytes) is flagged
// when any position in it is a candidate. Outputs, bit for bit as the
// plain version produces them: packed[g] bit i = block 32g + i flagged;
// total[0] = the number of flagged blocks.
//
// What bounds it. Each stream is one chain of seg + h dependent table
// lookups: 36,864 at the CLI's 32 MiB buffer (1,024 streams of 32 KiB
// and the 4 KiB halo). At ~40 SM cycles a link (dependent IMAD, shared
// load and AND, as measured for the one-thread-per-stream strided walk)
// that is ~0.73 ms at 1.98 GHz; the bytes (32 MiB, read once) and the
// integer work (4 operations a byte) take ~0.01 ms each.
//
// What the design does about it.
//   * One thread per stream keeps the reference's stream geometry, so
//     the flags stay bit-equal.
//   * The transition table stays class-indexed: [n_states, n_classes]
//     16-bit entries, bits 0-14 the next state and bit 15 whether that
//     state accepts, in shared memory beside the 256-byte class map. The
//     class of a byte is looked up off the chain, as the entry's column
//     offset in the shared window; the chain per byte is one IMAD, one
//     16-bit shared load (an explicit ld.shared, not a generic load) and
//     one AND. A table larger than kSharedTable (the largest the walk
//     takes, 2048 states x 256 classes, is 1 MiB) is read from global
//     memory (L2) by the same code (kShared = false); the class map stays
//     in shared memory.
//   * A thread reads its bytes with 16-byte loads, the next one in
//     flight while the current 16 bytes are walked; the bytes of its first
//     and last block that do not fill an aligned 16-byte load are read
//     one at a time (a segment need not be a multiple of 16 or of the
//     block).
//   * Blocks of one warp, 8 lanes walking: the whole warp copies the
//     table into shared memory, few walking lanes meet on a shared-memory
//     bank, and 1,024 streams make 128 blocks, about one per SM.
//   * A thread gathers its blocks' flags in a register word per 32
//     blocks and ORs the word into `packed` with one atomic when it moves
//     on (a block may be shared with the neighbouring streams); the bits
//     that atomic newly set are added to `total`, so no second pass counts
//     them. `packed` and `total` must be zero before the launch.
// The byte loops stay rolled (#pragma unroll 1) apart from the 16 steps
// of one load: fully unrolled long loops were miscompiled in other
// kernels of this package (CUDA 12.8).
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;          // one warp per block
constexpr int kStreamsPerBlock = 8;   // lanes that walk a stream
constexpr int kClassVecs = 256 / 16;  // 16-byte vectors of the class map
constexpr int64_t kSharedTable = 200 * 1024;  // table bytes kept in shared memory
constexpr uint32_t kStateMask = 0x7fffu;
constexpr int kMaxStates = 1 << 15;

struct Walk {
  const uint8_t* data;      // N bytes, 16-byte aligned
  const uint16_t* table;    // [n_states * n_classes], padded to 16 bytes
  const uint8_t* class_map; // [256], 16-byte aligned
  int64_t n, seg, h;
  int n_streams, n_classes, block_shift;
  uint32_t start;
  int64_t table_vecs;       // 16-byte vectors of the padded table
  uint32_t* packed;
  int32_t* total;
};

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return v;
}

// Where a table row's entries lie. kShared: `col` of a class is the
// shared-window byte address of its column in row 0 and a row is
// `stride` = 2 * n_classes bytes; else `col` is the class and `stride`
// n_classes entries of `table`.
template <bool kShared>
struct Table {
  const uint16_t* table;
  uint32_t base, stride;

  __device__ __forceinline__ uint32_t col(uint32_t cls) const {
    return kShared ? base + 2u * cls : cls;
  }
  // The entry of `state` at a column: one IMAD and one load.
  __device__ __forceinline__ uint32_t entry(uint32_t state, uint32_t col) const {
    const uint32_t i = state * stride + col;
    return kShared ? lds_u16(i) : __ldg(table + i);
  }
};

// One byte at a time over [p, hi): → the state after it; acc ORs entries.
template <bool kShared>
__device__ __forceinline__ uint32_t walk_bytes(const Walk& w, const Table<kShared>& t,
                                               const uint8_t* cls, int64_t p, int64_t hi,
                                               uint32_t state, uint32_t& acc) {
#pragma unroll 1
  for (; p < hi; ++p) {
    const uint32_t e = t.entry(state, t.col(cls[__ldg(w.data + p)]));
    acc |= e;
    state = e & kStateMask;
  }
  return state;
}

// OR a thread's flag word of group g into packed; count the new bits.
__device__ __forceinline__ void flush(const Walk& w, int64_t g, uint32_t word) {
  if (word == 0u) return;
  const uint32_t old = atomicOr(w.packed + g, word);
  const int fresh = __popc(word & ~old);
  if (fresh) atomicAdd(w.total, fresh);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) dfa_walk_kernel(const Walk w) {
  extern __shared__ uint4 smem[];  // the class map, then (kShared) the table
  if (threadIdx.x < kClassVecs) {
    smem[threadIdx.x] = __ldg(reinterpret_cast<const uint4*>(w.class_map) + threadIdx.x);
  }
  if (kShared) {
    const uint4* src = reinterpret_cast<const uint4*>(w.table);
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < w.table_vecs; i += kThreads) {
      smem[kClassVecs + i] = __ldg(src + i);
    }
  }
  __syncthreads();
  const uint8_t* cls = reinterpret_cast<const uint8_t*>(smem);
  const uint32_t n_classes = static_cast<uint32_t>(w.n_classes);
  const Table<kShared> t{
      w.table, static_cast<uint32_t>(__cvta_generic_to_shared(smem + kClassVecs)),
      kShared ? 2u * n_classes : n_classes};
  const int s = blockIdx.x * kStreamsPerBlock + static_cast<int>(threadIdx.x);
  if (threadIdx.x >= kStreamsPerBlock || s >= w.n_streams) return;

  const int64_t begin = s * w.seg;
  const int64_t end = min(w.n, begin + w.seg + w.h);
  const int64_t bsize = int64_t{1} << w.block_shift;
  uint32_t state = w.start;
  int64_t group = begin >> (w.block_shift + 5);
  uint32_t word = 0u;
#pragma unroll 1
  for (int64_t b0 = begin & ~(bsize - 1); b0 < end; b0 += bsize) {
    const int64_t lo = max(b0, begin);
    const int64_t hi = min(b0 + bsize, end);
    uint32_t acc = 0u;
    // the head up to a 16-byte boundary, the whole loads, the tail
    const int64_t v0 = min(hi, (lo + 15) & ~int64_t{15});
    state = walk_bytes<kShared>(w, t, cls, lo, v0, state, acc);
    const int64_t nv = (hi - v0) >> 4;
    const uint4* v = reinterpret_cast<const uint4*>(w.data + v0);
    uint4 q = nv > 0 ? __ldg(v) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
    for (int64_t i = 0; i < nv; ++i) {
      const uint4 nq = i + 1 < nv ? __ldg(v + i + 1) : q;
      const uint32_t x[4] = {q.x, q.y, q.z, q.w};
      uint32_t c[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) c[k] = t.col(cls[(x[k >> 2] >> (8 * (k & 3))) & 0xffu]);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t e = t.entry(state, c[k]);
        acc |= e;
        state = e & kStateMask;
      }
      q = nq;
    }
    state = walk_bytes<kShared>(w, t, cls, v0 + (nv << 4), hi, state, acc);
    const int64_t blk = b0 >> w.block_shift;
    if ((blk >> 5) != group) {
      flush(w, group, word);
      group = blk >> 5;
      word = 0u;
    }
    word |= ((acc >> 15) & 1u) << (blk & 31);
  }
  flush(w, group, word);
}

template <bool kShared>
cudaError_t launch(const Walk& w, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dfa_walk_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid =
      static_cast<unsigned>((w.n_streams + kStreamsPerBlock - 1) / kStreamsPerBlock);
  dfa_walk_kernel<kShared><<<grid, kThreads, smem, st>>>(w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// data:      device uint8 [n], 16-byte aligned; n a multiple of
//            n_streams and of 32 << block_shift
// h:         halo bytes, at most n / n_streams
// table:     device uint16 [n_states * n_classes] padded to 16 bytes,
//            entry = next state | accept(next state) << 15
// class_map: device uint8 [256], 16-byte aligned
// packed:    device int32 [n >> (block_shift + 5)], zero
// total:     device int32 [1], zero
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_dfa_walk(const void* data, int64_t n, int n_streams, int64_t h, const void* table,
                int n_states, int n_classes, const void* class_map, int start,
                int block_shift, void* packed, void* total, int device, void* stream) {
  if (n <= 0 || n_streams < 1 || n % n_streams != 0 || h < 0 || h > n / n_streams ||
      n_states < 1 || n_states > kMaxStates || n_classes < 1 || n_classes > 256 ||
      start < 0 || start >= n_states || block_shift < 4 || block_shift > 24 ||
      n % (int64_t{32} << block_shift) != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(class_map) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t table_bytes = int64_t{n_states} * n_classes * 2;
  const int64_t table_vecs = (table_bytes + 15) / 16;
  const Walk w{static_cast<const uint8_t*>(data), static_cast<const uint16_t*>(table),
               static_cast<const uint8_t*>(class_map), n, n / n_streams, h,
               n_streams, n_classes, block_shift, static_cast<uint32_t>(start),
               table_vecs, static_cast<uint32_t*>(packed), static_cast<int32_t*>(total)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_vecs * 16 <= kSharedTable) {
    err = launch<true>(w, static_cast<size_t>(256 + table_vecs * 16), st);
  } else {
    err = launch<false>(w, 256, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
