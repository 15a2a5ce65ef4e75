// Core-word literal prefilter for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_corewords.py
// core_word_bitmap (Pallas body _build_kernel + _bitmap_rows) together
// with the lane-OR of packed_block_flags that follows it in XLA.
//
// What it computes. The scan buffer is viewed as int32 words
// [rows + 8, 128]: one 512-byte candidate block per row, 8 zero pad rows
// after it. For every aligned word w (flat index r*128 + c) the test is
// the OR over 4 phases x K literals of
//   masked:    ((x[w] ^ v0) & m0 | (x[w+1] ^ v1) & m1) == 0
//   unmasked:  x[w] == v0 && x[w+1] == v1
// (the second word only when W == 2). Outputs, bit for bit as the TPU
// path produces them:
//   bm[g, c]   bit r of group g's word c = hit at word (32g + r, c)
//   packed[g]  OR of bm[g, :] over the 128 lanes
//   total      number of nonzero packed[g]
//
// What bounds it. Each word is read once (the w+1 read hits the same or
// the next cache line), so a 32 MiB buffer moves ~33.6 MB: ~10 us at the
// H100's 3.35 TB/s. The test costs ~6 integer ops per (phase, literal)
// per word, 4*K*(2W+2) in all; at K = 16, W = 2 that is ~3 G ops per
// buffer, ~0.2 ms at the int32 issue rate, so small K is bound by memory
// and a full 16-literal bucket by integer issue.
//
// What the design does about it. The TPU kernel needed a lane roll plus
// a halo block to reach word w+1; here it is simply the next address:
// thread c of a warp reads word (r, c) and (r, c+1), so a warp's loads
// are 512 contiguous bytes, and lane 127's w+1 is the next row's lane 0
// (or a zero pad row after the last row). One block of 128 threads owns
// a 32-row group: each thread walks the 32 rows and builds its bitmap
// word in a register, so the bitmap needs no shared memory and no
// cross-thread sum. The lane-OR is one __reduce_or_sync per warp and
// four shared words; the count is one atomicAdd of an exact integer per
// flagged group, so the result is deterministic (word_epilogue.cuh,
// shared by all the word kernels). The (phase, literal) compare itself is
// coreword_test.cuh, shared with fused.cu. The (val, mask) table,
// at most 2*4*16*2 int32 = 1 KiB, travels by value as a kernel argument;
// every thread reads the same entry at a compile-time index, which the
// constant bank broadcasts. K, W and masked are template parameters (20
// instantiations), so the test loops unroll completely.
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "coreword_test.cuh"
#include "word_epilogue.cuh"

namespace {

using grab_word::kGroupRows;
constexpr int kLanes = grab_word::kWordLanes;
constexpr int kMaxK = 16;
constexpr int kMaxW = 2;

struct Table {
  // [val | mask][phase][K][W] flattened with the launched K and W
  uint32_t v[2 * 4 * kMaxK * kMaxW];
};

template <int K, int W, bool MASKED>
__global__ void __launch_bounds__(kLanes)
    core_word_kernel(const uint32_t* __restrict__ words, const Table tab,
                     int32_t* __restrict__ bm, int32_t* __restrict__ packed,
                     int32_t* __restrict__ total) {
  const int g = blockIdx.x;
  const int c = threadIdx.x;
  const uint32_t* col =
      words + static_cast<size_t>(g) * kGroupRows * kLanes + c;
  uint32_t bits = 0;
#pragma unroll 4
  for (int r = 0; r < kGroupRows; ++r) {
    const uint32_t x0 = __ldg(col + r * kLanes);
    const uint32_t x1 = W > 1 ? __ldg(col + r * kLanes + 1) : 0u;
    uint32_t hit = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int li = 0; li < K; ++li) {
        const int iv = (p * K + li) * W;  // value of word 0
        const int im = 4 * K * W + iv;    // mask of word 0
        hit |= grab_word::core_pair_hit<W, MASKED>(
            x0, x1, tab.v[iv], tab.v[im], W > 1 ? tab.v[iv + 1] : 0u,
            W > 1 ? tab.v[im + 1] : 0u);
      }
    }
    bits |= hit << r;
  }
  grab_word::row_bitmap_epilogue(bits, g, c, bm, packed, total);
}

struct Args {
  const uint32_t* words;
  Table tab;
  int32_t* bm;
  int32_t* packed;
  int32_t* total;
  unsigned groups;
  cudaStream_t stream;
};

template <int K, int W, bool MASKED>
void launch(const Args& a) {
  core_word_kernel<K, W, MASKED><<<a.groups, kLanes, 0, a.stream>>>(
      a.words, a.tab, a.bm, a.packed, a.total);
}

template <int K>
bool launch_k(const Args& a, int n_words, bool masked) {
  if (n_words == 1) {
    masked ? launch<K, 1, true>(a) : launch<K, 1, false>(a);
  } else if (n_words == 2) {
    masked ? launch<K, 2, true>(a) : launch<K, 2, false>(a);
  } else {
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// words:  device int32 [32*groups + 8, 128], the last 8 rows zero
// tab:    HOST int32 [2, 4, k, n_words] (copied into the launch)
// bm:     device int32 [groups, 128]; packed: device int32 [groups];
// total:  device int32 [1] (zeroed here, on the stream, before the kernel)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_core_word_scan(const void* words, const int32_t* tab, int k,
                      int n_words, int masked, int64_t groups, void* bm,
                      void* packed, void* total, int device, void* stream) {
  if (groups <= 0 || groups > 0x7fffffff || k < 1 || k > kMaxK ||
      n_words < 1 || n_words > kMaxW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.words = static_cast<const uint32_t*>(words);
  std::memset(&a.tab, 0, sizeof(a.tab));
  std::memcpy(a.tab.v, tab, sizeof(uint32_t) * 2 * 4 * k * n_words);
  a.bm = static_cast<int32_t*>(bm);
  a.packed = static_cast<int32_t*>(packed);
  a.total = static_cast<int32_t*>(total);
  a.groups = static_cast<unsigned>(groups);
  a.stream = static_cast<cudaStream_t>(stream);
  err = grab_word::zero_total(total, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool ok = false;
  switch (k) {
    case 1: ok = launch_k<1>(a, n_words, masked != 0); break;
    case 2: ok = launch_k<2>(a, n_words, masked != 0); break;
    case 4: ok = launch_k<4>(a, n_words, masked != 0); break;
    case 8: ok = launch_k<8>(a, n_words, masked != 0); break;
    case 16: ok = launch_k<16>(a, n_words, masked != 0); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
