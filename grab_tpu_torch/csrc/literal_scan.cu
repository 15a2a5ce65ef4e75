// Multi-literal prefix scan with per-block counts, for Hopper (sm_90a).
//
// Replaces the JAX package's byte step of make_sharded_scan's literal
// branch (grab_tpu/parallel/scan_step.py, one jitted shard_map program
// per shard): grab_tpu/ops/literal_scan.py literal_scan_bitmap (jnp
// shifted-slice compares), then grab_tpu/ops/dfa_scan.py
// bitmap_block_counts. No Pallas kernel; one jnp device program.
//
// What it computes. counts[b] = the number of positions i of block b
// (block bytes each) at which some literal's capped prefix starts: with
// win(i) the 8 bytes from i as a little-endian uint64, zero past the
// shard's end (the reference's zero tail), literal k matches at i when
// (win(i) & mask[k]) == value[k]. The host builds (mask, value) from the
// literal matrix (ops/literal_scan.py literal_keys): mask covers the
// capped length L, at least 1 byte (a literal of length 0 still compares
// its first byte with 0, as the reference's does).
//
// What bounds it. Bytes: the shard is read once and the counts written
// once (32 MiB + 256 KiB: ~10 us at 3.35 TB/s). Operations: per position
// and key, the masked compare of two 32-bit halves and the fold into the
// position's hit bit, ~5 int32 operations: at 32 MiB that passes the
// bytes bound from 2 keys on.
//
// What the design does about it. A warp owns a block, 512 bytes at a
// time: each lane loads 16 bytes (one 16-byte load) and takes the next
// 8 from its right neighbour by a shuffle (lane 31 loads them from the
// next 512 bytes, or zero past the end), so the 16 windows of a lane
// are funnel shifts of six registers and every byte is read once. The
// loads of the warp's next 512 bytes are issued before this chunk is
// tested, so two chunks a warp are in flight. The keys sit in shared
// memory (up to kSmemKeys; the rest are read from global memory through
// the read-only cache), and every lane reads the same key at once (a
// broadcast). A lane's 16 hit bits are ORed over the keys, counted with
// popc, and the warp sums its lanes' counts; lane 0 writes the block's
// count. Blocks of 8 warps stride over the shard.
//
// The kernel allocates nothing, runs on the caller's stream with no
// stream operation before it, and the C entry point returns the launch
// error (cudaGetLastError()).

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;     // bytes a warp reads at once: 16 a lane
constexpr int kSmemKeys = 1024;  // keys kept in shared memory (16 KiB)

struct Keys {
  const unsigned long long* mask;
  const unsigned long long* value;
  int k;
};

// bit i of the result: some key matches the window at byte i of the
// lane's 16 (w[0..3] its bytes, w[4..5] the next 8)
__device__ __forceinline__ uint32_t lane_hits(const uint32_t (&w)[6], const Keys& g,
                                              const unsigned long long* s_mask,
                                              const unsigned long long* s_value) {
  unsigned long long win[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = i / 4, r = 8 * (i % 4);
    const uint32_t lo = r ? __funnelshift_r(w[q], w[q + 1], r) : w[q];
    const uint32_t hi = r ? __funnelshift_r(w[q + 1], w[q + 2], r) : w[q + 1];
    win[i] = static_cast<unsigned long long>(hi) << 32 | lo;
  }
  uint32_t hits = 0;
  const int in_smem = min(g.k, kSmemKeys);
  for (int k = 0; k < g.k; ++k) {
    const unsigned long long m = k < in_smem ? s_mask[k] : __ldg(g.mask + k);
    const unsigned long long v = k < in_smem ? s_value[k] : __ldg(g.value + k);
#pragma unroll
    for (int i = 0; i < 16; ++i) hits |= static_cast<uint32_t>((win[i] & m) == v) << i;
  }
  return hits;
}

// The 512 bytes at base, 16 a lane (v), and for lane 31 the 8 bytes after
// them (nx; zero past the shard's end, the reference's zero tail).
__device__ __forceinline__ void load_chunk(const uint8_t* data, int64_t n, int64_t base,
                                           int lane, uint4& v, uint2& nx) {
  v = __ldg(reinterpret_cast<const uint4*>(data + base) + lane);
  nx = lane == 31 && base + kChunk < n
           ? __ldg(reinterpret_cast<const uint2*>(data + base + kChunk))
           : make_uint2(0u, 0u);
}

__global__ void __launch_bounds__(kThreads) literal_counts_kernel(
    const uint8_t* __restrict__ data, int64_t n, int block, Keys g,
    int32_t* __restrict__ counts) {
  __shared__ unsigned long long s_mask[kSmemKeys];
  __shared__ unsigned long long s_value[kSmemKeys];
  for (int k = threadIdx.x; k < min(g.k, kSmemKeys); k += kThreads) {
    s_mask[k] = g.mask[k];
    s_value[k] = g.value[k];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int64_t n_blocks = n / block;
  const int chunks = block / kChunk;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  // the warp's blocks b, b + warps, ..., a chunk at a time, the next
  // chunk's loads in flight while this one is tested
  int64_t b = blockIdx.x * static_cast<int64_t>(kWarps) + threadIdx.x / 32;
  if (b >= n_blocks) return;
  int j = 0;
  uint4 v;
  uint2 nx;
  load_chunk(data, n, b * block, lane, v, nx);
  int count = 0;
  for (;;) {
    int64_t nb = b;
    int nj = j + 1;
    if (nj == chunks) {
      nb += warps;
      nj = 0;
    }
    const bool more = nb < n_blocks;
    uint4 v2;
    uint2 nx2;
    if (more) load_chunk(data, n, nb * block + static_cast<int64_t>(nj) * kChunk, lane, v2, nx2);
    uint32_t w[6] = {v.x, v.y, v.z, v.w, 0u, 0u};
    w[4] = __shfl_down_sync(0xffffffffu, v.x, 1);
    w[5] = __shfl_down_sync(0xffffffffu, v.y, 1);
    if (lane == 31) {
      w[4] = nx.x;
      w[5] = nx.y;
    }
    count += __popc(lane_hits(w, g, s_mask, s_value));
    if (j == chunks - 1) {
      count = __reduce_add_sync(0xffffffffu, count);
      if (lane == 0) counts[b] = count;
      count = 0;
    }
    if (!more) break;
    b = nb;
    j = nj;
    v = v2;
    nx = nx2;
  }
}

}  // namespace

extern "C" {

// data: device uint8 [n], 16-byte aligned; n > 0 a multiple of block,
// block a positive multiple of 512; mask, value: device uint64 [k],
// k >= 1; counts: device int32 [n / block].
int gt_literal_block_counts(const void* data, int64_t n, int block, const void* mask,
                            const void* value, int k, void* counts, int device,
                            void* stream) {
  if (n <= 0 || block <= 0 || block % kChunk || n % block || k < 1 ||
      reinterpret_cast<uintptr_t>(data) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<int> sms_of[64];  // per device (0: not read yet)
  int sms = sms_of[device & 63].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device & 63].store(sms);
  }
  const int64_t n_blocks = n / block;
  const int grid = static_cast<int>(std::min<int64_t>((n_blocks + kWarps - 1) / kWarps, sms * 8));
  const Keys g{static_cast<const unsigned long long*>(mask),
               static_cast<const unsigned long long*>(value), k};
  literal_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, block, g, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
