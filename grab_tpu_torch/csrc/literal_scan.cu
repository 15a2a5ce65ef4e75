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
// once (32 MiB + 256 KiB: ~10 us at 3.35 TB/s). The function's own
// operations, a few a position with a perfect filter, stay under that at
// the H100's int32 rate, so the bytes bound it whatever K is. This
// design adds one masked compare per position and key of the position's
// first-pair bucket: nothing on text, where almost no position can start
// a key, but the whole cost on a buffer that puts most positions into one
// big bucket (300 keys that share their first two bytes, over text led by
// those bytes), which a second level of buckets (on the third byte) would
// cut.
//
// What the design does about it. A warp owns a block, 512 bytes at a
// time: each lane loads 16 bytes (one 16-byte load) and takes the next
// 8 from its right neighbour by a shuffle (lane 31 loads them from the
// next 512 bytes, or zero past the end), so every byte is read once;
// the loads of the warp's next 512 bytes are issued before this chunk
// is tested. A position's keys are compared only after a filter says
// that some key can start there, in one of two forms the host chooses
// by K (ops/literal_scan.py SWAR_MAX; the wrapper's form= forces one):
//
//   table (any K; gt_literal_counts_table). The host's blob
//   (ops/literal_scan.py LiteralTables): a 65,536-bit bitmap of the byte
//   pairs that start a key of capped length >= 2 or whose first byte is
//   in the first-byte table, a rank table (set bits before each 32-bit
//   word), a 256-bit first-byte table of the keys of capped length 0 or 1
//   (a hit there is a match outright), bucket offsets per present pair and
//   the keys sorted by pair. Per position the pair test is a PRMT that
//   forms the word index b1 | (b0 >> 5) << 8 (the bank is b1 & 31, so
//   text spreads over all 32 banks), one shared-memory load, a rotate by
//   b0 that puts the pair's bit at bit 31 and a funnel shift that appends
//   it to the lane's 16 candidate bits: ~4.5 int32 operations a position.
//   Only candidates go on: the first-byte table, then the pair's rank and
//   bucket and the exact 64-bit masked compare over that bucket. The blob
//   sits in shared memory up to 48 KiB (about 1,900 keys); past that only
//   its 12,320-byte head (bitmap, ranks, first-byte table) does and the
//   offsets and keys are read from global memory.
//
//   SWAR (K <= 5; gt_literal_counts_swar). The keys ride in the kernel's
//   parameters (SwarKeys): per key the first and second bytes repeated in
//   a word. Per 4 positions and key: t = (x ^ c0) | ((y ^ c1) & m1), x the
//   word at the positions and y the word one byte on, is zero in a byte
//   where both bytes match; (t - 0x01010101) & ~t flags every zero byte
//   (and may flag a byte above one, which only costs a verify): 4
//   operations, 1 a byte and key. A lane whose flags are all clear is
//   done; otherwise its flagged positions are verified against every key.
//   On an H100 SXM it beats the table form up to 5 keys and loses from 6
//   (kernel_ab.py literal), so it takes 1 to 5 keys and the host chooses
//   it wherever it can (ops/literal_scan.py SWAR_MAX).
//
// A lane's hits are summed, the warp sums its lanes' counts and lane 0
// writes the block's count. The grid is one wave of resident blocks of
// 16 warps (the form's occupancy at its shared-memory size, asked once
// per device, form and size), and a warp strides over the shard's
// blocks; 16 warps a block, not 8, halve the blob's copies into shared
// memory (about 5% faster at 16-1000 keys on an H100 SXM, kernel_ab.py
// literal).
//
// The kernel allocates nothing, runs on the caller's stream with no
// stream operation before it (the SWAR keys and the blob's pointer are
// launch parameters; the blob is uploaded once per device by the host),
// and the C entry points return the launch error (cudaGetLastError()).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;  // bytes a warp reads at once: 16 a lane
constexpr int kPairWords = 2048;  // the pair bitmap: 65,536 bits
constexpr int kHeadBytes = kPairWords * 4 + kPairWords * 2 + 32;  // bitmap, ranks, first bytes
constexpr int kSmemLimit = 48 * 1024;  // blob bytes a block keeps in shared memory
constexpr int kSwarMax = 5;

struct SwarKeys {  // ops/literal_scan.py swar_params
  uint32_t c0[kSwarMax], c1[kSwarMax], m1[kSwarMax], pad;
  unsigned long long mask[kSwarMax], value[kSwarMax];
};
static_assert(sizeof(SwarKeys) == 144 && offsetof(SwarKeys, mask) == 64,
              "SwarKeys must match ops/literal_scan.py swar_params");

struct Table {  // ops/literal_scan.py LiteralTables
  const uint8_t* blob;
  int off_at, keys_at;  // byte offsets of the bucket offsets and the keys
  int smem_bytes;       // bytes of the blob copied to shared memory
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;  // PTX prmt: a selector nibble with bit 3 set replicates the byte's sign
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the 8 bytes from byte i (0..15) of the lane's 16 (w[0..3]) and the 8
// after them (w[4..5]), as a little-endian uint64
__device__ __forceinline__ unsigned long long window_at(const uint32_t (&w)[6], int i) {
  const int q = i >> 2, s = (i & 3) * 8;
  const uint32_t a = q == 0 ? w[0] : q == 1 ? w[1] : q == 2 ? w[2] : w[3];
  const uint32_t b = q == 0 ? w[1] : q == 1 ? w[2] : q == 2 ? w[3] : w[4];
  const uint32_t c = q == 0 ? w[2] : q == 1 ? w[3] : q == 2 ? w[4] : w[5];
  const uint32_t lo = __funnelshift_r(a, b, s), hi = __funnelshift_r(b, c, s);
  return static_cast<unsigned long long>(hi) << 32 | lo;
}

// SWAR form: the lane's hits among its 16 positions
template <int NK>
__device__ __forceinline__ int swar_hits(const uint32_t (&w)[6], const SwarKeys& g) {
  uint32_t y[4];  // y[q]: the word one byte after w[q]
#pragma unroll
  for (int q = 0; q < 4; ++q) y[q] = __funnelshift_r(w[q], w[q + 1], 8);
  uint32_t any = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const uint32_t t = (w[q] ^ g.c0[k]) | ((y[q] ^ g.c1[k]) & g.m1[k]);
      any |= (t - 0x01010101u) & ~t;
    }
  }
  if (!(any & 0x80808080u)) return 0;
  uint32_t cand = 0;  // bit 8r + q: position 4q + r
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t f = 0;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const uint32_t t = (w[q] ^ g.c0[k]) | ((y[q] ^ g.c1[k]) & g.m1[k]);
      f |= (t - 0x01010101u) & ~t;
    }
    cand |= ((f >> 7) & 0x01010101u) << q;
  }
  int hits = 0;
  while (cand) {
    const int b = __ffs(cand) - 1;
    cand &= cand - 1;
    const unsigned long long win = window_at(w, 4 * (b & 7) + (b >> 3));
    bool hit = false;
#pragma unroll
    for (int k = 0; k < NK; ++k) hit |= (win & g.mask[k]) == g.value[k];
    hits += hit;
  }
  return hits;
}

// a bucket offset or key: from shared memory, or (kAll false) global memory
template <bool kAll, class T>
__device__ __forceinline__ T ld_rest(const T* p) {
  if constexpr (kAll) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// table form: the lane's hits among its 16 positions. kAll: the bucket
// offsets and keys are in shared memory too
template <bool kAll>
__device__ __forceinline__ int table_hits(const uint32_t (&w)[6], const uint32_t* bits,
                                          const uint16_t* ranks, const uint32_t* first,
                                          const int* off, const ulonglong2* keys) {
  uint32_t cand = 0;  // bit 15 - i: position i's pair is present
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t x = w[q];
    const uint32_t y = __funnelshift_r(w[q], w[q + 1], 8);  // byte r: the byte after x's
    const uint32_t h = (x >> 5) & 0x07070707u;               // byte r: b0 >> 5
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // word b1 | (b0 >> 5) << 8; bytes 2 and 3 replicate h's sign: 0
      const uint32_t word = bits[prmt(y, h, r | (4 + r) << 4 | (12 + r) << 8 | (12 + r) << 12)];
      const uint32_t rot = __funnelshift_r(word, word, x >> (8 * r));  // by b0 mod 32
      cand = __funnelshift_l(rot, cand, 1);
    }
  }
  int hits = 0;
  while (cand) {
    const int b = __ffs(cand) - 1;
    cand &= cand - 1;
    const unsigned long long win = window_at(w, 15 - b);
    const uint32_t b0 = static_cast<uint32_t>(win) & 0xFFu;
    const uint32_t b1 = static_cast<uint32_t>(win >> 8) & 0xFFu;
    bool hit = (first[b0 >> 5] >> (b0 & 31)) & 1u;
    if (!hit) {
      const uint32_t wi = b1 | (b0 >> 5) << 8;
      const int rank = ranks[wi] + __popc(bits[wi] & ((1u << ((b0 + 31) & 31)) - 1u));
      const int end = ld_rest<kAll>(off + rank + 1);
      for (int k = ld_rest<kAll>(off + rank); k < end; ++k) {
        const ulonglong2 kv = ld_rest<kAll>(keys + k);
        if ((win & kv.x) == kv.y) {
          hit = true;
          break;
        }
      }
    }
    hits += hit;
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

// The warp's blocks b, b + warps, ..., a chunk at a time, the next
// chunk's loads in flight while this one is tested; hits(w) counts a
// lane's 16 positions.
template <class Hits>
__device__ __forceinline__ void scan_blocks(const uint8_t* data, int64_t n, int block,
                                            int32_t* counts, Hits hits) {
  const int lane = threadIdx.x % 32;
  const int64_t n_blocks = n / block;
  const int chunks = block / kChunk;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
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
    count += hits(w);
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

template <int NK>
__global__ void __launch_bounds__(kThreads) swar_kernel(
    const uint8_t* __restrict__ data, int64_t n, int block, const __grid_constant__ SwarKeys g,
    int32_t* __restrict__ counts) {
  scan_blocks(data, n, block, counts,
              [&](const uint32_t (&w)[6]) { return swar_hits<NK>(w, g); });
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads) table_kernel(
    const uint8_t* __restrict__ data, int64_t n, int block, const __grid_constant__ Table t,
    int32_t* __restrict__ counts) {
  extern __shared__ uint4 smem[];
  const uint4* src = reinterpret_cast<const uint4*>(t.blob);
  for (int k = threadIdx.x; k < t.smem_bytes / 16; k += kThreads) smem[k] = __ldg(src + k);
  __syncthreads();
  const uint8_t* s = reinterpret_cast<const uint8_t*>(smem);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(s);
  const uint16_t* ranks = reinterpret_cast<const uint16_t*>(s + kPairWords * 4);
  const uint32_t* first = reinterpret_cast<const uint32_t*>(s + kPairWords * 6);
  const uint8_t* rest = t.blob;
  if constexpr (kAll) rest = s;
  const int* off = reinterpret_cast<const int*>(rest + t.off_at);
  const ulonglong2* keys = reinterpret_cast<const ulonglong2*>(rest + t.keys_at);
  scan_blocks(data, n, block, counts, [&](const uint32_t (&w)[6]) {
    return table_hits<kAll>(w, bits, ranks, first, off, keys);
  });
}

bool bad_args(const void* data, int64_t n, int block) {
  return n <= 0 || block <= 0 || block % kChunk || n % block ||
         reinterpret_cast<uintptr_t>(data) % 16;
}

// one wave of a kernel's resident blocks at its shared-memory size: the
// occupancy API asked once per (device, kernel, shared-memory bytes)
cudaError_t wave_of(const void* kernel, int device, int smem, int64_t* wave) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int64_t> waves;
  const auto key = std::make_tuple(device, kernel, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = waves.find(key);
    if (it != waves.end()) {
      *wave = it->second;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = static_cast<int64_t>(sms) * per_sm;
  std::lock_guard<std::mutex> lock(mu);
  waves[key] = *wave;
  return cudaSuccess;
}

// one wave of the kernel's resident blocks, at most one warp a block of
// the shard
cudaError_t grid_for(const void* kernel, int device, int64_t n, int block, int smem, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int64_t wave = 0;
  if ((err = wave_of(kernel, device, smem, &wave)) != cudaSuccess) return err;
  *grid = static_cast<int>(std::min<int64_t>((n / block + kWarps - 1) / kWarps, wave));
  return cudaSuccess;
}

template <int NK>
cudaError_t launch_swar(const uint8_t* data, int64_t n, int block, const SwarKeys& g,
                        int32_t* counts, int device, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(swar_kernel<NK>), device, n, block, 0, &grid);
  if (err != cudaSuccess) return err;
  swar_kernel<NK><<<grid, kThreads, 0, stream>>>(data, n, block, g, counts);
  return cudaGetLastError();
}

template <bool kAll>
cudaError_t launch_table(const uint8_t* data, int64_t n, int block, const Table& t,
                         int32_t* counts, int device, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(table_kernel<kAll>), device, n, block, t.smem_bytes, &grid);
  if (err != cudaSuccess) return err;
  table_kernel<kAll><<<grid, kThreads, t.smem_bytes, stream>>>(data, n, block, t, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// data: device uint8 [n], 16-byte aligned; n > 0 a multiple of block,
// block a positive multiple of 512; keys: host SwarKeys (144 bytes, the
// first k keys used), 1 <= k <= 5; counts: device int32 [n / block].
int gt_literal_counts_swar(const void* data, int64_t n, int block, const void* keys, int k,
                           void* counts, int device, void* stream) {
  if (bad_args(data, n, block) || k < 1 || k > kSwarMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SwarKeys g;
  std::memcpy(&g, keys, sizeof g);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* c = static_cast<int32_t*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch_swar<1>(d, n, block, g, c, device, s); break;
    case 2: err = launch_swar<2>(d, n, block, g, c, device, s); break;
    case 3: err = launch_swar<3>(d, n, block, g, c, device, s); break;
    case 4: err = launch_swar<4>(d, n, block, g, c, device, s); break;
    default: err = launch_swar<5>(d, n, block, g, c, device, s); break;
  }
  return static_cast<int>(err);
}

// blob: the device copy of LiteralTables.blob (blob_bytes, a multiple of
// 16, 16-byte aligned), its bucket offsets at off_at and keys at keys_at;
// the rest as above.
int gt_literal_counts_table(const void* data, int64_t n, int block, const void* blob,
                            int64_t blob_bytes, int off_at, int keys_at, void* counts,
                            int device, void* stream) {
  if (bad_args(data, n, block) || blob_bytes < kHeadBytes || blob_bytes % 16 ||
      reinterpret_cast<uintptr_t>(blob) % 16 || off_at < kHeadBytes || keys_at % 16 ||
      keys_at <= off_at || keys_at > blob_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool all = blob_bytes <= kSmemLimit;
  const Table t{static_cast<const uint8_t*>(blob), off_at, keys_at,
                all ? static_cast<int>(blob_bytes) : kHeadBytes};
  const auto* d = static_cast<const uint8_t*>(data);
  auto* c = static_cast<int32_t*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(all ? launch_table<true>(d, n, block, t, c, device, s)
                              : launch_table<false>(d, n, block, t, c, device, s));
}

}  // extern "C"
