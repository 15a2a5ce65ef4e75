// Strided DFA walk for Hopper (sm_90a), with the threading fixpoint.
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_stridedfa.py
// stride_dfa_scan (Pallas body _build_kernel), and queues the
// jax.lax.while_loop of StrideDfaScanner.run_t on the device.
//
// What it computes. The buffer is 16384 streams in stream-major layout:
// word g of stream s = r*128 + c at row g*128 + r, lane c, int32
// [S_w*128, 128]. Each stream walks the automaton from its entry state,
// K bytes per lookup: q = sum over the K bytes of sidx[p][byte] (the
// byte's run/class index scaled by its place in base m, earliest byte
// most significant), e = flat[state * m^K + q], state = e & (acc_bit-1).
// A word is a hit when acc_bit was set in any of its 4/K entries (accept
// is sticky inside an entry). Outputs, bit for bit as the TPU kernel's:
//   bm[R / 16, c]  bit R % 16 = hit at row R = g*128 + r
//   exits[s]       the state after the stream's last byte
//
// What bounds it. Bytes: the buffer is read once and the bitmap written
// once (32 MiB + 2 MiB: ~10 us at 3.35 TB/s). But each stream is a chain
// of S_w * 4/K dependent table lookups (2048 for a 32 MiB buffer at
// K = 1), and the geometry gives one thread per stream: 16384 threads,
// ~4 warps per SM, too few to hide the latency of a shared-memory
// lookup. So the walk is bound by the chain: S_w * 4/K lookups times
// the latency of one link (index arithmetic + shared load), not by
// bytes. Keeping the reference's 16384-stream geometry keeps the flags
// comparable bit for bit; more streams (shorter chains) is later work.
//
// What the design does about it. The whole table (flat, <= 4096 int32
// entries) and the 4 x 256 scaled byte index sit in shared memory, so
// run, runp, cls and their 16-bit variants are one code path: one
// lookup per K bytes, where the TPU needed one gather + select per
// packed table row. The K index lookups of a link do not depend on the
// state, so only the table lookup is on the chain: the next word's
// index lookups are issued before the current word's chain. A block is 16
// stream-rows x 8 lanes (128 threads, 128 blocks): a warp reads 4 rows
// x 32 contiguous bytes per word step, whole 32-byte sectors. Words come
// in chunks of 32 steps, the next chunk's loads issued before the
// current chunk is walked (double buffering in registers), so memory
// latency hides behind the chain. Each thread keeps its chunk's hits as
// a 32-bit mask; at the chunk's end the block transposes them through
// shared memory into bitmap words (16 rows per word), written as whole
// sectors.
//
// The fixpoint (gt_stride_fixpoint) queues max_rounds walks without a
// host sync: after each walk a one-block kernel threads the exits into
// the next entries (stream s gets stream s-1's exit, stream 0 the start
// state), counts the walk, and sets a device "converged" word when the
// entries did not change; every later walk and threading kernel returns
// at once when that word is set. A last kernel fills the bitmap with -1
// if the entries still changed after the last walk, the reference's
// fallback. So the walks run, the final bitmap (the walk from the
// converged entries) and the fallback equal the reference's.
//
// The kernels allocate nothing and run on the caller's stream; the C
// entry points return the first launch error (cudaGetLastError()).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStreamRows = 128;
constexpr int kLanes = 128;
constexpr int kStreams = kStreamRows * kLanes;  // 16384
constexpr int kMaxFlat = 4096;                  // CAPACITY16 entries
constexpr int kBlockRows = 16;                  // stream rows per block
constexpr int kBlockLanes = 8;                  // lanes per block
constexpr int kThreads = kBlockRows * kBlockLanes;  // 128
constexpr int kChunk = 32;                      // word steps per hit mask

struct WalkArgs {
  const uint32_t* words;
  int s_w;
  const int32_t* flat;
  int n_flat;
  const int32_t* sidx;  // [4][256]
  int mk;
  int acc_bit;
  const int32_t* entries;
  int32_t* bm;
  int32_t* exits;
  const int32_t* done;  // skip the walk when *done != 0 (nullable)
};

// q of each of the word's 4/K links: the sum of its K bytes' scaled
// run/class indices
template <int K>
__device__ __forceinline__ void link_indices(uint32_t x, const int32_t (*s_idx)[256],
                                             int* q) {
#pragma unroll
  for (int l = 0; l < 4 / K; ++l) {
    q[l] = 0;
#pragma unroll
    for (int p = l * K; p < (l + 1) * K; ++p) q[l] += s_idx[p][(x >> (8 * p)) & 0xffu];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) walk_kernel(const WalkArgs a) {
  if (a.done != nullptr && *a.done) return;
  __shared__ int32_t s_flat[kMaxFlat];
  __shared__ int32_t s_idx[4][256];
  __shared__ uint32_t s_hits[kBlockRows][kBlockLanes];
  const int t = threadIdx.x;
  for (int i = t; i < a.n_flat; i += kThreads) s_flat[i] = a.flat[i];
  for (int i = t; i < 4 * 256; i += kThreads) (&s_idx[0][0])[i] = a.sidx[i];
  const int rg = blockIdx.x / (kLanes / kBlockLanes);  // 16-row group
  const int cg = blockIdx.x % (kLanes / kBlockLanes);  // 8-lane group
  const int r_l = t / kBlockLanes;
  const int c_l = t % kBlockLanes;
  const int r = rg * kBlockRows + r_l;
  const int c = cg * kBlockLanes + c_l;
  const int s = r * kLanes + c;
  int state = a.entries[s];
  const int smask = a.acc_bit - 1;
  __syncthreads();

  // word of step g for this stream
  const uint32_t* col = a.words + static_cast<size_t>(r) * kLanes + c;
  const size_t step = static_cast<size_t>(kStreamRows) * kLanes;
  uint32_t cur[kChunk];
  uint32_t nxt[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    cur[j] = j < a.s_w ? __ldg(col + j * step) : 0u;
  }
  for (int g0 = 0; g0 < a.s_w; g0 += kChunk) {
    const int n = min(kChunk, a.s_w - g0);
    const int g1 = g0 + kChunk;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      nxt[j] = g1 + j < a.s_w ? __ldg(col + (g1 + j) * step) : 0u;
    }
    // the links' indices do not depend on the state: those of word j+1
    // are looked up before word j's chain runs, so their latency hides
    // behind it
    constexpr int kLinks = 4 / K;
    int qn[kLinks];
    link_indices<K>(cur[0], s_idx, qn);
    uint32_t hm = 0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < n) {
        int qc[kLinks];
#pragma unroll
        for (int l = 0; l < kLinks; ++l) qc[l] = qn[l];
        if (j + 1 < kChunk) link_indices<K>(cur[j + 1], s_idx, qn);
        int hit = 0;
#pragma unroll
        for (int l = 0; l < kLinks; ++l) {
          const int e = s_flat[state * a.mk + qc[l]];
          hit |= e;
          state = e & smask;
        }
        hm |= static_cast<uint32_t>((hit & a.acc_bit) != 0) << j;
      }
    }
    // hits of 16 stream rows x 8 lanes x n steps → bitmap words
    s_hits[r_l][c_l] = hm;
    __syncthreads();
    for (int o = t; o < n * kBlockLanes; o += kThreads) {
      const int j = o / kBlockLanes;
      const int cl = o % kBlockLanes;
      uint32_t word = 0;
#pragma unroll
      for (int rl = 0; rl < kBlockRows; ++rl) {
        word |= ((s_hits[rl][cl] >> j) & 1u) << rl;
      }
      const size_t row = static_cast<size_t>(g0 + j) * (kStreamRows / 16) + rg;
      a.bm[row * kLanes + cg * kBlockLanes + cl] = static_cast<int32_t>(word);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = nxt[j];
  }
  a.exits[s] = state;
}

// state[0]: converged (entries stopped changing); state[1]: walks run.
__global__ void thread_kernel(const int32_t* __restrict__ exits,
                              int32_t* __restrict__ ent, int start,
                              int32_t* state) {
  if (state[0]) return;
  bool changed = false;
  for (int s = threadIdx.x; s < kStreams; s += blockDim.x) {
    const int32_t v = s == 0 ? start : exits[s - 1];
    changed |= v != ent[s];
    ent[s] = v;
  }
  const int any = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    state[1] += 1;
    if (!any) state[0] = 1;
  }
}

__global__ void fill_kernel(int32_t* __restrict__ p, int n, int32_t v) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    p[i] = v;
  }
}

__global__ void fallback_kernel(int32_t* __restrict__ bm, int64_t n,
                                const int32_t* state) {
  if (state[0]) return;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    bm[i] = -1;
  }
}

int check_args(int64_t s_w, int n_flat, int k, int mk, int acc_bit) {
  if (s_w <= 0 || s_w > (1 << 24) || n_flat <= 0 || n_flat > kMaxFlat ||
      (k != 1 && k != 2 && k != 4) || mk <= 0 || mk > n_flat ||
      (acc_bit != (1 << 7) && acc_bit != (1 << 15))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

void launch_walk(const WalkArgs& a, int k, cudaStream_t st) {
  const int blocks = (kStreamRows / kBlockRows) * (kLanes / kBlockLanes);
  switch (k) {
    case 4: walk_kernel<4><<<blocks, kThreads, 0, st>>>(a); break;
    case 2: walk_kernel<2><<<blocks, kThreads, 0, st>>>(a); break;
    default: walk_kernel<1><<<blocks, kThreads, 0, st>>>(a); break;
  }
}

WalkArgs make_args(const void* words, int64_t s_w, const void* flat,
                   int n_flat, const void* sidx, int mk, int acc_bit) {
  WalkArgs a;
  a.words = static_cast<const uint32_t*>(words);
  a.s_w = static_cast<int>(s_w);
  a.flat = static_cast<const int32_t*>(flat);
  a.n_flat = n_flat;
  a.sidx = static_cast<const int32_t*>(sidx);
  a.mk = mk;
  a.acc_bit = acc_bit;
  a.entries = nullptr;
  a.bm = nullptr;
  a.exits = nullptr;
  a.done = nullptr;
  return a;
}

// Latency of one walk link, for the chain bound: one warp, each lane
// chasing its own path through a 4096-entry shared table with the
// link's arithmetic (IMAD + LDS + AND), clock64() around n dependent
// links; lanes start apart, so bank conflicts are like the walk's.
__global__ void link_latency_kernel(int n_links, int mk, int64_t* cycles) {
  __shared__ int32_t tab[kMaxFlat];
  for (int i = threadIdx.x; i < kMaxFlat; i += blockDim.x) {
    tab[i] = (i * 1657 + 1) & (kMaxFlat - 1);  // one cycle through all 4096
  }
  __syncthreads();
  int state = threadIdx.x * 97;
  const long long t0 = clock64();
  for (int i = 0; i < n_links; ++i) state = tab[state * mk] & (kMaxFlat - 1);
  const long long t1 = clock64();
  if (state == -1) cycles[1] = state;  // keeps the chain live
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

}  // namespace

extern "C" {

// cycles: device int64 [2]; cycles[0] ← SM clock cycles for n_links
// dependent links of lane 0.
int gt_stride_link_cycles(int n_links, void* cycles, int device, void* stream) {
  if (n_links <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  link_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n_links, 1, static_cast<int64_t*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// One walk. words: device int32 [s_w*128, 128]; flat: device int32
// [n_flat]; sidx: device int32 [4, 256]; entries, exits: device int32
// [128, 128]; bm: device int32 [s_w*8, 128].
int gt_stride_walk(const void* words, int64_t s_w, const void* flat,
                   int n_flat, const void* sidx, int k, int mk, int acc_bit,
                   const void* entries, void* bm, void* exits, int device,
                   void* stream) {
  int bad = check_args(s_w, n_flat, k, mk, acc_bit);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  WalkArgs a = make_args(words, s_w, flat, n_flat, sidx, mk, acc_bit);
  a.entries = static_cast<const int32_t*>(entries);
  a.bm = static_cast<int32_t*>(bm);
  a.exits = static_cast<int32_t*>(exits);
  launch_walk(a, k, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The threading fixpoint: up to max_rounds walks, queued at once.
// ent: device int32 [128, 128] scratch (the current entries); state:
// device int32 [2] ← (converged, walks run). bm ends as the bitmap of
// the walk from the converged entries, or all -1.
int gt_stride_fixpoint(const void* words, int64_t s_w, const void* flat,
                       int n_flat, const void* sidx, int k, int mk,
                       int acc_bit, int start, int max_rounds, void* ent,
                       void* bm, void* exits, void* state, int device,
                       void* stream) {
  int bad = check_args(s_w, n_flat, k, mk, acc_bit);
  if (bad) return bad;
  if (max_rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* e = static_cast<int32_t*>(ent);
  int32_t* sflag = static_cast<int32_t*>(state);
  err = cudaMemsetAsync(sflag, 0, 2 * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_kernel<<<kStreams / 256, 256, 0, st>>>(e, kStreams, start);
  WalkArgs a = make_args(words, s_w, flat, n_flat, sidx, mk, acc_bit);
  a.entries = e;
  a.bm = static_cast<int32_t*>(bm);
  a.exits = static_cast<int32_t*>(exits);
  a.done = sflag;
  for (int round = 0; round < max_rounds; ++round) {
    launch_walk(a, k, st);
    thread_kernel<<<1, 1024, 0, st>>>(a.exits, e, start, sflag);
  }
  const int64_t n_bm = s_w * (kStreamRows / 16) * kLanes;
  fallback_kernel<<<264, 256, 0, st>>>(a.bm, n_bm, sflag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
