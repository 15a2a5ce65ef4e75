// Last-resort DFA walk for Hopper (sm_90a): a segmented, speculative walk
// with an exact fix-up.
//
// Replaces the JAX package's device function grab_tpu/ops/dfa_scan.py
// dfa_scan_bitmap (a lax.scan, no Pallas kernel) together with
// bitmap_block_counts(bm, block): > 0 and packed into 32-bit words for the
// CLI's member (ops/dfa_scan.py DfaWalkMember, gt_dfa_walk), or the counts
// themselves for the sharded byte step (parallel/scan_step.py,
// gt_dfa_walk_counts).
//
// What it computes. A buffer of N bytes is split into S streams of
// seg = N / S bytes; h = min(halo, seg). Stream s walks the automaton
// from the start state over the bytes [s*seg, min(N, (s+1)*seg + h)),
// one transition per byte; position p is a candidate match end when the
// state after byte p accepts (the bit is not sticky). A stream's halo
// covers the first h positions of the next stream, whose own bits it ORs
// into; the reference's zero-padded halo of the last stream adds nothing
// to the output and is not walked. Block b (of `block` bytes) holds the
// candidates of its positions. Outputs, bit for bit as the plain version
// produces them:
//   gt_dfa_walk:        packed[g] bit i = block 32g + i holds a
//                       candidate; total[0] = the number of such blocks;
//   gt_dfa_walk_counts: counts[b] = the candidates in block b.
//
// What bounds it. The bytes: 32 MiB read once, 0.0100 ms at 3.35 TB/s;
// the integer work: 4 operations a byte walked (37.7 M bytes with the
// halos), 0.0090 ms over 132 SMs x 64 lanes at 1.98 GHz. A stream is one
// chain of seg + h dependent lookups (36,864 at the CLI's geometry, 0.73
// ms at ~40 SM cycles a link): one thread per stream cannot beat that.
// Cut into segments, the longest chain is a segment and its warm-up,
// 512 + 32 links (~11 us); what remains is the shared-memory pipe (a
// class lookup and a table lookup a byte, whose random addresses meet
// in banks) and the issue rate (about 10 instructions a byte).
//
// What the design does about it (the data-parallel finite-state-machine
// technique of Mytkowicz, Musuvathi and Schulte, ASPLOS 2014, as B2
// uses it in stridedfa.cu):
//   * Segments. A stream's window is cut at the multiples of
//     L = min(block, 512) bytes: segment p covers the window's bytes in
//     [base + pL, base + (p+1)L), base = the stream's start rounded down
//     to L. So a segment lies in one candidate block (at the CLI's
//     geometry it is one: 72 segments a stream, 73,728 a 32 MiB buffer).
//     One thread walks one segment; a block walks G streams of T
//     segments side by side (T = min(segments of the longest window,
//     128); a longer stream is walked in tiles of T, one after another,
//     segment 0 of a tile starting from the previous tile's exit).
//   * Guesses. Segment 0 of a stream starts from the start state, which
//     is exact. Segment p > 0 starts from a guess: the state reached by
//     walking the kWarm bytes before it from the start state (the search
//     automata the compiler emits mostly synchronise within a few bytes).
//     The thread keeps its state at the start of every kChunk bytes as a
//     checkpoint, in shared memory.
//   * Fix-up, exact on any automaton. Segment p's true entry is segment
//     p-1's exit. In rounds, each one barrier, every segment whose entry
//     differs from its predecessor's exit re-walks from that exit,
//     rewriting its results, and stops at the first checkpoint where its
//     state equals the recorded one (the deterministic walk is the
//     recorded one from there) or at its end with a new exit. After round
//     r the segments up to r + 1 are exact, so the walk is done at the
//     first round in which every entry equals its predecessor's exit; a
//     buffer whose guesses were right pays one barrier. An automaton
//     that never synchronises costs about one more chain per stream,
//     one segment a round. The re-walked bytes go to a device counter.
//   * Tables. The class-indexed table ([n_states, n_classes] 16-bit
//     entries, bits 0-14 the next state, bit 15 whether it accepts) sits
//     in shared memory up to kSharedTable; a larger one (up to 1 MiB) is
//     read from global memory (L2) by the same code. The class of a byte
//     does not depend on the state, so the 16 class lookups of a 16-byte
//     load are made in the links of the load before, in the chain's
//     stalls, which keeps one IMAD, one 16-bit ld.shared and one AND a
//     byte. The 256-byte class map sits in shared memory once: 64 words,
//     two a bank, so a warp's random bytes meet in at most 2-way
//     conflicts. (A copy per warp lane, as B2 keeps its byte index, was
//     slower on every case: its address costs more than the conflicts.)
//   * Loads. A thread walks a 64-byte chunk as 4 x 16 links with the next
//     chunk's four 16-byte loads in flight (a chunk of walking, ~2,500
//     cycles, covers a load from device memory).
//   * Outputs without a memset. A packed word that only one block's
//     windows reach is written with a plain store. A word that two or
//     more blocks reach (where a block's last stream's halo runs into the
//     next block's first stream, or a stream edge falls inside it) is
//     ORed into a device scratch, and the block that arrives last moves
//     it into `packed` and leaves the scratch zero; `total` is counted the
//     same way (group_count.cuh finish_count). So no stream operation
//     precedes the launch: the scratch belongs to one (device, stream)
//     and is zeroed once (ops/dfa_scan.py walk_scratch).
//   * Counts (the sharded step): the walk writes each segment's
//     candidate positions, 64 bits a chunk, into a record scratch
//     [S, p_max, L/kChunk]; a second kernel ORs, per position, the
//     records of every stream whose window covers it (a stream's halo and
//     the next stream's head) and counts them per block. Two launches.
// The chunk loops stay rolled (#pragma unroll 1); only the 4 x 16 links
// of one 64-byte chunk are unrolled: fully unrolled long loops were
// miscompiled in other kernels of this package (CUDA 12.8), so every
// geometry's bits are held against the plain walk on the card.
//
// The kernels allocate nothing and run on the caller's stream; the C
// entry points return cudaGetLastError() after the launches.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "group_count.cuh"

namespace {

constexpr int kSegMax = 512;        // bytes of a segment at most
constexpr int kChunk = 64;          // bytes between two checkpoints at most
constexpr int kWarm = 32;           // warm-up bytes of a guess
constexpr int kVecs = kChunk / 16;  // 16-byte loads of a chunk
constexpr int kTileMax = 128;       // segments of one stream walked side by side
constexpr int kBlockThreads = 576;  // threads of a block at most: 8 streams x 72
constexpr int64_t kSharedTable = 200 * 1024;  // table bytes kept in shared memory
constexpr int64_t kSmemLimit = 227 * 1024 - 64;  // dynamic shared memory of a block
constexpr uint32_t kStateMask = 0x7fffu;
constexpr int kMaxStates = 1 << 15;

// The walk's geometry (ops/dfa_scan.py walk_geometry mirrors the
// segments, p_max, tile and tiles).
struct Geometry {
  int64_t n, seg, h;
  int n_streams;
  int seg_shift;    // log2 L, L = min(block, kSegMax)
  int block_shift;  // log2 block
  int ck_shift;     // log2 of the chunk, min(kChunk, L)
  int n_ck;         // chunks of a segment
  int p_max;        // segments of the longest window
  int tile;         // T: segments of a stream walked side by side
  int tiles;
  int streams_per_block;  // G
  int grid;
};

__host__ __device__ inline int64_t stream_end(const Geometry& g, int64_t s) {
  const int64_t e = (s + 1) * g.seg + g.h;
  return e < g.n ? e : g.n;
}

__host__ __device__ inline int64_t stream_base(const Geometry& g, int64_t s) {
  return (s * g.seg) >> g.seg_shift << g.seg_shift;
}

__host__ __device__ inline int stream_segments(const Geometry& g, int64_t s) {
  return static_cast<int>((stream_end(g, s) - stream_base(g, s) + (int64_t{1} << g.seg_shift) - 1)
                          >> g.seg_shift);
}

struct Walk {
  Geometry geo;
  const uint8_t* data;       // N bytes, 16-byte aligned
  const uint16_t* table;     // [n_states * n_classes], padded to 16 bytes
  const uint8_t* class_map;  // [256], 16-byte aligned
  uint32_t start;
  int n_classes;
  int64_t table_vecs;        // 16-byte vectors of the padded table
  // dynamic shared memory: the class map, the table (shared form), then
  int off_ck, off_ex, off_flags;  // checkpoints, exits (two buffers), block flags
  int flag_words;
  // flags (gt_dfa_walk)
  uint32_t* packed;
  int32_t* total;
  int32_t* scratch;          // [2 + 2 * packed words]: count, blocks done; ORs; arrivals
  // counts (gt_dfa_walk_counts): [S * p_max * n_ck] candidate bits
  unsigned long long* records;
  unsigned long long* rewalked;  // += bytes re-walked by the fix-up (nullable)
};

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
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
    return kShared ? lds_u16(i) : static_cast<uint32_t>(__ldg(table + i));
  }
};

// The table and the byte → class map (256 bytes at `map` in shared
// memory).
template <bool kShared>
struct Lookup {
  Table<kShared> t;
  uint32_t map;

  __device__ __forceinline__ uint32_t cls(uint32_t byte) const { return lds_u8(map + byte); }
};

// The table columns of the 16 bytes of q.
template <bool kShared>
__device__ __forceinline__ void columns(const Lookup<kShared>& lk, const uint4 q,
                                        uint32_t (&c)[16]) {
  const uint32_t x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) c[k] = lk.t.col(lk.cls((x[k >> 2] >> (8 * (k & 3))) & 0xffu));
}

// Walks the 16 bytes whose columns are c from `state`, and between the
// links looks up the columns of the next load nq into cn (off the chain,
// in the chain's stalls). kBits: bit k of acc = the entry after byte k
// accepts; else acc ORs the entries.
template <bool kShared, bool kBits>
__device__ __forceinline__ uint32_t walk16(const Lookup<kShared>& lk,
                                           const uint32_t (&c)[16], const uint4 nq,
                                           uint32_t (&cn)[16], uint32_t state, uint32_t& acc) {
  const uint32_t x[4] = {nq.x, nq.y, nq.z, nq.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t e = lk.t.entry(state, c[k]);
    cn[k] = lk.cls((x[k >> 2] >> (8 * (k & 3))) & 0xffu);
    acc |= kBits ? (e >> 15) << k : e;
    state = e & kStateMask;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) cn[k] = lk.t.col(cn[k]);
  return state;
}

// Bytes k0 <= k < k1 of the load whose columns are c, as walk16 (a head
// or tail that does not fill a load).
template <bool kShared, bool kBits>
__device__ __forceinline__ uint32_t walk_part(const Lookup<kShared>& lk,
                                              const uint32_t (&c)[16], int k0, int k1,
                                              uint32_t state, uint32_t& acc) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= k0 && k < k1) {
      const uint32_t e = lk.t.entry(state, c[k]);
      acc |= kBits ? (e >> 15) << k : e;
      state = e & kStateMask;
    }
  }
  return state;
}

__device__ __forceinline__ uint4 load16(const uint8_t* data, int64_t v, int64_t hi) {
  return v < hi ? __ldg(reinterpret_cast<const uint4*>(data + v)) : make_uint4(0u, 0u, 0u, 0u);
}

// The kVecs loads of the chunk at x (those before hi).
__device__ __forceinline__ void load_chunk(const uint8_t* data, int64_t x, int64_t hi,
                                           uint4 (&a)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) a[i] = load16(data, x + 16 * i, hi);
}

// Walks [from, hi) from `state`: the bytes before lo are a guess's
// warm-up (from < lo) and give no result; `entry` is the state at lo. The
// segment [lo, hi) is walked a chunk at a time, chunk j covering
// [cbase + jC, cbase + (j+1)C), with the next chunk's loads in flight;
// each walked chunk's checkpoint (the state at its start, ck[j *
// ck_stride]) and result are recorded: kBits, rec[j] = its candidate bits
// (bit i: position cbase + jC + i); else bit j of cmask = some position of
// chunk j is a candidate. rewalk: stops at the first chunk after the
// first whose checkpoint equals the state (`merged`: the walk is the
// recorded one from there). → the segment's bytes walked; `state` is the
// exit unless merged. A whole 64-byte chunk is walked as 4 x 16 links,
// each load's class lookups made in the links of the one before.
template <bool kShared, bool kBits>
__device__ __forceinline__ int64_t walk_segment(const Walk& w, const Lookup<kShared>& lk,
                                                int64_t from, int64_t lo, int64_t hi,
                                                int64_t cbase, uint16_t* ck, int ck_stride,
                                                unsigned long long* rec, uint32_t& cmask,
                                                bool rewalk, uint32_t& state, uint32_t& entry,
                                                bool& merged) {
  const int ck_shift = w.geo.ck_shift;
  const int64_t chunk = int64_t{1} << ck_shift;
  const int j0 = static_cast<int>((lo - cbase) >> ck_shift);
  const int j1 = static_cast<int>((hi - 1 - cbase) >> ck_shift);
  uint4 a[kVecs], b[kVecs];
  load_chunk(w.data, cbase + j0 * chunk, hi, a);
  load_chunk(w.data, 0, 0, b);  // zeros: the loads after the last chunk
  if (from < lo) {  // the warm-up: at most kWarm / 16 loads before lo
    uint4 warm[kWarm / 16];
#pragma unroll
    for (int i = 0; i < kWarm / 16; ++i) {
      const int64_t v = lo - kWarm + 16 * i;
      warm[i] = load16(w.data, v, v + 16 > from ? lo : v);  // none before `from`'s load
    }
#pragma unroll
    for (int i = 0; i < kWarm / 16; ++i) {
      const int64_t v = lo - kWarm + 16 * i;
      if (v + 16 > from) {
        uint32_t c[16], acc = 0u;
        columns(lk, warm[i], c);
        state = walk_part<kShared, false>(
            lk, c, static_cast<int>(max(from - v, int64_t{0})), 16, state, acc);
      }
    }
  }
  entry = state;
  merged = false;
  uint32_t c[16], cn[16];
  bool ready = false;  // c holds the columns of a[0]
  int j = j0;
#pragma unroll 1
  for (;;) {
    if (rewalk && j > j0 && ck[j * ck_stride] == state) {
      merged = true;
      break;
    }
    ck[j * ck_stride] = static_cast<uint16_t>(state);
    const int64_t x = cbase + j * chunk;
    if (j < j1) load_chunk(w.data, x + chunk, hi, b);
    unsigned long long res = 0ull;
    if (chunk == 16 * kVecs && lo <= x && x + chunk <= hi) {  // a whole chunk
      if (!ready) columns(lk, a[0], c);
      uint32_t acc[kVecs] = {0u, 0u, 0u, 0u};
      state = walk16<kShared, kBits>(lk, c, a[1], cn, state, acc[0]);
      state = walk16<kShared, kBits>(lk, cn, a[2], c, state, acc[1]);
      state = walk16<kShared, kBits>(lk, c, a[3], cn, state, acc[2]);
      state = walk16<kShared, kBits>(lk, cn, b[0], c, state, acc[3]);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        res |= kBits ? static_cast<unsigned long long>(acc[i]) << (16 * i) : acc[i];
      }
      ready = true;
    } else {  // the loads of the chunk that meet [lo, hi), byte by byte
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int64_t v = x + 16 * i;
        if (16 * i < chunk && v < hi && v + 16 > lo) {
          uint32_t acc = 0u;
          columns(lk, a[i], c);
          state = walk_part<kShared, kBits>(
              lk, c, static_cast<int>(max(lo - v, int64_t{0})),
              static_cast<int>(min(hi - v, int64_t{16})), state, acc);
          res |= kBits ? static_cast<unsigned long long>(acc) << (16 * i) : acc;
        }
      }
      ready = false;
    }
    if (kBits) {
      rec[j] = res;
    } else {
      cmask = (cmask & ~(1u << j)) | (static_cast<uint32_t>(res >> 15) & 1u) << j;
    }
    if (j == j1) break;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) a[i] = b[i];
    ++j;
  }
  return (merged ? cbase + j * chunk : hi) - lo;
}

// Blocks whose windows reach packed word wd (their byte ranges, from
// their first stream's start to their last stream's end, meet it).
__device__ __forceinline__ int64_t word_blocks(const Geometry& g, int64_t wd) {
  const int shift = g.block_shift + 5;
  const int64_t x0 = wd << shift, x1 = (wd + 1) << shift;
  const int64_t span = static_cast<int64_t>(g.streams_per_block) * g.seg;
  const int64_t k_hi = min(static_cast<int64_t>(g.grid - 1), (x1 - 1) / span);
  const int64_t k_lo = x0 >= g.h ? min(static_cast<int64_t>(g.grid - 1), (x0 - g.h) / span) : 0;
  return k_hi - k_lo + 1;
}

template <bool kShared, bool kBits>
__global__ void __launch_bounds__(kBlockThreads) walk_kernel(const __grid_constant__ Walk w) {
  extern __shared__ uint4 smem[];
  __shared__ int s_count;
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem);
  const Geometry& g = w.geo;
  const int nthreads = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  constexpr int map_bytes = 256;
  for (int i = tid; i < map_bytes / 16; i += nthreads) {
    smem[i] = __ldg(reinterpret_cast<const uint4*>(w.class_map) + i);
  }
  if (tid == 0) s_count = 0;
  if (kShared) {
    uint4* dst = reinterpret_cast<uint4*>(sm + map_bytes);
    const uint4* src = reinterpret_cast<const uint4*>(w.table);
#pragma unroll 4
    for (int64_t i = tid; i < w.table_vecs; i += nthreads) dst[i] = __ldg(src + i);
  }
  uint32_t* flags = reinterpret_cast<uint32_t*>(sm + w.off_flags);
  if (!kBits) {
    for (int i = tid; i < w.flag_words; i += nthreads) flags[i] = 0u;
  }
  uint16_t* ck = reinterpret_cast<uint16_t*>(sm + w.off_ck) + tid;
  uint16_t* ex_a = reinterpret_cast<uint16_t*>(sm + w.off_ex);
  uint16_t* ex_b = ex_a + nthreads;
  const uint32_t sm_base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const Lookup<kShared> lk{
      {w.table, sm_base + map_bytes,
       kShared ? 2u * static_cast<uint32_t>(w.n_classes) : static_cast<uint32_t>(w.n_classes)},
      sm_base};
  __syncthreads();

  const int T = g.tile;
  const int gi = tid / T, q = tid - gi * T;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * g.streams_per_block + gi;
  const bool live = s < g.n_streams;
  const int64_t begin = s * g.seg;
  const int64_t end = stream_end(g, s);
  const int64_t base = stream_base(g, s);
  const int64_t seg_bytes = int64_t{1} << g.seg_shift;
  const int n_segs = live ? stream_segments(g, s) : 0;
  // the block's first packed word, in flag bits
  const int64_t flag0 =
      (static_cast<int64_t>(blockIdx.x) * g.streams_per_block * g.seg) >> (g.block_shift + 5) << 5;
  uint32_t tile_in = w.start;  // the state entering the tile's segment 0
  unsigned long long rewalked = 0ull;

  for (int tile = 0; tile < g.tiles; ++tile) {
    const int p = tile * T + q;
    const bool valid = p < n_segs;
    const int64_t cbase = base + static_cast<int64_t>(p) * seg_bytes;
    const int64_t lo = max(begin, cbase), hi = min(end, cbase + seg_bytes);
    unsigned long long* rec =
        kBits && valid ? w.records + (s * g.p_max + p) * g.n_ck : nullptr;
    uint32_t entry = 0u, cmask = 0u, state = 0u;
    if (valid) {
      // segment 0 of the tile from its true entry, the others from a guess
      state = q == 0 ? tile_in : w.start;
      const int64_t from = q == 0 ? lo : max(begin, lo - kWarm);
      if (kBits) {  // the chunks outside the segment hold no candidate
        const int j0 = static_cast<int>((lo - cbase) >> g.ck_shift);
        const int j1 = static_cast<int>((hi - 1 - cbase) >> g.ck_shift);
        for (int j = 0; j < g.n_ck; ++j) {
          if (j < j0 || j > j1) rec[j] = 0ull;
        }
      }
      bool merged;
      walk_segment<kShared, kBits>(w, lk, from, lo, hi, cbase, ck, nthreads, rec, cmask,
                                            false, state, entry, merged);
    }
    uint16_t* cur = ex_a;
    uint16_t* nxt = ex_b;
    cur[tid] = static_cast<uint16_t>(state);
    __syncthreads();
    // the fix-up: rounds until every entry is its predecessor's exit
    for (int round = 0; round <= T; ++round) {
      const uint32_t in = q == 0 ? tile_in : cur[tid - 1];
      const bool stale = valid && in != entry;
      uint32_t out = cur[tid];
      if (stale) {
        uint32_t st = in;
        bool merged;
        rewalked += walk_segment<kShared, kBits>(w, lk, lo, lo, hi, cbase, ck, nthreads,
                                                          rec, cmask, true, st, entry, merged);
        if (!merged) out = st;
      }
      nxt[tid] = static_cast<uint16_t>(out);
      const bool again = __syncthreads_or(stale);
      uint16_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (!again) break;
    }
    if (!kBits && valid && cmask != 0u) {
      const int64_t bit = (cbase >> g.block_shift) - flag0;
      atomicOr(flags + (bit >> 5), 1u << (bit & 31));
    }
    if (g.tiles > 1) {  // one stream a block: its next tile starts from this one's exit
      tile_in = cur[T - 1];
      __syncthreads();
    }
  }
  if (w.rewalked != nullptr && rewalked) atomicAdd(w.rewalked, rewalked);
  if (kBits) return;

  // packed words: a plain store where this block alone reaches the word,
  // else through the scratch (the last block to arrive stores it)
  __syncthreads();
  const int64_t n_words = g.n >> (g.block_shift + 5);
  const int64_t last = min(static_cast<int64_t>(g.n_streams),
                           (static_cast<int64_t>(blockIdx.x) + 1) * g.streams_per_block) - 1;
  const int64_t w0 = flag0 >> 5;
  const int64_t w1 = (stream_end(g, last) - 1) >> (g.block_shift + 5);
  uint32_t* ors = reinterpret_cast<uint32_t*>(w.scratch + 2);
  int32_t* arrivals = w.scratch + 2 + n_words;
  int count = 0;
  for (int64_t wd = w0 + tid; wd <= w1; wd += nthreads) {
    const uint32_t bits = flags[wd - w0];
    const int64_t shared_by = word_blocks(g, wd);
    if (shared_by == 1) {
      w.packed[wd] = bits;
      count += __popc(bits);
      continue;
    }
    if (bits) atomicOr(ors + wd, bits);
    __threadfence();
    if (atomicAdd(arrivals + wd, 1) == shared_by - 1) {
      __threadfence();
      const uint32_t all = atomicExch(ors + wd, 0u);
      atomicExch(arrivals + wd, 0);
      w.packed[wd] = all;
      count += __popc(all);
    }
  }
  if (count) atomicAdd(&s_count, count);
  __syncthreads();
  if (tid == 0) grab_count::finish_count(s_count, w.scratch, w.total);
}

// counts[b] = the candidates of block b: per position the OR of the
// records of every stream whose window covers it.
__global__ void count_kernel(const __grid_constant__ Geometry g,
                             const unsigned long long* __restrict__ records,
                             int32_t* __restrict__ counts) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= (g.n >> g.block_shift)) return;
  const int64_t seg_bytes = int64_t{1} << g.seg_shift;
  int sum = 0;
  const int64_t u1 = ((b + 1) << g.block_shift) >> g.seg_shift;
#pragma unroll 1
  for (int64_t u = (b << g.block_shift) >> g.seg_shift; u < u1; ++u) {
    const int64_t x0 = u * seg_bytes;
    const int64_t t_hi = min(static_cast<int64_t>(g.n_streams - 1), (x0 + seg_bytes - 1) / g.seg);
    const int64_t t_lo = x0 >= g.h ? (x0 - g.h) / g.seg : 0;
#pragma unroll 1
    for (int j = 0; j < g.n_ck; ++j) {
      unsigned long long bits = 0ull;
#pragma unroll 1
      for (int64_t t = t_lo; t <= t_hi; ++t) {
        const int64_t p = u - (stream_base(g, t) >> g.seg_shift);
        if (p >= 0 && p < stream_segments(g, t)) {
          bits |= __ldg(records + (t * g.p_max + p) * g.n_ck + j);
        }
      }
      sum += __popcll(bits);
    }
  }
  counts[b] = sum;
}

// The device's SMs (132 on an H100 SXM when it cannot be read).
int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    cached[device] = err == cudaSuccess && n > 0 ? n : 132;
  }
  return cached[device];
}

// The geometry of a walk of n bytes in n_streams streams (validated by
// the caller).
Geometry make_geometry(int64_t n, int n_streams, int64_t h, int block_shift, int device) {
  Geometry g{};
  g.n = n;
  g.seg = n / n_streams;
  g.h = h;
  g.n_streams = n_streams;
  g.block_shift = block_shift;
  g.seg_shift = block_shift < 9 ? block_shift : 9;  // L = min(block, kSegMax)
  g.ck_shift = g.seg_shift < 6 ? g.seg_shift : 6;    // min(kChunk, L)
  g.n_ck = 1 << (g.seg_shift - g.ck_shift);
  g.p_max = 0;
  for (int64_t s = 0; s < n_streams; ++s) g.p_max = std::max(g.p_max, stream_segments(g, s));
  g.tile = std::min(g.p_max, kTileMax);
  g.tiles = (g.p_max + g.tile - 1) / g.tile;
  if (g.tiles > 1) {
    g.streams_per_block = 1;
  } else {
    // enough blocks for every SM, at most kBlockThreads threads a block
    const int64_t fill = (n_streams + sm_count(device) - 1) / sm_count(device);
    g.streams_per_block = static_cast<int>(
        std::max(int64_t{1}, std::min(fill, static_cast<int64_t>(kBlockThreads / g.tile))));
  }
  g.grid = (n_streams + g.streams_per_block - 1) / g.streams_per_block;
  return g;
}

int64_t round16(int64_t x) { return (x + 15) & ~int64_t{15}; }

// Lays out the dynamic shared memory; → its bytes.
int64_t layout(Walk& w, bool shared, bool bits) {
  const Geometry& g = w.geo;
  const int64_t threads = static_cast<int64_t>(g.streams_per_block) * g.tile;
  int64_t off = 256;  // the class map
  if (shared) off += w.table_vecs * 16;
  w.off_ck = static_cast<int>(off);
  off += round16(threads * g.n_ck * 2);
  w.off_ex = static_cast<int>(off);
  off += round16(threads * 2 * 2);
  w.off_flags = static_cast<int>(off);
  // the block's packed words: its windows span at most G * seg + h bytes
  const int64_t span = static_cast<int64_t>(g.streams_per_block) * g.seg + g.h;
  w.flag_words = bits ? 0 : static_cast<int>((span >> (g.block_shift + 5)) + 2);
  off += round16(int64_t{w.flag_words} * 4);
  return off;
}

template <bool kShared, bool kBits>
cudaError_t launch_walk(const Walk& w, int64_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(walk_kernel<kShared, kBits>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  walk_kernel<kShared, kBits><<<w.geo.grid, w.geo.streams_per_block * w.geo.tile,
                                         static_cast<size_t>(smem), st>>>(w);
  return cudaGetLastError();
}

template <bool kBits>
cudaError_t dispatch(const Walk& w, bool shared, int64_t smem, cudaStream_t st) {
  return shared ? launch_walk<true, kBits>(w, smem, st) : launch_walk<false, kBits>(w, smem, st);
}

// Validates the arguments and plans the walk: the geometry and the
// table's place (shared memory up to kSharedTable, if the rest of the
// block's shared memory fits beside it). → cudaSuccess or
// cudaErrorInvalidValue; *shared_out = 1 if the table sits in shared
// memory (nullable).
cudaError_t plan(Walk& w, const void* data, int64_t n, int n_streams, int64_t h,
                 const void* table, int n_states, int n_classes, const void* class_map,
                 int start, int block_shift, bool bits, int device, bool& shared,
                 int64_t& smem, int* shared_out) {
  if (n <= 0 || n_streams < 1 || n % n_streams != 0 || h < 0 || h > n / n_streams ||
      n_states < 1 || n_states > kMaxStates || n_classes < 1 || n_classes > 256 ||
      start < 0 || start >= n_states || block_shift < 4 || block_shift > 24 ||
      n % (int64_t{32} << block_shift) != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(class_map) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  w.geo = make_geometry(n, n_streams, h, block_shift, device);
  w.data = static_cast<const uint8_t*>(data);
  w.table = static_cast<const uint16_t*>(table);
  w.class_map = static_cast<const uint8_t*>(class_map);
  w.start = static_cast<uint32_t>(start);
  w.n_classes = n_classes;
  const int64_t table_bytes = int64_t{n_states} * n_classes * 2;
  w.table_vecs = (table_bytes + 15) / 16;
  shared = w.table_vecs * 16 <= kSharedTable;
  smem = layout(w, shared, bits);
  if (shared && smem > kSmemLimit) {
    shared = false;
    smem = layout(w, shared, bits);
  }
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (shared_out != nullptr) *shared_out = shared ? 1 : 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// data:       device uint8 [n], 16-byte aligned; n a multiple of
//             n_streams and of 32 << block_shift
// h:          halo bytes, at most n / n_streams
// table:      device uint16 [n_states * n_classes] padded to 16 bytes,
//             entry = next state | accept(next state) << 15
// class_map:  device uint8 [256], 16-byte aligned
// packed:     device int32 [n >> (block_shift + 5)]
// total:      device int32 [1]
// scratch:    device int32 [scratch_len >= 2 + 2 * packed words], zero
//             before the launch and zero after it
// rewalked:   device uint64 [1], += bytes the fix-up re-walked (nullable)
// shared_out: host int, 1 if the table sits in shared memory (nullable)
// Returns a cudaError_t: 0 when the launch was accepted.
int gt_dfa_walk(const void* data, int64_t n, int n_streams, int64_t h, const void* table,
                int n_states, int n_classes, const void* class_map, int start, int block_shift,
                void* packed, void* total, void* scratch, int64_t scratch_len, void* rewalked,
                int* shared_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Walk w{};
  bool shared;
  int64_t smem;
  err = plan(w, data, n, n_streams, h, table, n_states, n_classes, class_map, start, block_shift,
             false, device, shared, smem, shared_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scratch_len < 2 + 2 * (n >> (block_shift + 5))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  w.packed = static_cast<uint32_t*>(packed);
  w.total = static_cast<int32_t*>(total);
  w.scratch = static_cast<int32_t*>(scratch);
  w.rewalked = static_cast<unsigned long long*>(rewalked);
  err = dispatch<false>(w, shared, smem, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The same walk, then the per-block candidate counts (two launches).
// records: device uint64 [records_len >= n_streams * p_max * chunks a
//          segment] (ops/dfa_scan.py WalkGeometry.record_words), the first
//          launch's scratch: each segment's candidate bits
// counts:  device int32 [n >> block_shift]
int gt_dfa_walk_counts(const void* data, int64_t n, int n_streams, int64_t h, const void* table,
                       int n_states, int n_classes, const void* class_map, int start,
                       int block_shift, void* records, int64_t records_len, void* counts,
                       void* rewalked, int* shared_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Walk w{};
  bool shared;
  int64_t smem;
  err = plan(w, data, n, n_streams, h, table, n_states, n_classes, class_map, start, block_shift,
             true, device, shared, smem, shared_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (records_len < int64_t{n_streams} * w.geo.p_max * w.geo.n_ck) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  w.records = static_cast<unsigned long long*>(records);
  w.rewalked = static_cast<unsigned long long*>(rewalked);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dispatch<true>(w, shared, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_blocks = n >> block_shift;
  count_kernel<<<static_cast<unsigned>((n_blocks + 255) / 256), 256, 0, st>>>(
      w.geo, w.records, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
