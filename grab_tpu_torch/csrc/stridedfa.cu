// Strided DFA walk for Hopper (sm_90a), with the threading fixpoint.
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_stridedfa.py
// stride_dfa_scan (Pallas body _build_kernel), and runs the
// jax.lax.while_loop of StrideDfaScanner.run_t (the threading fixpoint)
// on the device as one launch.
//
// What it computes. The buffer is 16384 streams in stream-major layout:
// word g of stream s = r*128 + c at row g*128 + r, lane c, int32
// [S_w*128, 128]. Each stream walks the automaton from its entry state,
// K bytes per lookup: q = the K bytes' run/class indices idx[byte] in
// base m (earliest byte most significant), e = flat[state * m^K + q],
// state = e & (acc_bit-1).
// A word is a hit when acc_bit was set in any of its 4/K entries (accept
// is sticky inside an entry). Outputs, bit for bit as the TPU kernel's:
//   bm[R / 16, c]  bit R % 16 = hit at row R = g*128 + r
//   exits[s]       the state after the stream's last byte
//
// What bounds it. Bytes: the buffer is read once and the bitmap written
// once (32 MiB + 2 MiB: ~10 us at 3.35 TB/s). But a stream is a chain of
// S_w * 4/K dependent table lookups (1024 for a 32 MiB buffer at K = 2),
// ~40 SM cycles a link: with one thread per stream (16384 chains, ~4 warps
// per SM) no walk could beat S_w * 4/K links (20 us at K = 2). Cut into
// segments, the longest chain is a segment and its warm-up (144 links at
// K = 2, ~3 us), and what remains is instruction throughput: some 30
// instructions and 4 + 4/K shared-memory lookups per word, whose table
// lookups meet in banks, over 1024 threads per SM.
//
// What the design does about it: a segmented, speculative walk with an
// exact fix-up (the data-parallel finite-state-machine technique of
// Mytkowicz, Musuvathi and Schulte, ASPLOS 2014; the reference's stream
// threading argument applied inside a stream).
//   - Segments. A stream's word steps are cut into tiles of kSegs
//     segments of S <= kSegMax words (S = ceil(S_w / kSegs) when that is
//     smaller); one thread walks one segment, so a 32 MiB buffer is
//     131072 chains of 64 words. Segment 0 of a tile starts from the true
//     state (the stream's entry, or the previous tile's exit); segment
//     p > 0 from a guess: the state reached by walking the kWarm words
//     before it from the start state. The thread keeps its hits in a
//     64-bit register and its state at every kCk-th word as a checkpoint.
//   - Fix-up, exact on any automaton. Segment p's true entry is segment
//     p-1's exit. In rounds synchronised by the block, segment p becomes
//     final in round p (its predecessor is final by then); if its entry
//     differs from the one it walked from, it re-walks from the true one,
//     a checkpoint chunk at a time, rewriting its hits, and stops at the
//     first checkpoint where its state equals the recorded one (the
//     deterministic walk is the same from there) or at its end with a new
//     exit. So a segment re-walks at most once, and the block stops at the
//     first round in which every entry equals its predecessor's exit (all
//     walks are then the true ones). A guess that is never right (an
//     automaton that does not synchronise) costs about one more chain of
//     the stream, one segment after the other.
//   - Block layout. A block is 8 stream rows x 8 lanes x 8 segments
//     (512 threads, 256 blocks, two per SM): a warp reads 4 rows x 32
//     contiguous bytes per word step (whole sectors), and the hits go
//     through shared memory to the block's byte of each bitmap word (a
//     bitmap word holds 16 rows: two blocks own its two low bytes), 8
//     words x 8 rows at a time as one 64-bit bit-matrix transpose, written
//     only where some row was walked.
//   - Tables. The whole transition table (<= 4096 int32) and the byte's
//     run/class index sit in shared memory: one code path for run, runp,
//     cls and their 16-bit variants. The index is replicated per warp
//     lane (256 x 32 words), so its lookups of random bytes never share a
//     bank; the table lookups on the chain do. The index lookups of a word
//     do not depend on the state, so those of word j+1 are made before
//     word j's chain.
//
// The threading fixpoint (gt_stride_fixpoint) is the reference's
// while_loop (StrideDfaScanner.run_t) as ONE cooperative launch: a
// persistent grid of at most 256 walk blocks, as many as can be resident
// together (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs; block j
// walks the 64-stream tiles j, j + grid, ...), that loops on the card:
//   1. walk (every stream from the start state in round 0; later rounds
//      re-walk only the streams whose entry changed);
//   2. grid sync;
//   3. thread the exits into the entries (stream s gets stream s-1's
//      exit, stream 0 the start state), grid-stride over the streams;
//      a block that changed an entry sets the round's "changed" word;
//   4. grid sync;
//   5. stop when nothing changed (converged) or after max_rounds walks.
// Then the bitmap is filled with -1 if the entries still changed, the
// reference's fallback. So a buffer that converges in n walks costs n
// walks and one launch, with no stream operation before it: the two
// "changed" words (one per round parity) are zeroed by the kernel itself
// before its first grid sync, and the one a round will use is zeroed two
// syncs ahead of it, after every block has read it. The first walk
// stores every checkpoint in a device scratch (ckpt_words(S_w) int32); a
// later walk re-walks only streams whose entry changed, from segment 0
// through the same fix-up against the stored checkpoints, and leaves
// every other bitmap row and exit as they are. So the walks run, the
// final bitmap and the fallback equal the reference's. Words that one
// block writes and another reads after a grid sync (entries, exits, the
// changed words) are read past the L1 (__ldcg / volatile).
//
// The kernels allocate nothing and run on the caller's stream; the C
// entry points return the first launch error (cudaGetLastError()).

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStreamRows = 128;
constexpr int kLanes = 128;
constexpr int kStreams = kStreamRows * kLanes;  // 16384
constexpr int kMaxFlat = 4096;                  // CAPACITY16 entries
constexpr int kBlockRows = 8;                   // stream rows per block: half a bitmap word
constexpr int kBlockLanes = 8;                  // lanes per block: a warp reads 32-byte sectors
constexpr int kBlockStreams = kBlockRows * kBlockLanes;  // 64
constexpr int kSegs = 8;                        // segments per tile
constexpr int kThreads = kBlockStreams * kSegs;  // 512
constexpr int kBlocks = kStreams / kBlockStreams;  // 256
constexpr int kSegMax = 64;                     // words per segment (hits: 64 bits)
constexpr int kCk = 8;                          // words per checkpoint chunk
constexpr int kMaxCk = kSegMax / kCk;
constexpr int kWarm = 8;                        // warm-up words of a guess
static_assert(kWarm <= kCk, "the warm-up is one chunk");

// Segment geometry of a walk over s_w word steps (ops/stridedfa.py
// segment_geometry mirrors it).
struct Geometry {
  int seg;    // words per segment
  int tiles;  // tiles of kSegs segments
  int n_ck;   // checkpoints per segment
};

__host__ __device__ inline Geometry geometry(int s_w) {
  Geometry g;
  g.seg = (s_w + kSegs - 1) / kSegs;
  if (g.seg > kSegMax) g.seg = kSegMax;
  g.tiles = (s_w + kSegs * g.seg - 1) / (kSegs * g.seg);
  g.n_ck = (g.seg + kCk - 1) / kCk;
  return g;
}

int64_t ckpt_words(int64_t s_w) {
  const Geometry g = geometry(static_cast<int>(s_w));
  return static_cast<int64_t>(g.tiles) * kSegs * g.n_ck * kStreams;
}

// dynamic shared memory: the flat table, then the byte index [256][32],
// one copy per warp lane
constexpr size_t kDynSmem = (kMaxFlat + 256 * 32) * sizeof(int32_t);

struct WalkArgs {
  const uint32_t* words;
  int s_w;
  const int32_t* flat;
  int n_flat;
  const int32_t* idx;  // [256]: byte → run/class index
  int m;
  int mk;
  int acc_bit;
  int start;  // the automaton's start state: where a guess's warm-up begins
  const int32_t* entries;  // a single walk's entries
  int32_t* bm;
  int32_t* exits;
  int32_t* ckpt;        // checkpoint scratch (nullable: shared memory)
  unsigned long long* rewalked;  // += words re-walked by the fix-up (nullable)
};

struct Tables {
  const int32_t* flat;
  const int32_t* idx;
  int lane, m, mk, acc_bit, smask;
};

// q of each of the word's 4/K links: its K bytes' run/class indices in
// base m, the earliest byte most significant
template <int K>
__device__ __forceinline__ void link_indices(uint32_t x, const Tables& t, int* q) {
#pragma unroll
  for (int l = 0; l < 4 / K; ++l) {
    q[l] = 0;
#pragma unroll
    for (int p = l * K; p < (l + 1) * K; ++p) {
      q[l] = q[l] * t.m + t.idx[((x >> (8 * p)) & 0xffu) * 32 + t.lane];
    }
  }
}

// Walks the first n (<= kCk) words of w from state; → bit j = word j hit.
template <int K>
__device__ __forceinline__ uint32_t walk_chunk(const Tables& t, const uint32_t (&w)[kCk],
                                               int n, int& state) {
  constexpr int kLinks = 4 / K;
  int qn[kLinks];
  link_indices<K>(w[0], t, qn);
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kCk; ++j) {
    if (j < n) {
      int qc[kLinks];
#pragma unroll
      for (int l = 0; l < kLinks; ++l) qc[l] = qn[l];
      if (j + 1 < kCk) link_indices<K>(w[j + 1], t, qn);
      int hit = 0;
#pragma unroll
      for (int l = 0; l < kLinks; ++l) {
        const int e = t.flat[state * t.mk + qc[l]];
        hit |= e;
        state = e & t.smask;
      }
      bits |= static_cast<uint32_t>((hit & t.acc_bit) != 0) << j;
    }
  }
  return bits;
}

// An 8 x 8 bit matrix, row i in byte i, transposed: bit j of byte i ↔
// bit i of byte j (three delta swaps).
__device__ __forceinline__ unsigned long long transpose8(unsigned long long x) {
  unsigned long long t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// words [g0, min(g0 + kCk, end)) of the stream whose word 0 is col; 0 past end
__device__ __forceinline__ void load_chunk(const uint32_t* col, int g0, int end,
                                           uint32_t (&w)[kCk]) {
  constexpr size_t kStep = static_cast<size_t>(kStreamRows) * kLanes;
#pragma unroll
  for (int j = 0; j < kCk; ++j) w[j] = g0 + j < end ? __ldg(col + (g0 + j) * kStep) : 0u;
}

// The tables in shared memory (the flat table, then the byte index, one
// copy per warp lane: lane l reads bank l whatever the byte); the caller
// syncs the block before the first lookup.
__device__ __forceinline__ Tables load_tables(const WalkArgs& a, int32_t* s_tab) {
  const int t = threadIdx.x;
  for (int i = t; i < a.n_flat; i += kThreads) s_tab[i] = a.flat[i];
  int32_t* s_idx = s_tab + kMaxFlat;
  for (int i = t; i < 256 * 32; i += kThreads) s_idx[i] = a.idx[i / 32];
  return Tables{s_tab, s_idx, t % 32, a.m, a.mk, a.acc_bit, a.acc_bit - 1};
}

// One walk of the 64 streams of tile blk (8 rows x 8 lanes) by the whole
// block, from entries (nullable: every stream enters at start); block-
// uniform control flow, so it may return early. incremental: a fixpoint
// walk after the first, whose ckpt holds the last walk.
template <int K>
__device__ __forceinline__ void walk_block(const WalkArgs& a, const Tables& tab, int blk,
                                           const int32_t* entries, bool incremental) {
  __shared__ int32_t s_ck[kMaxCk][kThreads];       // checkpoints of a single walk
  __shared__ int32_t s_exit[kSegs][kBlockStreams];  // each segment's exit
  __shared__ unsigned long long s_hm[kSegs][kBlockStreams];  // each segment's hits
  __shared__ uint8_t s_upto[kSegs][kBlockStreams];  // words walked from the segment start
  __shared__ uint8_t s_final[kSegs][kBlockStreams];  // the segment's walk is the true one
  const int t = threadIdx.x;
  const int sl = t % kBlockStreams;  // stream in the block: r_l * 8 + c_l
  const int p = t / kBlockStreams;   // segment
  const int c_l = sl % kBlockLanes;
  const int r_l = sl / kBlockLanes;
  const int rg = blk / (kLanes / kBlockLanes);  // 8-row group
  const int cg = blk % (kLanes / kBlockLanes);  // 8-lane group
  const int r = rg * kBlockRows + r_l;
  const int c = cg * kBlockLanes + c_l;
  const int s = r * kLanes + c;
  const Geometry geo = geometry(a.s_w);
  const bool global_ck = a.ckpt != nullptr;
  // checkpoint j of (tile, segment p) lives at ck[j * ck_step]
  auto ck_at = [&](int tile) -> int32_t* {
    if (!global_ck) return &s_ck[0][t];
    return a.ckpt + (static_cast<size_t>(tile) * kSegs + p) * geo.n_ck * kStreams + s;
  };
  const int ck_step = global_ck ? kStreams : kThreads;
  // segment 0's true entry (read by p == 0); another block may have
  // written it before the last grid sync
  int tile_in = entries != nullptr ? __ldcg(entries + s) : a.start;

  if (incremental) {
    // a stream whose entry did not change keeps its rows and exit: a
    // block none of whose streams changed has nothing to do
    const bool moved = p == 0 && tile_in != a.ckpt[s];
    if (!__syncthreads_or(moved)) return;
  }
  const uint32_t* col = a.words + static_cast<size_t>(r) * kLanes + c;
  unsigned long long rewalked = 0;

  for (int tile = 0; tile < geo.tiles; ++tile) {
    const int t0 = tile * kSegs * geo.seg;
    const int tile_words = min(kSegs * geo.seg, a.s_w - t0);
    const int last_p = (tile_words - 1) / geo.seg;
    const int lo = t0 + p * geo.seg;
    const int n = max(0, min(geo.seg, a.s_w - lo));
    int32_t* ck = ck_at(tile);
    int entry = 0;                   // the entry the segment's hits are walked from
    unsigned long long hm = 0;       // bit j: word lo + j hit
    int upto = 0;                    // words [lo, lo + upto) walked in this launch
    if (incremental) {
      // the last walk, stored: its entries, exits and rows stand until
      // the fix-up moves them
      if (n > 0) entry = ck[0];
      if (p < last_p) {
        s_exit[p][sl] = ck_at(tile)[geo.n_ck * kStreams];  // segment p+1's entry
      } else if (p == last_p) {
        s_exit[p][sl] = tile + 1 < geo.tiles ? a.ckpt[static_cast<size_t>(tile + 1) * kSegs *
                                                          geo.n_ck * kStreams + s]
                                             : a.exits[s];
      }
    } else if (n > 0) {
      int state = tile_in;
      uint32_t cur[kCk], nxt[kCk];
      if (p > 0) {  // the guess: the kWarm words before the segment, from start
        const int wl = min(kWarm, lo);
        state = a.start;
        load_chunk(col, lo - wl, lo, cur);
        walk_chunk<K>(tab, cur, wl, state);
      }
      entry = state;
      load_chunk(col, lo, lo + n, cur);
      for (int j = 0; j * kCk < n; ++j) {
        load_chunk(col, lo + (j + 1) * kCk, lo + n, nxt);  // the next chunk in flight
        ck[j * ck_step] = state;
        const uint32_t bits = walk_chunk<K>(tab, cur, min(kCk, n - j * kCk), state);
        hm |= static_cast<unsigned long long>(bits) << (j * kCk);
#pragma unroll
        for (int i = 0; i < kCk; ++i) cur[i] = nxt[i];
      }
      upto = n;
      s_exit[p][sl] = state;
    }

    // the fix-up: rounds until every segment's entry is its predecessor's
    // exit; a segment is fixed once its predecessor is final, so each is
    // re-walked at most once
    bool final = false;
    s_final[p][sl] = 0;
    for (int round = 0; round < kSegs; ++round) {
      __syncthreads();
      const int in = p == 0 ? tile_in : s_exit[p - 1][sl];
      const bool ready = p == 0 || s_final[p - 1][sl];
      __syncthreads();
      const bool stale = n > 0 && in != entry;
      if (ready && !final) {
        final = true;
        s_final[p][sl] = 1;
      }
      if (stale && final) {
        int state = in;
        entry = in;
        bool merged = false;
        int j = 0;
        uint32_t cur[kCk], nxt[kCk];
        load_chunk(col, lo, lo + n, cur);
        for (; j * kCk < n; ++j) {
          if (j > 0 && ck[j * ck_step] == state) {
            merged = true;  // the same walk from here on
            break;
          }
          ck[j * ck_step] = state;
          load_chunk(col, lo + (j + 1) * kCk, lo + n, nxt);
          const uint32_t bits = walk_chunk<K>(tab, cur, min(kCk, n - j * kCk), state);
          hm = (hm & ~(((1ull << kCk) - 1) << (j * kCk))) |
               (static_cast<unsigned long long>(bits) << (j * kCk));
#pragma unroll
          for (int i = 0; i < kCk; ++i) cur[i] = nxt[i];
        }
        const int walked = min(n, j * kCk);
        rewalked += walked;
        upto = max(upto, walked);
        if (!merged) s_exit[p][sl] = state;
      }
      if (!__syncthreads_or(stale)) break;
    }

    // hits → bitmap words: bit r_l + 8 * (rg % 2) of bm[(t0 + w) * 8 +
    // rg / 2, c] for the rows walked at word t0 + w; the other rows' bits
    // stay. The block owns one byte of each bitmap word (the other 8-row
    // group the other), and the first walk zeroes the upper half. A task
    // is 8 words of one segment and lane: the 8 rows' hit and walked bits
    // as an 8 x 8 bit matrix, transposed into the 8 words' bytes.
    s_hm[p][sl] = hm;
    s_upto[p][sl] = static_cast<uint8_t>(upto);
    __syncthreads();
    const int chunks = (geo.seg + 7) / 8;
    for (int task = t; task < kSegs * kBlockLanes * chunks; task += kThreads) {
      const int cl = task % kBlockLanes;
      const int j0 = task / kBlockLanes % chunks * 8;
      const int sp = task / (kBlockLanes * chunks);
      const int n_sp = min(geo.seg, a.s_w - (t0 + sp * geo.seg));
      if (n_sp <= j0) continue;
      unsigned long long hits = 0, walked = 0;
#pragma unroll
      for (int rl = 0; rl < kBlockRows; ++rl) {
        const int q = rl * kBlockLanes + cl;
        const int u = min(8, max(0, s_upto[sp][q] - j0));
        hits |= ((s_hm[sp][q] >> j0) & 0xffull) << (8 * rl);
        walked |= static_cast<unsigned long long>((1u << u) - 1) << (8 * rl);
      }
      hits = transpose8(hits);
      walked = transpose8(walked);
      for (int k = 0; k < min(8, n_sp - j0); ++k) {
        const uint32_t mask = (walked >> (8 * k)) & 0xffu;
        if (!mask) continue;
        uint32_t bits = (hits >> (8 * k)) & mask;
        const size_t g = t0 + sp * geo.seg + j0 + k;
        int32_t* word = a.bm + (g * (kStreamRows / 16) + rg / 2) * kLanes + cg * kBlockLanes + cl;
        uint8_t* dst = reinterpret_cast<uint8_t*>(word) + rg % 2;
        if (mask != 0xffu) bits |= *dst & ~mask;
        *dst = static_cast<uint8_t>(bits);
        if (!incremental && rg % 2 == 0) reinterpret_cast<uint16_t*>(word)[1] = 0;
      }
    }
    tile_in = s_exit[last_p][sl];
    __syncthreads();
  }
  if (p == 0) a.exits[s] = tile_in;
  if (a.rewalked != nullptr && rewalked) atomicAdd(a.rewalked, rewalked);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2) walk_kernel(const WalkArgs a) {
  extern __shared__ int32_t s_tab[];
  const Tables tab = load_tables(a, s_tab);
  __syncthreads();
  walk_block<K>(a, tab, blockIdx.x, a.entries, false);
}

// The threading fixpoint in one cooperative launch (see the top of the
// file). ent: int32 [kStreams] scratch, the entries of the next walk;
// state: int32 [4] ← (converged, walks run), then the two "changed"
// words of the round parities, which the kernel zeroes itself.
template <int K>
__global__ void __launch_bounds__(kThreads, 2) fixpoint_kernel(const WalkArgs a, int32_t* ent,
                                                               int max_rounds, int32_t* state) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ int32_t s_tab[];
  const Tables tab = load_tables(a, s_tab);
  // the words of rounds 0 and 1: zero before the first grid sync, which
  // every block passes before it can set one
  if (blockIdx.x == 0 && threadIdx.x < 2) state[2 + threadIdx.x] = 0;
  __syncthreads();
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const int g_threads = gridDim.x * kThreads;
  int n = 0;
  bool converged = false;
  for (;;) {
    for (int blk = blockIdx.x; blk < kBlocks; blk += gridDim.x) {
      walk_block<K>(a, tab, blk, n > 0 ? ent : nullptr, n > 0);
    }
    grid.sync();
    int32_t* changed = state + 2 + (n & 1);
    bool moved = false;
    for (int s = gt; s < kStreams; s += g_threads) {
      const int32_t v = s == 0 ? a.start : __ldcg(a.exits + s - 1);
      moved |= v != (n == 0 ? a.start : __ldcg(ent + s));
      ent[s] = v;
    }
    if (__syncthreads_or(moved) && threadIdx.x == 0) *changed = 1;
    // the next round's word: every block read it (round n - 1) before
    // the sync above, and none sets it before the next one
    if (blockIdx.x == 0 && threadIdx.x == 0) state[2 + ((n + 1) & 1)] = 0;
    grid.sync();
    ++n;
    converged = __ldcg(changed) == 0;
    if (converged || n >= max_rounds) break;
  }
  if (!converged) {
    const int64_t n_bm = static_cast<int64_t>(a.s_w) * (kStreamRows / 16) * kLanes;
    for (int64_t i = gt; i < n_bm; i += g_threads) a.bm[i] = -1;
  }
  if (gt == 0) {
    state[0] = converged;
    state[1] = n;
  }
}

int check_args(int64_t s_w, int n_flat, int k, int m, int acc_bit, int start) {
  int64_t mk = 1;
  for (int i = 0; i < k; ++i) mk *= m;
  if (s_w <= 0 || s_w > (1 << 24) || n_flat <= 0 || n_flat > kMaxFlat ||
      (k != 1 && k != 2 && k != 4) || m <= 0 || mk > n_flat ||
      (acc_bit != (1 << 7) && acc_bit != (1 << 15)) || start < 0 ||
      start * mk >= n_flat) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The walk's shared memory is above the 48 KiB default: allowed once per
// device and kernel (a bit per device index).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, std::atomic<uint64_t>& allowed, int device) {
  const uint64_t bit = 1ull << (device & 63);
  if (!(allowed.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDynSmem));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  return cudaSuccess;
}

template <int K>
cudaError_t launch_k(const WalkArgs& a, int device, cudaStream_t st) {
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(walk_kernel<K>, allowed, device);
  if (err != cudaSuccess) return err;
  walk_kernel<K><<<kBlocks, kThreads, kDynSmem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_walk(const WalkArgs& a, int k, int device, cudaStream_t st) {
  switch (k) {
    case 4: return launch_k<4>(a, device, st);
    case 2: return launch_k<2>(a, device, st);
    default: return launch_k<1>(a, device, st);
  }
}

// The fixpoint's grid: the walk blocks that fit the card at once
// (occupancy x SMs, found once per device), at most kBlocks and at most
// max_blocks when that is positive. A card that cannot hold one block
// per SM, or no cooperative launch, is refused: there is no queued form.
template <int K>
cudaError_t launch_fixpoint_k(const WalkArgs& a, int32_t* ent, int max_rounds, int32_t* state,
                              int max_blocks, int* grid_out, int device, cudaStream_t st) {
  static std::atomic<uint64_t> allowed{0};
  static std::atomic<int> fits[64];  // blocks resident at once, per device (0: not found yet)
  cudaError_t err = allow_smem(fixpoint_kernel<K>, allowed, device);
  if (err != cudaSuccess) return err;
  int grid = fits[device & 63].load();
  if (grid == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fixpoint_kernel<K>, kThreads,
                                                          kDynSmem);
    }
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    grid = std::min(kBlocks, per_sm * sms);
    fits[device & 63].store(grid);
  }
  if (max_blocks > 0) grid = std::min(grid, max_blocks);
  *grid_out = grid;
  WalkArgs args = a;
  void* params[] = {&args, &ent, &max_rounds, &state};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fixpoint_kernel<K>),
                                    dim3(grid), dim3(kThreads), params, kDynSmem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

WalkArgs make_args(const void* words, int64_t s_w, const void* flat,
                   int n_flat, const void* idx, int k, int m, int acc_bit, int start,
                   void* rewalked) {
  WalkArgs a;
  a.words = static_cast<const uint32_t*>(words);
  a.s_w = static_cast<int>(s_w);
  a.flat = static_cast<const int32_t*>(flat);
  a.n_flat = n_flat;
  a.idx = static_cast<const int32_t*>(idx);
  a.m = m;
  a.mk = 1;
  for (int i = 0; i < k; ++i) a.mk *= m;
  a.acc_bit = acc_bit;
  a.start = start;
  a.entries = nullptr;
  a.bm = nullptr;
  a.exits = nullptr;
  a.ckpt = nullptr;
  a.rewalked = static_cast<unsigned long long*>(rewalked);
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

// int32 words of the fixpoint's checkpoint scratch for s_w word steps.
int64_t gt_stride_ckpt_words(int64_t s_w) {
  return s_w <= 0 || s_w > (1 << 24) ? -1 : ckpt_words(s_w);
}

// One walk. words: device int32 [s_w*128, 128]; flat: device int32
// [n_flat]; idx: device int32 [256]; entries, exits: device int32
// [128, 128]; bm: device int32 [s_w*8, 128]; rewalked: device uint64 [1]
// (nullable) += the words the fix-up re-walked.
int gt_stride_walk(const void* words, int64_t s_w, const void* flat,
                   int n_flat, const void* idx, int k, int m, int acc_bit,
                   int start, const void* entries, void* bm, void* exits,
                   void* rewalked, int device, void* stream) {
  int bad = check_args(s_w, n_flat, k, m, acc_bit, start);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  WalkArgs a = make_args(words, s_w, flat, n_flat, idx, k, m, acc_bit, start, rewalked);
  a.entries = static_cast<const int32_t*>(entries);
  a.bm = static_cast<int32_t*>(bm);
  a.exits = static_cast<int32_t*>(exits);
  return static_cast<int>(launch_walk(a, k, device, static_cast<cudaStream_t>(stream)));
}

// The threading fixpoint: up to max_rounds walks in one cooperative
// launch. ent: device int32 [128, 128] scratch (the current entries);
// ckpt: device int32 scratch of ckpt_words >= gt_stride_ckpt_words(s_w);
// state: device int32 [4] ← (converged, walks run, 2 words of the
// kernel's own). bm ends as the bitmap of the walk from the converged
// entries, or all -1. max_blocks > 0 caps the grid (the blocks then
// take more tiles each); *grid ← the grid launched.
int gt_stride_fixpoint(const void* words, int64_t s_w, const void* flat,
                       int n_flat, const void* idx, int k, int m,
                       int acc_bit, int start, int max_rounds, void* ent,
                       void* ckpt, int64_t n_ckpt, void* bm, void* exits,
                       void* state, void* rewalked, int max_blocks, int* grid,
                       int device, void* stream) {
  int bad = check_args(s_w, n_flat, k, m, acc_bit, start);
  if (bad) return bad;
  if (max_rounds < 1 || ckpt == nullptr || n_ckpt < ckpt_words(s_w) || grid == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WalkArgs a = make_args(words, s_w, flat, n_flat, idx, k, m, acc_bit, start, rewalked);
  a.bm = static_cast<int32_t*>(bm);
  a.exits = static_cast<int32_t*>(exits);
  a.ckpt = static_cast<int32_t*>(ckpt);
  int32_t* e = static_cast<int32_t*>(ent);
  int32_t* sf = static_cast<int32_t*>(state);
  switch (k) {
    case 4: err = launch_fixpoint_k<4>(a, e, max_rounds, sf, max_blocks, grid, device, st); break;
    case 2: err = launch_fixpoint_k<2>(a, e, max_rounds, sf, max_blocks, grid, device, st); break;
    default: err = launch_fixpoint_k<1>(a, e, max_rounds, sf, max_blocks, grid, device, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
