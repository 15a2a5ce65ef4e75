// The class-sequence test of fused.cu (classseq.cu has its own forms).
//
// A sequence is up to 8 byte classes, each class up to 8 inclusive byte
// ranges. Byte position i is a hit when, for some sequence, byte i + j
// lies in class j for every j; a word is a hit when any of its 4 byte
// positions is. The 4 phases are tested at once: class j of a sequence
// applies to window bytes j..j+3 (one funnel shift of the window w0, w1,
// w2), and a range test on 4 bytes is a SWAR compare into each byte's
// high bit (swar.cuh). A thread tests kSeqRows rows against each range it
// reads from the descriptor, so the descriptor reads are shared by 8
// words. A sequence's AND chain stops when no phase of the rows is left,
// and the rows at their first matching sequence.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "swar.cuh"

namespace grab_word {

constexpr int kMaxSeqs = 32;
constexpr int kMaxClasses = 8;  // PREFIX_CAP atoms per sequence
constexpr int kMaxRanges = 8;   // mask_to_ranges' cap per class
constexpr int kSeqRows = 8;     // rows tested together per descriptor read

// Byte layout shared with grab_tpu_torch/ops/classseq.py seq_descriptor
// (no padding: two int32 then uint8 arrays). Range t of class j of
// sequence s is [lo, hi].
struct SeqDesc {
  int32_t n_seqs;
  int32_t span;  // longest sequence, <= 8
  uint8_t len[kMaxSeqs];
  uint8_t n_ranges[kMaxSeqs][kMaxClasses];
  uint8_t lo[kMaxSeqs][kMaxClasses][kMaxRanges];
  uint8_t hi[kMaxSeqs][kMaxClasses][kMaxRanges];
};
static_assert(sizeof(SeqDesc) == 8 + 32 + 256 + 2048 + 2048, "layout");

// Host-side check of a descriptor handed over as bytes.
inline bool seq_desc_valid(const void* desc, int64_t desc_bytes) {
  if (desc_bytes != static_cast<int64_t>(sizeof(SeqDesc))) return false;
  const SeqDesc* d = static_cast<const SeqDesc*>(desc);
  return d->n_seqs >= 1 && d->n_seqs <= kMaxSeqs && d->span >= 1 &&
         d->span <= kMaxClasses;
}

// w0, w1, w2: the words holding window bytes 0..3, 4..7, 8..11 of each
// row (w1, w2 may be 0 when the longest sequence does not reach them).
// hits: rows already known to hit (bit i = row i); they are skipped.
// → hits with the rows this descriptor flags added.
__device__ __forceinline__ uint32_t classseq_hits(
    const SeqDesc& d, const uint32_t (&w0)[kSeqRows],
    const uint32_t (&w1)[kSeqRows], const uint32_t (&w2)[kSeqRows],
    uint32_t hits) {
  const int n_seqs = d.n_seqs;
  for (int s = 0; s < n_seqs && hits != (1u << kSeqRows) - 1; ++s) {
    const int len = d.len[s];
    // alive[i]: the phases of row i whose AND chain still holds
    uint32_t alive[kSeqRows];
#pragma unroll
    for (int i = 0; i < kSeqRows; ++i) alive[i] = (hits >> i) & 1u ? 0u : kH;
    uint32_t any = kH;
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) {
      if (j >= len || !any) break;
      // byte p of x is window byte p + j: class j at the 4 phases
      uint32_t x[kSeqRows], xl[kSeqRows], m[kSeqRows];
#pragma unroll
      for (int i = 0; i < kSeqRows; ++i) {
        const uint32_t lo = j < 4 ? w0[i] : w1[i];
        const uint32_t hi = j < 4 ? w1[i] : w2[i];
        x[i] = __funnelshift_r(lo, hi, 8 * (j & 3));
        xl[i] = x[i] & kL7;
        m[i] = 0;
      }
      const int n = d.n_ranges[s][j];
      for (int t = 0; t < n; ++t) {
        const Bound from(d.lo[s][j][t]), to(d.hi[s][j][t] + 1);
#pragma unroll
        for (int i = 0; i < kSeqRows; ++i) m[i] |= from.ge(x[i], xl[i]) & ~to.ge(x[i], xl[i]);
      }
      any = 0;
#pragma unroll
      for (int i = 0; i < kSeqRows; ++i) {
        alive[i] &= m[i];
        any |= alive[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kSeqRows; ++i) hits |= static_cast<uint32_t>(alive[i] != 0) << i;
  }
  return hits;
}

}  // namespace grab_word
