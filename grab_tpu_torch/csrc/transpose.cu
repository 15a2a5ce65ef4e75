// Stream-row to stream-major relayout for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel grab_tpu/ops/pallas_stridedfa.py
// stride_transpose (the tiled Pallas relayout in front of the strided-DFA
// walk, reached through StrideDfaScanner.run / run2d and
// _StrideSeqMember.packed when the buffer arrives in linear layout).
//
// What it computes. a is int32 [n_streams, s_w]: row s holds the s_w
// words of stream s (linear bytes [s*stride, (s+1)*stride) of the scan
// buffer). The walk reads word g of stream s = r*128 + c at row
// g*128 + r, lane c, i.e. out int32 [s_w*128, 128] viewed as
// [s_w, n_streams] is the transpose of a:
//   out[g, s] = a[s, g].
//
// What bounds it. Bytes only: every word is read once and written once
// (2 x 32 MiB at the main geometry, 0.020 ms at 3.35 TB/s); there is no
// arithmetic beyond addresses.
//
// What the design does about it. The TPU kernel moved 16-band x
// 128-stream x 128-word tiles through VMEM because relayouts inside a
// tile are what cost there. Here the only thing that matters is that the
// reads (along s_w) and the writes (along the streams) are both coalesced:
// one block per 32 x 32 tile, a warp reads 32 consecutive words of one
// stream (128 B) into a shared tile padded to 33 columns, and after the
// barrier writes 32 consecutive streams of one word step (128 B); the
// padding keeps the column reads free of bank conflicts. Blocks carry no
// state, so the grid is one block per tile. s_w must be a multiple of 32
// (the scanner's strides give 32 or a multiple of 128).
//
// The kernel allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // tile edge in words
constexpr int kTileRows = 8;  // threadIdx.y extent: 4 rows per thread

__global__ void __launch_bounds__(kTile* kTileRows)
    transpose_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                     const int n_streams, const int s_w) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int g0 = blockIdx.x * kTile;  // first word step of the tile
  const int s0 = blockIdx.y * kTile;  // first stream of the tile
#pragma unroll
  for (int j = 0; j < kTile; j += kTileRows) {
    tile[ty + j][tx] = __ldg(a + static_cast<size_t>(s0 + ty + j) * s_w + g0 + tx);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTile; j += kTileRows) {
    out[static_cast<size_t>(g0 + ty + j) * n_streams + s0 + tx] = tile[tx][ty + j];
  }
}

}  // namespace

extern "C" {

// a:   device int32 [n_streams, s_w], contiguous
// out: device int32 [s_w, n_streams] (= [s_w * n_streams / 128, 128])
// n_streams and s_w multiples of 32. Returns a cudaError_t: 0 when the
// launch was accepted.
int gt_stride_transpose(const void* a, void* out, int n_streams, int s_w,
                        int device, void* stream) {
  if (n_streams <= 0 || s_w <= 0 || n_streams % kTile || s_w % kTile ||
      n_streams / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(s_w / kTile, n_streams / kTile);
  const dim3 block(kTile, kTileRows);
  transpose_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n_streams, s_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
