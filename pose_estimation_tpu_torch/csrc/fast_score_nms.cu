// FAST-9/16 score and its 3x3-NMS-masked copy, one pass over a plane stack.
//
// Replaces the TPU kernel pose_estimation_tpu/ops/pallas_fast.py:_kernel
// (launched by fast_score_nms_pallas), the detection route the JAX package
// takes when the canvas width is not a multiple of 16 (KITTI's 1242). Same
// output contract as the torch twin ops/fast.py:score_nms_plain: for each
// plane, raw[y][x] is the FAST score and masked[y][x] the score where the
// 3x3 NMS keeps it, else 0; both [N, H, W] float32, every pixel written.
//
// Edges follow the TPU kernel: rows are edge-clamped (it pads the plane by
// 4 rows with mode="edge"), columns wrap (it rolls along the lane axis), and
// NMS ties break in raster order. So kernel, twin and the Pallas kernel are
// bit-equal on every pixel, not only inside the 19-px detection border.
//
// What bounds it on the H100: 4 bytes read and 8 written a pixel against
// ~120 float32 instructions (16 differences, 95 min/max in the shared-arc
// form of fast_common.cuh, 8 NMS compares), about equally; min and max
// issue at half the rate of adds and multiplies, so in practice the
// min/max arithmetic. The design spends nothing else per pixel: a block of
// 256 threads owns a 32-row x 128-column tile; each thread owns one column
// and walks down half of the tile's rows, so the loops carry no integer
// division and every ring offset is an immediate. The block stages the tile
// and its 4-px halo in shared memory (columns wrapped only in the first and
// last column block), scores the tile plus a 1-px ring there (34 x 130
// scores for 32 x 128 outputs, the ring's 68 spread over the threads), and
// writes both maps row by row, coalesced.

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

constexpr int TH = 32;                      // output rows per block
constexpr int TW = 128;                     // output columns per block
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / TW;        // 2 row groups of 128 threads
constexpr int HALO = fastk::HALO;
constexpr int LR = TH + 2 * HALO;           // 40 staged rows
constexpr int LC = TW + 2 * HALO;           // 136 staged columns
constexpr int SR = TH + 2;                  // 34 score rows (tile + 1-px ring)
constexpr int SC = TW + 2;                  // 130 score columns
static_assert(SR % GROUPS == 0 && TH % GROUPS == 0, "row groups split the tile evenly");

__device__ __forceinline__ int wrap(int x, int w) {
  while (x < 0) x += w;
  while (x >= w) x -= w;
  return x;
}

__global__ void __launch_bounds__(THREADS)
fast_score_nms_kernel(const float* __restrict__ stack, float* __restrict__ raw,
                      float* __restrict__ masked, int h, int w) {
  __shared__ float tile[LR][LC];
  __shared__ float score[SR][SC];

  const int tx = threadIdx.x % TW;          // column within the tile
  const int ty = threadIdx.x / TW;          // row group
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t off = (size_t)blockIdx.z * h * w;
  const float* img = stack + off;

  // ---- stage the tile + halo: rows clamped to the plane, columns wrapped.
  // Thread tx stages tile column tx and, for tx < 8, column 128 + tx.
  int gx0 = x0 - HALO + tx;
  int gx1 = x0 - HALO + TW + tx;
  if (x0 < HALO || x0 + TW + HALO > w) {
    gx0 = wrap(gx0, w);
    gx1 = wrap(gx1, w);
  }
  for (int r = ty; r < LR; r += GROUPS) {
    const float* row = img + (size_t)min(max(y0 - HALO + r, 0), h - 1) * w;
    tile[r][tx] = row[gx0];
    if (tx < 2 * HALO) tile[r][TW + tx] = row[gx1];
  }
  __syncthreads();

  // ---- FAST score on the tile plus a 1-px ring: score[r][c] is pixel
  // (y0 - 1 + r, x0 - 1 + c), centred on tile[r + 3][c + 3]. Thread tx
  // scores column tx + 1 over its group's 17 rows; the ring columns 0 and
  // 129 are spread over the first 68 threads.
#pragma unroll 1
  for (int i = 0; i < SR / GROUPS; ++i) {
    const int r = ty * (SR / GROUPS) + i;
    score[r][tx + 1] = fastk::score_at<LC>(&tile[r + 3][tx + 4]);
  }
  if (threadIdx.x < 2 * SR) {
    const int r = threadIdx.x >> 1;
    const int c = (threadIdx.x & 1) ? SC - 1 : 0;
    score[r][c] = fastk::score_at<LC>(&tile[r + 3][c + 3]);
  }
  __syncthreads();

  // ---- 3x3 NMS and the two outputs, one row of 128 columns at a time
  const int gx = x0 + tx;
  if (gx >= w) return;
#pragma unroll 4
  for (int i = 0; i < TH / GROUPS; ++i) {
    const int r = ty * (TH / GROUPS) + i;
    const int gy = y0 + r;
    if (gy >= h) break;
    const float s = score[r + 1][tx + 1];
    const bool keep = fastk::nms_keep(&score[0][0], SC, r + 1, tx + 1);
    const size_t o = off + (size_t)gy * w + gx;
    raw[o] = s;
    masked[o] = keep ? s : 0.0f;
  }
}

}  // namespace

extern "C" int fast_score_nms_launch(const float* stack, float* raw, float* masked,
                                     int n, int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fast_score_nms_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(stack, raw, masked, h, w);
  return (int)cudaGetLastError();
}
