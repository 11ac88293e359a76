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
// What bounds it on the H100: per pixel it reads 4 bytes, writes 8 and does
// ~200 float32 min/max/sub operations, so memory traffic (89 MB for a
// [16, 375, 1242] stack) and the non-tensor float32 rate bound it about
// equally. The design reads each input pixel from device memory about once
// per block: a block stages a 16-row x 128-column tile plus a 4-px halo in
// shared memory, scores the tile plus a 1-px ring there and writes both
// outputs coalesced. A simple kernel; no attempt at overlap or reuse
// across tiles yet.

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

constexpr int TH = 16;                      // output rows per block
constexpr int TW = 128;                     // output columns per block
constexpr int HALO = fastk::HALO;
constexpr int LR = TH + 2 * HALO;           // 24 staged rows
constexpr int LC = TW + 2 * HALO;           // 136 staged columns
constexpr int SR = TH + 2;                  // 18 score rows (tile + 1-px ring)
constexpr int SC = TW + 2;                  // 130 score columns

__global__ void __launch_bounds__(256)
fast_score_nms_kernel(const float* __restrict__ stack, float* __restrict__ raw,
                      float* __restrict__ masked, int h, int w) {
  __shared__ float tile[LR][LC];
  __shared__ float score[SR][SC];

  const int plane = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t off = (size_t)plane * h * w;
  const float* img = stack + off;

  // ---- stage the tile + halo: rows clamped to the plane, columns wrapped
  for (int i = threadIdx.x; i < LR * LC; i += blockDim.x) {
    int r = i / LC, c = i % LC;
    int gy = min(max(y0 - HALO + r, 0), h - 1);
    int gx = (x0 - HALO + c) % w;
    if (gx < 0) gx += w;
    tile[r][c] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  // ---- FAST score on the tile plus a 1-px ring: score[r][c] is pixel
  // (y0 - 1 + r, x0 - 1 + c) (row clamped, column wrapped)
  for (int i = threadIdx.x; i < SR * SC; i += blockDim.x) {
    int r = i / SC, c = i % SC;
    score[r][c] = fastk::score_at(&tile[0][0], LC, r + 3, c + 3);
  }
  __syncthreads();

  // ---- 3x3 NMS and the two outputs
  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    int r = i / TW, c = i % TW;
    int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float s = score[r + 1][c + 1];
    bool keep = fastk::nms_keep(&score[0][0], SC, r + 1, c + 1);
    size_t o = off + (size_t)gy * w + gx;
    raw[o] = s;
    masked[o] = keep ? s : 0.0f;
  }
}

}  // namespace

extern "C" int fast_score_nms_launch(const float* stack, float* raw, float* masked,
                                     int n, int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fast_score_nms_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(stack, raw, masked, h, w);
  return (int)cudaGetLastError();
}
