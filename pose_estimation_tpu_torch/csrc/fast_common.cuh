// FAST-9/16 score and 3x3 NMS on a tile staged in shared memory: the device
// code shared by kernels K1 (fast_select.cu) and K3 (fast_score_nms.cu).
//
// Both kernels stage an input tile with a 4-pixel halo (FAST ring 3 + NMS 1)
// and score the tile plus a 1-pixel ring; they differ only in how the halo
// is filled at the image edges (K1 clamps rows and columns, K3 clamps rows
// and wraps columns, as its TPU kernel and twin do). Scores are exact: the
// differences, minima and maxima of the same float32 values in any order.

#pragma once

#include <cuda_runtime.h>

namespace fastk {
namespace {

constexpr int HALO = 4;  // FAST ring 3 + NMS 1

// Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// FAST score of tile element (r, c): the max over bright and dark of the
// max over the 16 nine-long arcs of the minimum ring-minus-centre
// difference. `tile` is row-major with leading dimension `ld`; the ring
// reads rows r-3..r+3 and columns c-3..c+3.
__device__ __forceinline__ float score_at(const float* tile, int ld, int r, int c) {
  const float center = tile[r * ld + c];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[(r + kRingDy[k]) * ld + c + kRingDx[k]] - center;
  float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mn = d[s], mx = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      mn = fminf(mn, d[(s + j) & 15]);
      mx = fmaxf(mx, d[(s + j) & 15]);
    }
    bright = fmaxf(bright, mn);
    dark = fmaxf(dark, -mx);
  }
  return fmaxf(bright, dark);
}

// 3x3 NMS at score element (r, c) with raster tie-breaking: earlier
// neighbours must be strictly lower, later ones lower or equal.
__device__ __forceinline__ bool nms_keep(const float* score, int ld, int r, int c) {
  const float s = score[r * ld + c];
  const float* up = score + (r - 1) * ld + c;
  const float* mid = score + r * ld + c;
  const float* dn = score + (r + 1) * ld + c;
  return s > up[-1] && s > up[0] && s > up[1] && s > mid[-1] && s >= mid[1] &&
         s >= dn[-1] && s >= dn[0] && s >= dn[1];
}

}  // namespace
}  // namespace fastk
