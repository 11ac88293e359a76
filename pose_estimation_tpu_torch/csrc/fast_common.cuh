// FAST-9/16 score and 3x3 NMS on a tile staged in shared memory: the device
// code shared by kernels K1 (fast_select.cu) and K3 (fast_score_nms.cu).
//
// Both kernels stage an input tile with a 4-pixel halo (FAST ring 3 + NMS 1)
// and score the tile plus a 1-pixel ring; they differ in how the halo is
// filled at the image edges (K1 clamps rows and columns, K3 clamps rows and
// wraps columns, as its TPU kernel and twin do) and in their tiling. Scores
// are exact: differences, minima, maxima and negations of the same float32
// values in any order.

#pragma once

#include <cuda_runtime.h>

namespace fastk {
namespace {

constexpr int HALO = 4;  // FAST ring 3 + NMS 1

// FAST score of the tile element at `p`: the max over bright and dark of
// the max over the 16 nine-long arcs of the ring, d the 16 ring-minus-centre
// differences (Bresenham circle of radius 3, clockwise from 12 o'clock):
//   bright = max_s min(d[s .. s+8]),  dark = max_s min(-d[s .. s+8]),
// the torch twin's arc form (ops/fast.py), whose value this returns exactly
// (min, max and negation of the same float32 values, in another order).
// The arcs are not taken one by one: the arcs starting at 2j and 2j+1
// share the eight elements W_j = d[2j+1 .. 2j+8], so with
//   max(min(d[2j], W_j), min(d[2j+9], W_j)) = min(W_j, max(d[2j], d[2j+9]))
// both polarities take 8 pair, 8 four-long and 8 eight-long window extrema,
// 16 for the pairs of arcs and 7 to reduce: 47 min/max a polarity where
// the twin's form takes 79. dark = -min_j max(max W_j, min(d[2j], d[2j+9])).
// LD is the tile's leading dimension, so every ring offset is an immediate.
template <int LD>
__device__ __forceinline__ float score_at(const float* p) {
  const float c = p[0];
  const float d[16] = {
      p[-3 * LD] - c,     p[-3 * LD + 1] - c, p[-2 * LD + 2] - c, p[-LD + 3] - c,
      p[3] - c,           p[LD + 3] - c,      p[2 * LD + 2] - c,  p[3 * LD + 1] - c,
      p[3 * LD] - c,      p[3 * LD - 1] - c,  p[2 * LD - 2] - c,  p[LD - 3] - c,
      p[-3] - c,          p[-LD - 3] - c,     p[-2 * LD - 2] - c, p[-3 * LD - 1] - c};
  float lo2[8], hi2[8], lo4[8], hi4[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {              // d[2j+1 .. 2j+2]
    lo2[j] = fminf(d[2 * j + 1], d[(2 * j + 2) & 15]);
    hi2[j] = fmaxf(d[2 * j + 1], d[(2 * j + 2) & 15]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {              // d[2j+1 .. 2j+4]
    lo4[j] = fminf(lo2[j], lo2[(j + 1) & 7]);
    hi4[j] = fmaxf(hi2[j], hi2[(j + 1) & 7]);
  }
  float bright = 0.0f, dark = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {              // W_j = d[2j+1 .. 2j+8]
    const float a = d[2 * j], e = d[(2 * j + 9) & 15];
    const float b = fminf(fminf(lo4[j], lo4[(j + 2) & 7]), fmaxf(a, e));
    const float k = fmaxf(fmaxf(hi4[j], hi4[(j + 2) & 7]), fminf(a, e));
    bright = j == 0 ? b : fmaxf(bright, b);
    dark = j == 0 ? k : fminf(dark, k);
  }
  return fmaxf(bright, -dark);
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
