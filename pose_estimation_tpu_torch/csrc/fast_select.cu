// Fused FAST-9/16 score + 3x3 NMS + gates + per-cell top-k + subpixel fit.
//
// Replaces the TPU kernel pose_estimation_tpu/ops/pallas_fast.py:
// _select_kernel (launched by fast_select_pallas). Same output contract as
// the torch twin ops/fast.py:select_plain: for each plane and each 16x16
// cell, in raster order (cell-row, cell-col, k), the k-th best candidate's
// score, flat code y*W+x, and subpixel x, y. Invalid slots: score -1e9,
// code 0, x = y = 0. Every slot is written, including cells below a
// plane's content.
//
// What bounds it on the H100: the stencil arithmetic. Each pixel's score
// takes 16 ring differences and the max over 16 nine-long arc minima, for
// bright and dark, ~120 ALU operations per pixel with the gates against
// one 4-byte read, so the kernel is compute-bound, not bandwidth-bound (the
// [16, 480, 752] stack is 23 MB). The design keeps every intermediate on
// chip: one block stages a 16-row x 128-column tile (8 cells) plus a 4-px
// halo in shared memory, scores the tile plus a 1-px ring once, and
// selects with one warp per cell, so nothing but the 4 x 4 outputs per
// cell goes back to device memory.
//
// The score and NMS device code is shared with K3 (fast_common.cuh).
//
// Numerics equal the twin's: scores are exact (differences, min and max of
// the same float32 values); the subpixel fit uses the same operations in
// the same order with IEEE division (built without --use_fast_math).

#include <cuda_runtime.h>
#include <cstdint>

#include "fast_common.cuh"

namespace {

constexpr int CELL = 16;
constexpr int CPB = 8;                    // cells per block, horizontally
constexpr int TW = CELL * CPB;            // 128 tile columns
constexpr int HALO = fastk::HALO;         // FAST ring 3 + NMS 1
constexpr int LR = CELL + 2 * HALO;       // 24 staged rows
constexpr int LC = TW + 2 * HALO;         // 136 staged columns
constexpr int SR = CELL + 2;              // 18 score rows (tile + 1-px ring)
constexpr int SC = TW + 2;                // 130 score columns
constexpr int MAX_PLANES = 64;
constexpr int MAX_KPC = 8;
constexpr float NEG = -1e9f;

struct PlaneDims {
  int lh[MAX_PLANES];
  int lw[MAX_PLANES];
};

__device__ __forceinline__ float para(float sm, float s0, float sp) {
  // 1-D quadratic peak offset, clipped to half a pixel
  float den = __fadd_rn(__fsub_rn(sm, __fmul_rn(2.0f, s0)), sp);
  float off = fabsf(den) > 1e-6f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(sm, sp)), den) : 0.0f;
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

__global__ void __launch_bounds__(256)
fast_select_kernel(const float* __restrict__ stack, PlaneDims dims,
                   float* __restrict__ vals, int* __restrict__ codes,
                   float* __restrict__ xs, float* __restrict__ ys,
                   int h, int w, int n_cr, int ncx,
                   float th_hi, float th_lo, int border, int kpc) {
  __shared__ float tile[LR][LC];
  __shared__ float score[SR][SC];
  __shared__ float gated[CELL][TW];

  const int plane = blockIdx.z;
  const int cr = blockIdx.y;
  const int y0 = cr * CELL;
  const int x0 = blockIdx.x * TW;
  const int lh = dims.lh[plane];
  const int lw = dims.lw[plane];
  const float* img = stack + (size_t)plane * h * w;

  // ---- stage the tile + halo (edge-clamped; clamped pixels only reach
  // scores outside the detection border, which the gates drop)
  for (int i = threadIdx.x; i < LR * LC; i += blockDim.x) {
    int r = i / LC, c = i % LC;
    int gy = min(max(y0 - HALO + r, 0), h - 1);
    int gx = min(max(x0 - HALO + c, 0), w - 1);
    tile[r][c] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  // ---- FAST score on the tile plus a 1-px ring: score[r][c] is pixel
  // (y0 - 1 + r, x0 - 1 + c), i.e. tile[r + 3][c + 3]
  for (int i = threadIdx.x; i < SR * SC; i += blockDim.x) {
    int r = i / SC, c = i % SC;
    score[r][c] = fastk::score_at<LC>(&tile[r + 3][c + 3]);
  }
  __syncthreads();

  // ---- 3x3 NMS (raster tie-break: earlier neighbours must be strictly
  // lower, later ones lower or equal), positive score, detection border
  for (int i = threadIdx.x; i < CELL * TW; i += blockDim.x) {
    int r = i / TW, c = i % TW;
    int gy = y0 + r, gx = x0 + c;
    float s = score[r + 1][c + 1];
    bool keep = fastk::nms_keep(&score[0][0], SC, r + 1, c + 1);
    bool inb = gy >= border && gy < lh - border && gx >= border && gx < lw - border;
    gated[r][c] = (keep && s > 0.0f && inb) ? s : NEG;
  }
  __syncthreads();

  // ---- per-cell selection, one warp per cell
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cc = blockIdx.x * CPB + warp;
  if (warp >= CPB || cc >= ncx) return;
  const int cx0 = warp * CELL;             // cell's first tile column

  float cand[8];                           // pixel j = lane + 32 t, row-major
  float cmax = NEG;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    int j = lane + 32 * t;
    cand[t] = gated[j >> 4][cx0 + (j & 15)];
    cmax = fmaxf(cmax, cand[t]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
  const float thr = cmax > th_hi ? th_hi : th_lo;
#pragma unroll
  for (int t = 0; t < 8; ++t) cand[t] = cand[t] > thr ? cand[t] : NEG;

  const size_t base = (size_t)plane * n_cr * ncx * kpc + ((size_t)cr * ncx + cc) * kpc;
  for (int k = 0; k < kpc; ++k) {
    // best (highest score, then lowest in-cell raster index) in the warp
    float bv = NEG;
    int bi = 1 << 30;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      int j = lane + 32 * t;
      if (cand[t] > bv || (cand[t] == bv && j < bi)) { bv = cand[t]; bi = j; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    const bool valid = bv > 0.5f * NEG;
    if (valid && (bi & 31) == lane) cand[bi >> 5] = NEG;
    if (lane == 0) {
      if (valid) {
        int r = bi >> 4, c = cx0 + (bi & 15);
        int gy = y0 + r, gx = x0 + c;
        float s0 = score[r + 1][c + 1];
        float dx = para(score[r + 1][c], s0, score[r + 1][c + 2]);
        float dy = para(score[r][c + 1], s0, score[r + 2][c + 1]);
        vals[base + k] = bv;
        codes[base + k] = gy * w + gx;
        xs[base + k] = __fadd_rn((float)gx, dx);
        ys[base + k] = __fadd_rn((float)gy, dy);
      } else {
        vals[base + k] = NEG;
        codes[base + k] = 0;
        xs[base + k] = 0.0f;
        ys[base + k] = 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" int fast_select_launch(const float* stack, const int* lh, const int* lw,
                                  float* vals, int* codes, float* xs, float* ys,
                                  int n, int h, int w, int n_cr, int ncx,
                                  float th_hi, float th_lo, int border, int kpc,
                                  void* stream) {
  if (n <= 0 || n > MAX_PLANES || kpc <= 0 || kpc > MAX_KPC || w % CELL != 0)
    return (int)cudaErrorInvalidValue;
  PlaneDims dims;
  for (int i = 0; i < n; ++i) {
    dims.lh[i] = lh[i];
    dims.lw[i] = lw[i];
  }
  dim3 grid((ncx + CPB - 1) / CPB, n_cr, n);
  fast_select_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      stack, dims, vals, codes, xs, ys, h, w, n_cr, ncx, th_hi, th_lo, border, kpc);
  return (int)cudaGetLastError();
}
