// Fused FAST-9/16 score + 3x3 NMS + gates + per-cell top-k + subpixel fit.
//
// Replaces the TPU kernel pose_estimation_tpu/ops/pallas_fast.py:
// _select_kernel (launched by fast_select_pallas). Same output contract as
// the torch twin ops/fast.py:select_plain: for each plane and each 16x16
// cell, in raster order (cell-row, cell-col, k), the k-th best candidate's
// score, flat code y*W+x, and subpixel x, y. Invalid slots: score -1e9,
// code 0, x = y = 0. Every slot is written, including cells below and to
// the right of a plane's content.
//
// What bounds it on the H100: the stencil arithmetic. Each pixel's score
// takes 16 ring differences and 95 min/max in the shared-arc form of
// fast_common.cuh, with the NMS, gates and selection ~127 float32
// instructions against one 4-byte read, and min and max issue at half the
// rate of adds. Only the planes' content can hold a keypoint, so the work
// the function needs is the content's pixels, not the zero-padded canvas.
//
// The design does work only where a cell can pass the gates. A level-major
// stack is padded to level-0 size, so most of an upper level's canvas is
// padding. The wrapper hands the kernel a plan (ops/fast.py:select_plan):
// for each plane the rectangle of 32-row x 128-column blocks that hold a
// pixel with border <= y < lh - border and border <= x < lw - border. The
// planes come in classes of equal content size, `per` consecutive planes
// each (a level of a stack of `per` images: one plan row per level,
// ops/fast.py:plane_classes), so the plan is one row per class and the
// grid's y index is the plane within its class: a stack of any number of
// images is one launch. Along x the grid is one fill block per class,
// which writes the invalid slots of the plane's cells outside its
// rectangle, then one work block per block of the classes' rectangles:
// (8 + 283) x 2 blocks at EuRoC width ([16, 480, 752], 8 levels of a
// stereo pair) where a uniform grid of 32-row blocks has 1,440, (8 + 283)
// x 16 for a batch of 8 pairs, and (4 + 51) x 2 where the uniform grid has
// 192 in the 320x240, 4-level protocol stack. A work
// block stages its 32-row x 128-column tile (two cell rows, the TPU
// kernel's band) plus a 4-px halo in shared memory, scores the tile plus a
// 1-px ring with one thread per column walking down half the rows (no
// integer division in any loop, every ring offset an immediate), gates it,
// and selects with one warp per cell, so nothing but the 4 x 4 outputs per
// cell goes back to device memory. The other way to skip the padding, the
// uniform grid of 1,440 blocks in which a block with no pixel inside the
// border writes its invalid slots and returns, took 10 % more device time
// at EuRoC width and 26 % more in the protocol stack (PERF.md, PR 5).
//
// The score and NMS device code is shared with K3 (fast_common.cuh).
//
// Numerics equal the twin's: scores are exact (differences, min and max of
// the same float32 values); the subpixel fit uses the same operations in
// the same order with IEEE division (built without --use_fast_math).

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

constexpr int CELL = 16;
constexpr int CPB = 8;                    // cells per block, horizontally
constexpr int TH = 2 * CELL;              // 32 tile rows (two cell rows)
constexpr int TW = CELL * CPB;            // 128 tile columns
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / TW;      // 2 row groups of 128 threads
constexpr int HALO = fastk::HALO;         // FAST ring 3 + NMS 1
constexpr int LR = TH + 2 * HALO;         // 40 staged rows
constexpr int LC = TW + 2 * HALO;         // 136 staged columns
constexpr int SR = TH + 2;                // 34 score rows (tile + 1-px ring)
constexpr int SC = TW + 2;                // 130 score columns
constexpr int MAX_CLASSES = 64;
constexpr int MAX_PER = 65535;            // the grid's y limit
constexpr int MAX_KPC = 8;
constexpr float NEG = -1e9f;
static_assert(SR % GROUPS == 0 && TH % GROUPS == 0, "row groups split the tile evenly");
static_assert(TH * TW <= LR * LC, "the gated tile fits in the staged tile's space");

// The launch plan, passed by value: each plane class's content size and
// the rectangle of work blocks [band0, band0 + bands) x [tile0, tile0 +
// tiles), and the first work block of each class (then the total).
struct Plan {
  int lh[MAX_CLASSES];
  int lw[MAX_CLASSES];
  int band0[MAX_CLASSES];
  int bands[MAX_CLASSES];
  int tile0[MAX_CLASSES];
  int tiles[MAX_CLASSES];
  int first[MAX_CLASSES + 1];
};

__device__ __forceinline__ float para(float sm, float s0, float sp) {
  // 1-D quadratic peak offset, clipped to half a pixel
  float den = __fadd_rn(__fsub_rn(sm, __fmul_rn(2.0f, s0)), sp);
  float off = fabsf(den) > 1e-6f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(sm, sp)), den) : 0.0f;
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

// A fill block: the invalid slots of plane `plane` (of class `cls`) in the
// cells outside its work rectangle, one cell row at a time, the row's
// slots contiguous in memory.
__device__ void fill_invalid(const Plan& plan, int cls, int plane, float* vals, int* codes,
                             float* xs, float* ys, int n_cr, int ncx, int kpc) {
  const int cr0 = 2 * plan.band0[cls], cr1 = cr0 + 2 * plan.bands[cls];
  const int s0 = CPB * plan.tile0[cls] * kpc;
  const int s1 = min(CPB * (plan.tile0[cls] + plan.tiles[cls]), ncx) * kpc;
  const int row_slots = ncx * kpc;
  size_t base = (size_t)plane * n_cr * row_slots;
  for (int cr = 0; cr < n_cr; ++cr, base += row_slots) {
    const bool whole = cr < cr0 || cr >= cr1;
    for (int i = threadIdx.x; i < row_slots; i += THREADS) {
      if (whole || i < s0 || i >= s1) {
        vals[base + i] = NEG;
        codes[base + i] = 0;
        xs[base + i] = 0.0f;
        ys[base + i] = 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fast_select_kernel(const float* __restrict__ stack, const __grid_constant__ Plan plan,
                   float* __restrict__ vals, int* __restrict__ codes,
                   float* __restrict__ xs, float* __restrict__ ys,
                   int n_cls, int h, int w, int n_cr, int ncx,
                   float th_hi, float th_lo, int border, int kpc) {
  __shared__ float tile[LR][LC];          // the staged tile, then the gated scores
  __shared__ float score[SR][SC];

  const int per = gridDim.y;
  if ((int)blockIdx.x < n_cls) {
    fill_invalid(plan, blockIdx.x, blockIdx.x * per + blockIdx.y, vals, codes, xs, ys,
                 n_cr, ncx, kpc);
    return;
  }
  // ---- which work block: the class by the plan's prefix, then its place
  // in the class's rectangle (one division a block); the plane is the
  // grid's y index within the class
  const int g = blockIdx.x - n_cls;
  int cls = 0;
  while (g >= plan.first[cls + 1]) ++cls;
  const int plane = cls * per + blockIdx.y;
  const int j = g - plan.first[cls];
  const int bi = j / plan.tiles[cls];
  const int band = plan.band0[cls] + bi;
  const int tcol = plan.tile0[cls] + (j - bi * plan.tiles[cls]);
  const int y0 = band * TH;
  const int x0 = tcol * TW;
  const int lh = plan.lh[cls];
  const int lw = plan.lw[cls];
  const float* img = stack + (size_t)plane * h * w;

  const int tx = threadIdx.x % TW;        // column within the tile
  const int ty = threadIdx.x / TW;        // row group

  // ---- stage the tile + halo, rows and columns edge-clamped (clamped
  // pixels only reach scores outside the detection border, which the gates
  // drop). Thread tx stages tile column tx and, for tx < 8, column 128 + tx,
  // in its group's 20 rows, all loads issued before the stores.
  {
    const int gx0 = min(max(x0 - HALO + tx, 0), w - 1);
    const int gx1 = min(max(x0 - HALO + TW + tx, 0), w - 1);
    float v0[LR / GROUPS], v1[LR / GROUPS];
#pragma unroll
    for (int i = 0; i < LR / GROUPS; ++i) {
      const float* row = img + (size_t)min(max(y0 - HALO + ty + GROUPS * i, 0), h - 1) * w;
      v0[i] = row[gx0];
      if (tx < 2 * HALO) v1[i] = row[gx1];
    }
#pragma unroll
    for (int i = 0; i < LR / GROUPS; ++i) {
      tile[ty + GROUPS * i][tx] = v0[i];
      if (tx < 2 * HALO) tile[ty + GROUPS * i][TW + tx] = v1[i];
    }
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

  // ---- 3x3 NMS (raster tie-break: earlier neighbours must be strictly
  // lower, later ones lower or equal), positive score, detection border;
  // the gated scores overwrite the staged tile, [TH][TW] row-major
  float* gated = &tile[0][0];
  {
    const int gx = x0 + tx;
    const bool inx = gx >= border && gx < lw - border;
#pragma unroll 4
    for (int i = 0; i < TH / GROUPS; ++i) {
      const int r = ty * (TH / GROUPS) + i;
      const int gy = y0 + r;
      const float s = score[r + 1][tx + 1];
      const bool keep = fastk::nms_keep(&score[0][0], SC, r + 1, tx + 1);
      const bool inb = inx && gy >= border && gy < lh - border;
      gated[r * TW + tx] = (keep && s > 0.0f && inb) ? s : NEG;
    }
  }
  __syncthreads();

  // ---- per-cell selection, one warp per cell column, both cell rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cc = tcol * CPB + warp;
  if (cc >= ncx) return;
  const int cx0 = warp * CELL;             // cell's first tile column

  for (int half = 0; half < 2; ++half) {
    const int cy0 = half * CELL;           // cell's first tile row
    const int cr = 2 * band + half;
    float cand[8];                         // pixel j = lane + 32 t, row-major
    float cmax = NEG;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int jj = lane + 32 * t;
      cand[t] = gated[(cy0 + (jj >> 4)) * TW + cx0 + (jj & 15)];
      cmax = fmaxf(cmax, cand[t]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    const float thr = cmax > th_hi ? th_hi : th_lo;
#pragma unroll
    for (int t = 0; t < 8; ++t) cand[t] = cand[t] > thr ? cand[t] : NEG;

    const size_t base = ((size_t)plane * n_cr + cr) * ncx * kpc + (size_t)cc * kpc;
    for (int k = 0; k < kpc; ++k) {
      // best (highest score, then lowest in-cell raster index) in the warp
      float bv = NEG;
      int bi2 = 1 << 30;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int jj = lane + 32 * t;
        if (cand[t] > bv || (cand[t] == bv && jj < bi2)) { bv = cand[t]; bi2 = jj; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi2, o);
        if (ov > bv || (ov == bv && oi < bi2)) { bv = ov; bi2 = oi; }
      }
      const bool valid = bv > 0.5f * NEG;
      if (valid && (bi2 & 31) == lane) cand[bi2 >> 5] = NEG;
      if (lane == 0) {
        if (valid) {
          const int r = cy0 + (bi2 >> 4), c = cx0 + (bi2 & 15);
          const int gy = y0 + r, gx = x0 + c;
          const float s0 = score[r + 1][c + 1];
          const float dx = para(score[r + 1][c], s0, score[r + 1][c + 2]);
          const float dy = para(score[r][c + 1], s0, score[r + 2][c + 1]);
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
}

}  // namespace

// table: int32 [7 * n_cls + 1], the plan's rows lh, lw, band0, bands,
// tile0, tiles (n_cls each), then first (n_cls + 1), as
// ops/fast.py:select_plan lays them for the classes' content sizes. The
// stack holds n_cls * per planes, class c being planes c * per .. c * per
// + per - 1. band_rows and tile_cols are the block size the plan was made
// for (ops/fast.py: BAND, TILE_W), held to the kernel's.
extern "C" int fast_select_launch(const float* stack, const int* table,
                                  float* vals, int* codes, float* xs, float* ys,
                                  int n_cls, int per, int h, int w, int n_cr, int ncx,
                                  float th_hi, float th_lo, int border, int kpc,
                                  int band_rows, int tile_cols, void* stream) {
  if (n_cls <= 0 || n_cls > MAX_CLASSES || per <= 0 || per > MAX_PER || kpc <= 0 ||
      kpc > MAX_KPC || w % CELL != 0 || band_rows != TH || tile_cols != TW ||
      n_cr != 2 * ((h + TH - 1) / TH) || ncx != w / CELL)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  for (int i = 0; i < n_cls; ++i) {
    plan.lh[i] = table[i];
    plan.lw[i] = table[n_cls + i];
    plan.band0[i] = table[2 * n_cls + i];
    plan.bands[i] = table[3 * n_cls + i];
    plan.tile0[i] = table[4 * n_cls + i];
    plan.tiles[i] = table[5 * n_cls + i];
  }
  for (int i = 0; i <= n_cls; ++i) plan.first[i] = table[6 * n_cls + i];
  const int n_work = plan.first[n_cls];
  const dim3 grid(n_cls + n_work, per);
  fast_select_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      stack, plan, vals, codes, xs, ys, n_cls, h, w, n_cr, ncx, th_hi, th_lo, border, kpc);
  return (int)cudaGetLastError();
}
