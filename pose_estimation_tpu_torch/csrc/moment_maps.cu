// Circular (radius 15) first moments m10, m01 at every pixel of a plane stack.
//
// Replaces the TPU kernel pose_estimation_tpu/ops/pallas_fast.py:
// _moments_kernel (launched by moment_maps_pallas), the full-image moment
// maps of the map-based ORB front end (OrbConfig.moments_backend="pallas").
// Same output contract as the torch twin ops/moments.py:moment_maps_plain
// (the port of orb.moment_maps_integral): with J = stack - mean[plane] on
// the canvas and exactly 0 beyond it,
//   m10[y][x] = sum over the circle of dx * J[y + dy][x + dx]
//   m01[y][x] = sum over the circle of dy * J[y + dy][x + dx]
// where row dy of the circle spans |dx| <= r(dy) = floor(sqrt(225 - dy^2)).
// Both [N, H, W] float32, every pixel written, the 15-px border included.
//
// The sums are taken as the TPU kernel takes them, from row prefix sums:
//   box(x; r)  = P[x + r] - P[x - r - 1],            P = cumsum(J)
//   ramp(x; r) = (Q[x + r] - Q[x - r - 1]) - (x - c) * box(x; r),
//                                                    Q = cumsum((x - c) * J)
//   m10 = sum_dy ramp(.; r(dy)) of row y + dy,  m01 = sum_dy dy * box(...)
// but the prefix sums run over the block's staged tile only (160 columns,
// c = the tile's centre), not over the whole row. The identity holds for
// any start and any c, and the short sums stay below ~1e6 where the
// whole-row sums of a 1242-px row reach ~1e7, so the windowed differences
// cancel less: the kernel is closer to the exact moments than the twin.
//
// What bounds it on the H100: 4 bytes read and 8 written per pixel against
// ~95 float32 instructions per pixel in this form, so memory traffic bounds
// it (69 MB for a [16, 480, 752] stack). The design: one block per (plane,
// 32-row band, 128-column tile) stages the band plus 15 rows above and
// below and 16 columns left and right in shared memory (zero outside the
// canvas, the plane mean subtracted on the way in), one warp per row turns
// it into P and Q in place by shuffle scans, and each thread then
// accumulates the 31 rows of its output pixels from 4 shared-memory reads
// per row. Nothing but the two maps goes back to device memory. A simple
// kernel: the (row, radius) windows are recomputed for every output row
// that uses them.

#include <cuda_runtime.h>

namespace {

constexpr int MR = 15;                 // circle radius
constexpr int TH = 32;                 // output rows per block
constexpr int TW = 128;                // output columns per block
constexpr int PADL = MR + 1;           // window reads x - r - 1 >= x0 - 16
constexpr int SR = TH + 2 * MR;        // 62 staged rows
constexpr int SW = TW + 2 * PADL;      // 160 staged columns = 5 warps wide
constexpr int CX = SW / 2;             // x-weights are centred on the tile
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = 2 * (size_t)SR * SW * sizeof(float);

// half-width of the circle's row dy, indexed by dy + 15
__constant__ int kRad[2 * MR + 1] = {0,  5,  7,  9,  10, 11, 12, 12, 13, 13, 14,
                                     14, 14, 14, 14, 15, 14, 14, 14, 14, 14, 13,
                                     13, 12, 12, 11, 10, 9,  7,  5,  0};

__global__ void __launch_bounds__(THREADS)
moment_maps_kernel(const float* __restrict__ stack, const float* __restrict__ mean,
                   float* __restrict__ m10, float* __restrict__ m01, int h, int w) {
  extern __shared__ float smem[];
  float (*P)[SW] = reinterpret_cast<float (*)[SW]>(smem);
  float (*Q)[SW] = reinterpret_cast<float (*)[SW]>(smem + SR * SW);

  const int plane = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t off = (size_t)plane * h * w;
  const float* img = stack + off;
  const float mu = mean[plane];

  // ---- stage the zero-meaned tile: P[r][c] is pixel (y0 - 15 + r,
  // x0 - 16 + c), exactly 0 outside the canvas
  for (int i = threadIdx.x; i < SR * SW; i += THREADS) {
    int r = i / SW, c = i % SW;
    int gy = y0 - MR + r, gx = x0 - PADL + c;
    bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    P[r][c] = in ? img[(size_t)gy * w + gx] - mu : 0.0f;
  }
  __syncthreads();

  // ---- row prefix sums in place, one warp per row, 32 columns at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < SR; r += THREADS / 32) {
    float carry_p = 0.0f, carry_q = 0.0f;
    for (int c0 = 0; c0 < SW; c0 += 32) {
      int c = c0 + lane;
      float p = P[r][c];
      float q = p * (float)(c - CX);
      for (int o = 1; o < 32; o <<= 1) {
        float tp = __shfl_up_sync(0xffffffffu, p, o);
        float tq = __shfl_up_sync(0xffffffffu, q, o);
        if (lane >= o) {
          p += tp;
          q += tq;
        }
      }
      p += carry_p;
      q += carry_q;
      P[r][c] = p;
      Q[r][c] = q;
      carry_p = __shfl_sync(0xffffffffu, p, 31);
      carry_q = __shfl_sync(0xffffffffu, q, 31);
    }
  }
  __syncthreads();

  // ---- the 31-row accumulation, one output pixel at a time
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    int ty = i / TW, tx = i % TW;
    int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    int c = tx + PADL;
    float xc = (float)(c - CX);
    float a10 = 0.0f, a01 = 0.0f;
#pragma unroll
    for (int k = 0; k <= 2 * MR; ++k) {
      int r = kRad[k];
      const float* prow = P[ty + k];
      const float* qrow = Q[ty + k];
      float box = prow[c + r] - prow[c - r - 1];
      float ramp = (qrow[c + r] - qrow[c - r - 1]) - xc * box;
      a10 += ramp;
      a01 += (float)(k - MR) * box;
    }
    size_t o = off + (size_t)gy * w + gx;
    m10[o] = a10;
    m01[o] = a01;
  }
}

}  // namespace

extern "C" int moment_maps_launch(const float* stack, const float* mean, float* m10,
                                  float* m01, int n, int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      moment_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  moment_maps_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      stack, mean, m10, m01, h, w);
  return (int)cudaGetLastError();
}
