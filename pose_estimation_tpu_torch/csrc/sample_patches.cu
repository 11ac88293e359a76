// Per-keypoint IC moments + rotated, blurred pool-point sampling.
//
// Replaces the TPU kernel pose_estimation_tpu/ops/pallas_sample.py:_kernel
// (launched by sample_patches_pallas). Same semantics as the torch twin
// ops/sample.py:sample_patches_plain: for keypoint t on plane canvas[p]:
//   * the 43x43 patch of the canvas padded by 2 px (reflect-101, zero past
//     that), origin clamped so the patch stays inside the padded canvas;
//   * m10, m01 over the radius-15 circle around the patch center;
//   * (ca, sa) = (m10, m01) / sqrt(max(m10^2 + m01^2, 1e-12));
//   * for each pool point (px, py): col = rint(px ca - py sa), row =
//     rint(px sa + py ca) (half to even), and the 7x7 separable Gaussian
//     (taps exp(-d^2/8)/norm, the blur folded into the sampling) of the raw
//     patch around (row, col). Full float32 accumulation.
//
// What bounds it on the H100: arithmetic per keypoint (256 points x 49
// taps) on a small gather (one 7.4 KB patch, read once from L2/HBM). One
// block per keypoint stages its patch in shared memory, reduces the two
// moments from per-row partial sums there, and gives each thread one pool
// point, so only the 258 outputs per keypoint are written.
//
// The rotation is computed with explicit round-to-nearest multiplies and
// adds (no FMA contraction) and IEEE sqrt/division, so the rounded sample
// offsets equal the twin's; built without --use_fast_math.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int PATCH_R = 15;
constexpr int REACH = 21;
constexpr int PS = 2 * REACH + 1;    // 43
constexpr int PAD = 2;

struct Taps {
  float k[7];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(256)
sample_patches_kernel(const float* __restrict__ canvas, const int* __restrict__ plane,
                      const float* __restrict__ xy, const float* __restrict__ pool_xy,
                      Taps taps, float* __restrict__ vals, float* __restrict__ m10_out,
                      float* __restrict__ m01_out, int n_pool, int h, int w) {
  __shared__ float patch[PS][PS + 1];
  __shared__ float row10[PS];
  __shared__ float row01[PS];
  __shared__ float mom[2];

  const int t = blockIdx.x;
  const float* img = canvas + (size_t)plane[t] * h * w;
  const int cx = (int)rintf(xy[2 * t]);
  const int cy = (int)rintf(xy[2 * t + 1]);
  const int hp = h + 2 * PAD, wp = w + 2 * PAD;
  const int y0 = min(max(cy + PAD - REACH, 0), max(hp - PS, 0));
  const int x0 = min(max(cx + PAD - REACH, 0), max(wp - PS, 0));

  for (int i = threadIdx.x; i < PS * PS; i += blockDim.x) {
    int r = i / PS, c = i % PS;
    int Y = y0 + r, X = x0 + c;     // padded-canvas coordinates
    float v = 0.0f;
    if (Y < hp && X < wp)
      v = img[(size_t)reflect101(Y - PAD, h) * w + reflect101(X - PAD, w)];
    patch[r][c] = v;
  }
  __syncthreads();

  // per-row moment sums over the circle, then the sum over rows
  if (threadIdx.x < PS) {
    const int r = threadIdx.x;
    const int dy = r - REACH;
    float s10 = 0.0f, s01 = 0.0f;
    for (int c = 0; c < PS; ++c) {
      int dx = c - REACH;
      if (dx * dx + dy * dy <= PATCH_R * PATCH_R) {
        s10 += patch[r][c] * (float)dx;
        s01 += patch[r][c] * (float)dy;
      }
    }
    row10[r] = s10;
    row01[r] = s01;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < PS; ++r) {
      a += row10[r];
      b += row01[r];
    }
    mom[0] = a;
    mom[1] = b;
    m10_out[t] = a;
    m01_out[t] = b;
  }
  __syncthreads();

  const float m10 = mom[0], m01 = mom[1];
  const float r2 = __fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(r2, 1e-12f)));
  const float ca = __fmul_rn(m10, inv);
  const float sa = __fmul_rn(m01, inv);

  for (int p = threadIdx.x; p < n_pool; p += blockDim.x) {
    const float px = pool_xy[2 * p], py = pool_xy[2 * p + 1];
    float fc = rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
    float fr = rintf(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
    const int col = (int)fminf(fmaxf(fc, -18.0f), 18.0f) + REACH;
    const int row = (int)fminf(fmaxf(fr, -18.0f), 18.0f) + REACH;
    float acc = 0.0f;
#pragma unroll
    for (int dc = 0; dc < 7; ++dc) {
      float t1 = 0.0f;
#pragma unroll
      for (int dr = 0; dr < 7; ++dr) t1 += patch[row - 3 + dr][col - 3 + dc] * taps.k[dr];
      acc += t1 * taps.k[dc];
    }
    vals[(size_t)t * n_pool + p] = acc;
  }
}

}  // namespace

extern "C" int sample_patches_launch(const float* canvas, const int* plane, const float* xy,
                                     const float* pool_xy, const float* taps_host,
                                     float* vals, float* m10, float* m01, int k, int n_pool,
                                     int n_planes, int h, int w, void* stream) {
  if (k <= 0 || n_pool <= 0 || n_planes <= 0 || h < 3 || w < 3)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 7; ++i) taps.k[i] = taps_host[i];
  sample_patches_kernel<<<k, 256, 0, (cudaStream_t)stream>>>(
      canvas, plane, xy, pool_xy, taps, vals, m10, m01, n_pool, h, w);
  return (int)cudaGetLastError();
}
