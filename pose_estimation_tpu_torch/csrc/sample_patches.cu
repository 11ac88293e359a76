// Per-keypoint IC moments + rotated, blurred pool-point sampling, one launch
// over every pyramid level of every image.
//
// Replaces the TPU kernel pose_estimation_tpu/ops/pallas_sample.py:_kernel
// (launched by sample_patches_pallas once per level). Same semantics as the
// torch twin ops/sample.py:sample_stack_plain, which runs the per-level twin
// sample_patches_plain on each plane's content:
//   * the keypoints are the [B, K_tot] slots of ORB extraction, level-major
//     within an image (level l owns slots off[l] .. off[l+1] - 1); slot t =
//     image * K_tot + k lies on plane level * B + image of the zero-padded,
//     level-major plane stack [n_levels * B, H, W], whose content is
//     lh[level] x lw[level] (every image of a level has one size, so the
//     table passed by value has a row per level and B is not bounded by
//     it: a batch of 64 stereo pairs, 1,024 planes, is one launch);
//   * the 43x43 patch of that content padded by 2 px (reflect-101 at the
//     content edge, zero past that), origin clamped so the patch stays
//     inside the padded content;
//   * m10, m01 over the radius-15 circle around the patch center;
//   * (ca, sa) = (m10, m01) / sqrt(max(m10^2 + m01^2, 1e-12));
//   * for each pool point (px, py): col = rint(px ca - py sa), row =
//     rint(px sa + py ca) (half to even), and the 7x7 separable Gaussian
//     (taps exp(-d^2/8)/norm, the blur folded into the sampling) of the raw
//     patch around (row, col). Full float32 accumulation.
// The output is the packed [B, K_tot, P + 2] layout that ORB extraction
// consumes: the P samples, then m10 and m01.
//
// What bounds it on the H100: neither bytes nor arithmetic at this size (a
// 7.4 KB patch gathered from L2 and ~25k multiply-adds per keypoint, ~1,600
// keypoints a stereo pair: bounds of a few microseconds) but the latency
// of one block and the host cost of a launch. So one launch covers all
// levels (a launch per level would be 8 with host work around each, each
// less than one wave of blocks), and the block's serial phases are short:
// a warp stages whole patch rows with the reflected row and column indices
// computed once, the moments are summed while staging by all threads and
// reduced by warp shuffles and one cross-warp step, and each thread then
// samples one pool point.
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
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 16;

struct Taps {
  float k[7];
};

struct Tables {
  int off[MAX_LEVELS + 1];   // first slot of each level within an image
  int lh[MAX_LEVELS];        // content size of each level's planes
  int lw[MAX_LEVELS];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(THREADS)
sample_patches_kernel(const float* __restrict__ stack, const float* __restrict__ xy,
                      const float* __restrict__ pool_xy, Taps taps, Tables tab,
                      float* __restrict__ out, int b, int k_tot, int n_levels,
                      int h, int w, int n_pool) {
  __shared__ float patch[PS][PS + 1];
  __shared__ float part[2][WARPS];

  const int t = blockIdx.x;
  const int image = t / k_tot;
  const int k = t - image * k_tot;
  int level = 0;
  while (level + 1 < n_levels && k >= tab.off[level + 1]) ++level;
  const int plane = level * b + image;
  const int lh = tab.lh[level], lw = tab.lw[level];
  const float* img = stack + (size_t)plane * h * w;

  const int cx = (int)rintf(xy[2 * t]);
  const int cy = (int)rintf(xy[2 * t + 1]);
  const int hp = lh + 2 * PAD, wp = lw + 2 * PAD;
  const int y0 = min(max(cy + PAD - REACH, 0), max(hp - PS, 0));
  const int x0 = min(max(cx + PAD - REACH, 0), max(wp - PS, 0));

  // ---- stage the patch: warp `warp` takes rows warp, warp + 8, ...; lane
  // `lane` takes columns lane and lane + 32 (< 43). Content column of each,
  // or -1 past the padded content (zero fill).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c1 = lane + 32;
  const int col0 = x0 + lane < wp ? reflect101(x0 + lane - PAD, lw) : -1;
  const int col1 = (c1 < PS && x0 + c1 < wp) ? reflect101(x0 + c1 - PAD, lw) : -1;
  const int dx0 = lane - REACH, dx1 = c1 - REACH;
  float s10 = 0.0f, s01 = 0.0f;
  for (int r = warp; r < PS; r += WARPS) {
    const int Y = y0 + r;
    const float* row = img + (size_t)(Y < hp ? reflect101(Y - PAD, lh) : 0) * w;
    const bool in_rows = Y < hp;
    const int dy = r - REACH;
    const float v0 = (in_rows && col0 >= 0) ? row[col0] : 0.0f;
    patch[r][lane] = v0;
    if (dx0 * dx0 + dy * dy <= PATCH_R * PATCH_R) {
      s10 += v0 * (float)dx0;
      s01 += v0 * (float)dy;
    }
    if (c1 < PS) {
      const float v1 = (in_rows && col1 >= 0) ? row[col1] : 0.0f;
      patch[r][c1] = v1;
      if (dx1 * dx1 + dy * dy <= PATCH_R * PATCH_R) {
        s10 += v1 * (float)dx1;
        s01 += v1 * (float)dy;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s10 += __shfl_xor_sync(0xffffffffu, s10, o);
    s01 += __shfl_xor_sync(0xffffffffu, s01, o);
  }
  if (lane == 0) {
    part[0][warp] = s10;
    part[1][warp] = s01;
  }
  __syncthreads();

  // every thread sums the warps' partials in the same order
  float m10 = 0.0f, m01 = 0.0f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    m10 += part[0][i];
    m01 += part[1][i];
  }
  float* dst = out + (size_t)t * (n_pool + 2);
  if (threadIdx.x == 0) {
    dst[n_pool] = m10;
    dst[n_pool + 1] = m01;
  }

  const float r2 = __fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(r2, 1e-12f)));
  const float ca = __fmul_rn(m10, inv);
  const float sa = __fmul_rn(m01, inv);

  for (int p = threadIdx.x; p < n_pool; p += THREADS) {
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
    dst[p] = acc;
  }
}

}  // namespace

// stack [n_levels * b, h, w]; xy [b * k_tot, 2]; pool_xy [n_pool, 2];
// out [b * k_tot, n_pool + 2]. Host arrays: taps [7], and the table of
// level offsets off [n_levels + 1] (off[n_levels] == k_tot) followed by the
// planes' content heights lh and widths lw [n_levels * b each], which must
// agree within each level (the kernel keeps one row per level).
extern "C" int sample_patches_launch(const float* stack, const float* xy,
                                     const float* pool_xy, const float* taps_host,
                                     const int* table, float* out, int b, int k_tot,
                                     int n_levels, int h, int w, int n_pool, void* stream) {
  const int n_planes = n_levels * b;
  if (b <= 0 || k_tot <= 0 || n_pool <= 0 || n_levels <= 0 || n_levels > MAX_LEVELS ||
      (long long)b * k_tot > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int* off = table;
  const int* lh = table + n_levels + 1;
  const int* lw = lh + n_planes;
  if (off[0] != 0 || off[n_levels] != k_tot) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 7; ++i) taps.k[i] = taps_host[i];
  Tables tab;
  for (int i = 0; i <= n_levels; ++i) tab.off[i] = off[i];
  for (int l = 0; l < n_levels; ++l) {
    tab.lh[l] = lh[l * b];
    tab.lw[l] = lw[l * b];
    if (tab.lh[l] < 3 || tab.lw[l] < 3 || tab.lh[l] > h || tab.lw[l] > w)
      return (int)cudaErrorInvalidValue;
    for (int i = 1; i < b; ++i)
      if (lh[l * b + i] != tab.lh[l] || lw[l * b + i] != tab.lw[l])
        return (int)cudaErrorInvalidValue;
  }
  sample_patches_kernel<<<b * k_tot, THREADS, 0, (cudaStream_t)stream>>>(
      stack, xy, pool_xy, taps, tab, out, b, k_tot, n_levels, h, w, n_pool);
  return (int)cudaGetLastError();
}
