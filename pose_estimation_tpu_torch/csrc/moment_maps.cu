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
// What bounds it on the H100: not its HBM traffic (4 bytes read and 8
// written a pixel, 0.0207 ms for a [16, 480, 752] stack at 3.35 TB/s) but
// its shared-memory traffic, 128 bytes a clock on each SM, and the latency
// of its staging. Forming each output pixel's 31 row windows from staged
// prefix sums takes 4 loads a window, 124 a pixel; this design forms each
// (staged row, radius) window once. One block of 128 threads owns a
// 130-row x 128-column tile, one thread a column of it, and streams the tile's 160 staged rows (the
// 15-row halo above and below included) through shared memory in 5 chunks
// of 32 rows. A chunk is staged with its 16-column halo (zero outside the
// canvas, the plane mean subtracted on the way in; 16 rows' loads in
// flight at once), each row turned into P and Q in place by one warp, and
// each thread then walks down the chunk: per staged row it loads the 20
// prefix values of its column's 10 radii from P and Q (40 loads), forms
// the 10 box and ramp windows in registers and adds them into the 31
// output rows that use the row, 38 rows x 2 moments of accumulators in
// registers (indices fixed at compile time), and the finished rows go to
// device memory. Per output pixel: 40 x 160 / 130 = 49.2 loads (196.9
// bytes), plus 16 bytes a staged pixel for the staging and the scans at
// 1.54 staged pixels a pixel (24.6 bytes): 221.5 bytes, 1.73 clocks of
// one SM, 0.038 ms for [16, 480, 752] at 1.98 GHz on 132 SMs, 1.8x the
// HBM bound. Shared memory is one chunk of P and Q, 40,960 bytes; <= 128
// registers a thread; 4 blocks fit an SM.
//
// Each output row's sum over dy = -15 .. 15 is taken in that order, as the
// twin and the first kernel take it; the scan adds each lane's 5 columns
// in order and then the lanes' totals in log steps.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int MR = 15;                 // circle radius
constexpr int NROW = 2 * MR + 1;       // 31 circle rows, the ring's length
constexpr int SROWS = 32;              // staged rows per chunk
constexpr int CHUNKS = 5;              // chunks per tile
constexpr int TH = SROWS * CHUNKS - 2 * MR;  // 130 output rows per block
constexpr int U = 8;                   // staged rows per step of the walk
constexpr int NACC = NROW - 1 + U;     // 38 output rows in flight
constexpr int TW = 128;                // output columns per block
constexpr int PADL = MR + 1;           // window reads x - r - 1 >= x0 - 16
constexpr int SW = TW + 2 * PADL;      // 160 staged columns = 5 warps wide
constexpr int CX = SW / 2;             // x-weights are centred on the tile
constexpr int THREADS = TW;            // one thread per output column
constexpr int NWIN = 10;               // distinct radii of the circle's rows

// half-width of the circle's row dy
__host__ __device__ constexpr int radius_of(int dy) {
  int r = MR;
  while (r * r + dy * dy > MR * MR) --r;
  return r;
}
// index of row |dy| = a's radius among the distinct radii, from a = 0
__host__ __device__ constexpr int window_of(int a) {
  int i = 0;
  for (int b = 1; b <= a; ++b) i += radius_of(b) != radius_of(b - 1);
  return i;
}
// radius of window i
__host__ __device__ constexpr int window_radius(int i) {
  int a = 0;
  while (window_of(a) != i) ++a;
  return radius_of(a);
}
static_assert(window_of(MR) == NWIN - 1, "10 distinct radii");

// f(Index<I>{}) for I = 0 .. N - 1: indices known to the compiler, so the
// ring and the windows stay in registers
template <int I>
struct Index {
  static constexpr int value = I;
};
template <typename F, int... I>
__device__ __forceinline__ void unroll(F&& f, std::integer_sequence<int, I...>) {
  (f(Index<I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll(f, std::make_integer_sequence<int, N>{});
}

__global__ void __launch_bounds__(THREADS, 4)
moment_maps_kernel(const float* __restrict__ stack, const float* __restrict__ mean,
                   float* __restrict__ m10, float* __restrict__ m01, int h, int w) {
  __shared__ float P[SROWS][SW];
  __shared__ float Q[SROWS][SW];

  const int plane = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t off = (size_t)plane * h * w;
  const float* img = stack + off;
  const float mu = mean[plane];
  const int tx = threadIdx.x;
  const int lane = tx & 31, warp = tx >> 5;
  const int gx = x0 + tx;
  const int c = tx + PADL;                // the thread's staged column
  const float xc = (float)(c - CX);
  // staged columns of this thread: tx, and 128 + tx for tx < 32
  const int sx0 = x0 - PADL + tx, sx1 = sx0 + TW;
  const bool in0 = sx0 >= 0 && sx0 < w, in1 = tx < SW - TW && sx1 >= 0 && sx1 < w;
  const int cx0 = min(max(sx0, 0), w - 1), cx1 = min(max(sx1, 0), w - 1);

  float a10[NACC], a01[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) a10[i] = a01[i] = 0.0f;

#pragma unroll 1
  for (int chunk = 0; chunk < CHUNKS; ++chunk) {
    const int t0 = chunk * SROWS;          // staged index t is image row y0 - 15 + t
    // ---- stage the zero-meaned chunk: P[r][col] is pixel (y0 - 15 + t0 + r,
    // x0 - 16 + col), exactly 0 outside the canvas. The loads of 16 rows
    // are issued before their stores, from addresses clamped to the plane.
    const int gyb = y0 - MR + t0;
#pragma unroll 1
    for (int rb = 0; rb < SROWS; rb += 16) {
      float v0[16], v1[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float* row = img + (size_t)min(max(gyb + rb + r, 0), h - 1) * w;
        v0[r] = row[cx0];
        v1[r] = tx < SW - TW ? row[cx1] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const bool row_in = gyb + rb + r >= 0 && gyb + rb + r < h;
        P[rb + r][tx] = row_in && in0 ? v0[r] - mu : 0.0f;
        if (tx < SW - TW) P[rb + r][TW + tx] = row_in && in1 ? v1[r] - mu : 0.0f;
      }
    }
    __syncthreads();

    // ---- row prefix sums in place, one warp per row: lane l sums columns
    // 5l .. 5l + 4 in order, the lanes' totals are scanned by shuffles, and
    // each lane adds the total of the lanes before it
#pragma unroll 2
    for (int r = warp; r < SROWS; r += THREADS / 32) {
      float p[SW / 32], q[SW / 32];
#pragma unroll
      for (int k = 0; k < SW / 32; ++k) {
        const int col = (SW / 32) * lane + k;
        const float v = P[r][col];
        const float vq = v * (float)(col - CX);
        p[k] = k ? p[k - 1] + v : v;
        q[k] = k ? q[k - 1] + vq : vq;
      }
      float tp = p[SW / 32 - 1], tq = q[SW / 32 - 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tp, o);
        const float uq = __shfl_up_sync(0xffffffffu, tq, o);
        if (lane >= o) {
          tp += up;
          tq += uq;
        }
      }
      float ep = __shfl_up_sync(0xffffffffu, tp, 1);
      float eq = __shfl_up_sync(0xffffffffu, tq, 1);
      if (lane == 0) ep = eq = 0.0f;
#pragma unroll
      for (int k = 0; k < SW / 32; ++k) {
        const int col = (SW / 32) * lane + k;
        P[r][col] = p[k] + ep;
        Q[r][col] = q[k] + eq;
      }
    }
    __syncthreads();

    // ---- walk down the chunk, U staged rows a step: each staged row's 10
    // windows, formed once, into the 31 output rows that use it. a?[m]
    // holds output row y0 - 30 + tg + m, tg the step's first staged index.
#pragma unroll 1
    for (int g = 0; g < SROWS; g += U) {
      const int tg = t0 + g;
      unroll<U>([&](auto uc) {
        constexpr int u = decltype(uc)::value;
        const float* prow = &P[g + u][c];
        const float* qrow = &Q[g + u][c];
        float box[NWIN], ramp[NWIN];
        unroll<NWIN>([&](auto ic) {
          constexpr int i = decltype(ic)::value;
          constexpr int r = window_radius(i);
          const float b = prow[r] - prow[-r - 1];
          box[i] = b;
          ramp[i] = (qrow[r] - qrow[-r - 1]) - xc * b;
        });
        // staged row tg + u is row dy of the circle of output row
        // y0 - 15 + tg + u - dy, held in a?[u + 15 - dy]
        unroll<NROW>([&](auto kc) {
          constexpr int dy = decltype(kc)::value - MR;
          constexpr int m = u + MR - dy;
          constexpr int i = window_of(dy < 0 ? -dy : dy);
          a10[m] += ramp[i];
          if constexpr (dy != 0) a01[m] += (float)dy * box[i];
        });
        // output row y0 - 30 + tg + u has all 31 rows now, in a?[u]
        const int t = tg + u;
        const int y = y0 - 2 * MR + t;
        if (t >= 2 * MR && y < h && gx < w) {
          const size_t o = off + (size_t)y * w + gx;
          m10[o] = a10[u];
          m01[o] = a01[u];
        }
      });
      // the step's U finished rows leave; the rows in flight move down
      unroll<NACC - U>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        a10[m] = a10[m + U];
        a01[m] = a01[m + U];
      });
      unroll<U>([&](auto mc) {
        constexpr int m = NACC - U + decltype(mc)::value;
        a10[m] = 0.0f;
        a01[m] = 0.0f;
      });
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int moment_maps_launch(const float* stack, const float* mean, float* m10,
                                  float* m01, int n, int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  moment_maps_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(stack, mean, m10, m01, h, w);
  return (int)cudaGetLastError();
}

// The design's shared-memory traffic for an [n, h, w] stack, in bytes: per
// block and staged row, 4 * NWIN four-byte prefix loads a column of the
// walk, and 16 bytes a staged pixel for the staging and the two scans.
extern "C" long long moment_maps_smem_bytes(int n, int h, int w) {
  const long long blocks = (long long)n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  return blocks * SROWS * CHUNKS * (TW * 4 * NWIN * 4 + SW * 16);
}
