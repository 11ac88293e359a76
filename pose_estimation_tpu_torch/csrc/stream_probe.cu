// Stream probe: each block reads one whole plane and keeps one small tile.
//
// Replaces the TPU kernel benchmarks/launch_overhead_exp.py:null_kernel, a
// probe of what a launch costs when every program streams a full plane on
// chip and does next to nothing with it: program g reads plane pp[g] of a
// [n_planes, h, w] float32 or bfloat16 stack and writes
// out[8 g : 8 g + 8, 0 : 128] = 2 * stack[pp[g], 0 : 8, 0 : 128] in float32.
// The output is exact. Sweeping the plane count, the plane height and the
// element type separates the fixed cost of a launch, the cost per block
// and the bytes over the memory rate.
//
// What bounds it on the H100: the bytes of the planes over the memory rate
// (1.5 MB per [480, 768] float32 plane against 4 KB written). The design:
// one block per program pulls its plane through registers as 16-byte
// words, four loads in flight per thread, and folds them into an XOR
// checksum. The checksum is stored only when the launch argument
// `keep_sums` is set, which the wrapper never does; the compiler cannot
// know that, so it cannot drop the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int TILE_ROWS = 8;
constexpr int TILE_COLS = 128;

__device__ __forceinline__ unsigned fold(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stream_probe_kernel(const T* __restrict__ stack, const int* __restrict__ pp,
                    float* __restrict__ out, unsigned* __restrict__ sums,
                    int h, int w, int keep_sums) {
  const int g = blockIdx.x;
  const T* plane = stack + (size_t)pp[g] * h * w;

  // ---- the whole plane through registers, 16 bytes a load
  const uint4* words = reinterpret_cast<const uint4*>(plane);
  const int n_words = (int)((size_t)h * w * sizeof(T) / sizeof(uint4));
  unsigned acc = 0;
  int i = threadIdx.x;
  for (; i + 3 * THREADS < n_words; i += 4 * THREADS) {
    uint4 a = words[i], b = words[i + THREADS];
    uint4 c = words[i + 2 * THREADS], d = words[i + 3 * THREADS];
    acc ^= fold(a) ^ fold(b) ^ fold(c) ^ fold(d);
  }
  for (; i < n_words; i += THREADS) acc ^= fold(words[i]);
  if (keep_sums) sums[(size_t)g * THREADS + threadIdx.x] = acc;

  // ---- the tile
  for (int j = threadIdx.x; j < TILE_ROWS * TILE_COLS; j += THREADS) {
    int r = j / TILE_COLS, c = j % TILE_COLS;
    out[((size_t)g * TILE_ROWS + r) * TILE_COLS + c] =
        2.0f * to_float<T>(plane[(size_t)r * w + c]);
  }
}

}  // namespace

// elem_size 4: float32 planes; 2: bfloat16 planes. A plane must be a whole
// number of 16-byte words.
extern "C" int stream_probe_launch(const void* stack, const int* pp, float* out,
                                   unsigned* sums, int n_progs, int h, int w,
                                   int elem_size, int keep_sums, void* stream) {
  if (n_progs <= 0 || h < TILE_ROWS || w < TILE_COLS) return (int)cudaErrorInvalidValue;
  if ((elem_size != 4 && elem_size != 2) || ((size_t)h * w * elem_size) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (keep_sums && sums == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 4)
    stream_probe_kernel<float><<<n_progs, THREADS, 0, s>>>(
        (const float*)stack, pp, out, sums, h, w, keep_sums);
  else
    stream_probe_kernel<__nv_bfloat16><<<n_progs, THREADS, 0, s>>>(
        (const __nv_bfloat16*)stack, pp, out, sums, h, w, keep_sums);
  return (int)cudaGetLastError();
}
