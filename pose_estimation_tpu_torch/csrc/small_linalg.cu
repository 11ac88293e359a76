// K6: batched Jacobi eigendecomposition of small symmetric matrices, and
// the SVD of 3x3 matrices.
//
// K6 replaces no pallas_call of the JAX package. It is the counterpart of
// the device-side jnp.linalg.eigh and jnp.linalg.svd inside the JAX
// package's jitted programs (pose_estimation_tpu/ops/pnp.py: the DLT's and
// EPnP's null spaces, EPnP's principal axes, the proper rotations of DLT
// and Procrustes; the float64 PSD clip of the marginalization prior, a
// deviation of the port, backend/ba.py:psd_clip). torch.linalg.eigh and
// torch.linalg.svd check their results on the host, so a CUDA graph cannot
// capture them; these kernels read nothing back and return NaN for NaN.
//
// Output contract, shared with the torch twins of ops/small_linalg.py:
//   eigh: the lower triangle of each [n, n] matrix (n <= 64, float32 or
//   float64) is read; eigenvalues ascending, eigenvectors as columns, each
//   column's component of largest magnitude positive (the first such
//   index on ties). A matrix holding a NaN gives NaN throughout.
//   svd3: each float32 [3, 3] matrix A = U diag(S) V^T with S descending;
//   V's columns are canonical as above; U's columns are u1 = A v1 / |A v1|,
//   u2 = A v2 made orthogonal to u1 and normalised, u3 = +-(u1 x u2) with
//   the sign of (u1 x u2) . A v3. So U is a rotation or a reflection for
//   every A, rank 2 and rank 1 included, and U diag(1, 1, det(U V^T)) V^T
//   is a rotation.
//
// What bounds it on the H100: neither bytes nor operations. The largest
// call, the clip of one [45, 45] float64 matrix, moves 32 KB and needs
// ~10 sweeps x 45 rounds x 3 x 23 x 45 rotations of 4 multiply-adds,
// ~3e6 float64 operations: microseconds of the card at its peak. A
// Jacobi sweep is a chain of dependent rounds, each a few hundred
// operations wide, so a matrix is latency bound: its time is the number of
// rounds times the latency of a round (three barrier-separated passes
// through shared memory). One block a matrix keeps the whole chain on one
// SM with the matrix and its eigenvector accumulator in shared memory (a
// [45, 45] float64 pair with padded rows is 33 KB; n = 64 in float64
// needs 67 KB, dynamic shared memory above the default 48 KB), so no
// round touches device memory and a batch runs its matrices side by side
// on the 132 SMs. A block has a thread for each (pair, row) update of a
// pass (1024 at most: one or two updates a thread for n = 45), so a pass
// is one shared-memory round trip deep. A 3x3 SVD is 9 values: one thread
// a matrix, in registers.
//
// Method: cyclic two-sided Jacobi in the parallel (round-robin) order, so
// each round rotates n/2 disjoint pairs at once: the pairs' rotations
// (Rutishauser's form, tan from (a_qq - a_pp) / 2 a_pq), then rows p and q
// of A, then columns p and q of A and of V, with a_pp, a_qq set from the
// closed form and a_pq to exactly 0. A sweep is n - 1 rounds (n rounded up
// to even, the extra index idle). A pair whose a_pq is under the threshold
// is not rotated (its a_pq is dropped), and the block stops after a sweep
// that rotated nothing, at most EIGH_MAX_SWEEPS sweeps. The caller picks
// the threshold. Graded (the PnP solvers' normal matrices, whose null
// vector is the pose): |a_pq| <= eps sqrt(|a_pp a_qq|), the relative
// threshold of Demmel and Veselic, which keeps the small eigenpairs of a
// graded matrix accurate to their own size. Otherwise (the PSD clip, which
// needs the eigenvalues only to eps ||A||): |a_pq| <= eps ||A||_F, which
// ends in fewer sweeps. The 3x3 SVD is one-sided (Hestenes) Jacobi on the
// columns of A in float32, until no pair of columns is further from
// orthogonal than eps, at most SVD_MAX_SWEEPS.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int EIGH_MAX_THREADS = 1024;
constexpr int EIGH_MAX_N = 64;
constexpr int EIGH_MAX_SWEEPS = 30;
constexpr int SVD_MAX_SWEEPS = 30;
constexpr int SVD_THREADS = 128;

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ float value() { return 1.1920929e-7f; } };
template <> struct Eps<double> { static __device__ double value() { return 2.220446049250313e-16; } };

template <typename T>
__global__ void __launch_bounds__(EIGH_MAX_THREADS)
eigh_kernel(const T* __restrict__ a_in, T* __restrict__ w_out, T* __restrict__ v_out, int n,
            int graded) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + 1;  // padded rows: a column walk spreads over the banks
  T* A = reinterpret_cast<T*>(smem_raw);
  T* V = A + n * ld;
  __shared__ T s_c[EIGH_MAX_N / 2], s_s[EIGH_MAX_N / 2], s_dp[EIGH_MAX_N / 2],
      s_dq[EIGH_MAX_N / 2], s_sign[EIGH_MAX_N];
  __shared__ int s_p[EIGH_MAX_N / 2], s_q[EIGH_MAX_N / 2], s_rank[EIGH_MAX_N];
  __shared__ int s_rotated, s_nan;
  __shared__ T s_norm2;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long base = (long long)blockIdx.x * n * n;
  const int nn = n * n;

  if (tid == 0) {
    s_nan = 0;
    s_norm2 = 0;
  }
  __syncthreads();
  T norm2 = 0;
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e % n;
    const T x = i >= j ? a_in[base + e] : a_in[base + j * n + i];
    A[i * ld + j] = x;
    V[i * ld + j] = i == j ? T(1) : T(0);
    norm2 += x * x;
    if (x != x) s_nan = 1;
  }
  if (!graded) atomicAdd(&s_norm2, norm2);
  __syncthreads();
  const T eps = Eps<T>::value();
  // the threshold of an ungraded matrix, eps ||A||_F
  const T tol = eps * sqrt(s_norm2);

  const int m = (n + 1) & ~1;
  const int half = m / 2;
  for (int sweep = 0; sweep < EIGH_MAX_SWEEPS; ++sweep) {
    if (tid == 0) s_rotated = 0;
    __syncthreads();
    for (int r = 0; r < m - 1; ++r) {
      if (tid < half) {
        int p = tid == 0 ? r : (r + tid) % (m - 1);
        int q = tid == 0 ? m - 1 : (r - tid + m - 1) % (m - 1);
        if (p > q) { const int t = p; p = q; q = t; }
        T c = 1, s = 0, dp = 0, dq = 0;
        if (q < n) {
          const T app = A[p * ld + p], aqq = A[q * ld + q], apq = A[p * ld + q];
          dp = app;
          dq = aqq;
          if (fabs(apq) > (graded ? eps * sqrt(fabs(app)) * sqrt(fabs(aqq)) : tol)) {
            s_rotated = 1;
            const T theta = (aqq - app) / (T(2) * apq);
            const T t = (theta >= T(0) ? T(1) : T(-1)) / (fabs(theta) + hypot(T(1), theta));
            c = T(1) / sqrt(T(1) + t * t);
            s = t * c;
            dp = app - t * apq;
            dq = aqq + t * apq;
          }
        } else {
          q = -1;  // the idle index of an odd n
        }
        s_p[tid] = p; s_q[tid] = q; s_c[tid] = c; s_s[tid] = s; s_dp[tid] = dp; s_dq[tid] = dq;
      }
      __syncthreads();
      // rows p and q of A: A <- J^T A
      for (int e = tid; e < half * n; e += nt) {
        const int j = e / n, k = e % n, q = s_q[j];
        if (q < 0) continue;
        const int p = s_p[j];
        const T c = s_c[j], s = s_s[j];
        const T apk = A[p * ld + k], aqk = A[q * ld + k];
        A[p * ld + k] = c * apk - s * aqk;
        A[q * ld + k] = s * apk + c * aqk;
      }
      __syncthreads();
      // columns p and q of A and V: A <- A J, V <- V J; the pair's own 2x2
      // block from the closed form
      for (int e = tid; e < half * n; e += nt) {
        const int j = e / n, k = e % n, q = s_q[j];
        if (q < 0) continue;
        const int p = s_p[j];
        const T c = s_c[j], s = s_s[j];
        if (k == p) {
          A[p * ld + p] = s_dp[j];
          A[p * ld + q] = 0;
        } else if (k == q) {
          A[q * ld + q] = s_dq[j];
          A[q * ld + p] = 0;
        } else {
          const T akp = A[k * ld + p], akq = A[k * ld + q];
          A[k * ld + p] = c * akp - s * akq;
          A[k * ld + q] = s * akp + c * akq;
        }
        const T vkp = V[k * ld + p], vkq = V[k * ld + q];
        V[k * ld + p] = c * vkp - s * vkq;
        V[k * ld + q] = s * vkp + c * vkq;
      }
      __syncthreads();
    }
    // every thread reads the flag before thread 0 clears it again
    const bool done = !s_rotated || s_nan;
    __syncthreads();
    if (done) break;
  }

  // ascending order by rank (ties by index), canonical signs
  for (int k = tid; k < n; k += nt) {
    const T d = A[k * ld + k];
    if (d != d) s_nan = 1;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T dj = A[j * ld + j];
      rank += (dj < d) || (dj == d && j < k);
    }
    s_rank[k] = rank;
    int arg = 0;
    T big = fabs(V[k]);
    for (int i = 1; i < n; ++i) {
      const T x = fabs(V[i * ld + k]);
      if (x > big) { big = x; arg = i; }
    }
    s_sign[k] = V[arg * ld + k] < T(0) ? T(-1) : T(1);
  }
  __syncthreads();
  // with a NaN the ranks need not be a permutation: NaN in place
  const T qnan = T(NAN);
  for (int k = tid; k < n; k += nt)
    w_out[(long long)blockIdx.x * n + (s_nan ? k : s_rank[k])] = s_nan ? qnan : A[k * ld + k];
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, k = e % n;
    v_out[base + i * n + (s_nan ? k : s_rank[k])] = s_nan ? qnan : s_sign[k] * V[i * ld + k];
  }
}

__device__ inline void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__global__ void __launch_bounds__(SVD_THREADS)
svd3_kernel(const float* __restrict__ a_in, float* __restrict__ u_out, float* __restrict__ s_out,
            float* __restrict__ vt_out, int batch) {
  const int b = blockIdx.x * SVD_THREADS + threadIdx.x;
  if (b >= batch) return;
  const float* a = a_in + 9LL * b;
  float A[3][3], W[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i][j] = W[i][j] = a[3 * i + j];
      V[i][j] = i == j ? 1.0f : 0.0f;
    }
  const float eps = 1.1920929e-7f;
  for (int sweep = 0; sweep < SVD_MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      float al = 0.0f, be = 0.0f, ga = 0.0f;
      for (int i = 0; i < 3; ++i) {
        al += W[i][p] * W[i][p];
        be += W[i][q] * W[i][q];
        ga += W[i][p] * W[i][q];
      }
      if (!(fabsf(ga) > eps * sqrtf(al * be))) continue;
      rotated = true;
      const float zeta = (be - al) / (2.0f * ga);
      const float t = (zeta >= 0.0f ? 1.0f : -1.0f) / (fabsf(zeta) + hypotf(1.0f, zeta));
      const float c = 1.0f / sqrtf(1.0f + t * t), s = t * c;
      for (int i = 0; i < 3; ++i) {
        const float wp = W[i][p], wq = W[i][q];
        W[i][p] = c * wp - s * wq;
        W[i][q] = s * wp + c * wq;
        const float vp = V[i][p], vq = V[i][q];
        V[i][p] = c * vp - s * vq;
        V[i][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  float sv[3];
  int order[3] = {0, 1, 2};
  for (int k = 0; k < 3; ++k) sv[k] = sqrtf(W[0][k] * W[0][k] + W[1][k] * W[1][k] + W[2][k] * W[2][k]);
  // descending, stable
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && sv[order[j]] > sv[order[j - 1]]; --j) {
      const int t = order[j]; order[j] = order[j - 1]; order[j - 1] = t;
    }
  float v[3][3], y[3][3], s[3];
  for (int k = 0; k < 3; ++k) {
    const int o = order[k];
    s[k] = sv[o];
    int arg = 0;
    float big = fabsf(V[0][o]);
    for (int i = 1; i < 3; ++i)
      if (fabsf(V[i][o]) > big) { big = fabsf(V[i][o]); arg = i; }
    const float sign = V[arg][o] < 0.0f ? -1.0f : 1.0f;
    for (int i = 0; i < 3; ++i) v[k][i] = sign * V[i][o];
    for (int i = 0; i < 3; ++i) y[k][i] = A[i][0] * v[k][0] + A[i][1] * v[k][1] + A[i][2] * v[k][2];
  }
  float u[3][3];
  const float n1 = sqrtf(dot3(y[0], y[0]));
  for (int i = 0; i < 3; ++i) u[0][i] = n1 > 0.0f ? y[0][i] / n1 : (i == 0 ? 1.0f : 0.0f);
  const float d12 = dot3(u[0], y[1]);
  float w2[3];
  for (int i = 0; i < 3; ++i) w2[i] = y[1][i] - d12 * u[0][i];
  const float n2 = sqrtf(dot3(w2, w2));
  if (n2 > 8.0f * eps * n1) {
    for (int i = 0; i < 3; ++i) u[1][i] = w2[i] / n2;
  } else {
    // any unit vector orthogonal to u1: u1 x the axis it is least along
    int ax = 0;
    for (int i = 1; i < 3; ++i)
      if (fabsf(u[0][i]) < fabsf(u[0][ax])) ax = i;
    float e[3] = {0.0f, 0.0f, 0.0f};
    e[ax] = 1.0f;
    cross3(u[0], e, w2);
    const float ne = sqrtf(dot3(w2, w2));
    for (int i = 0; i < 3; ++i) u[1][i] = w2[i] / ne;
  }
  cross3(u[0], u[1], u[2]);
  if (dot3(u[2], y[2]) < 0.0f)
    for (int i = 0; i < 3; ++i) u[2][i] = -u[2][i];
  if (!(s[0] == s[0] && s[1] == s[1] && s[2] == s[2]))
    for (int k = 0; k < 3; ++k)
      for (int i = 0; i < 3; ++i) u[k][i] = NAN;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      u_out[9LL * b + 3 * i + k] = u[k][i];
      vt_out[9LL * b + 3 * k + i] = v[k][i];
    }
  for (int k = 0; k < 3; ++k) s_out[3LL * b + k] = s[k];
}

template <typename T>
int eigh_launch(const T* a, T* w, T* v, int batch, int n, int graded, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)n * (n + 1) * sizeof(T);
  static bool big_smem = false;
  if (smem > 48 * 1024 && !big_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        eigh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * EIGH_MAX_N * (EIGH_MAX_N + 1) * (int)sizeof(T));
    if (e != cudaSuccess) return (int)e;
    big_smem = true;
  }
  // a thread for each (pair, row) of a pass, as far as a block holds them
  const int items = ((n + 1) / 2) * n;
  const int threads = items >= EIGH_MAX_THREADS ? EIGH_MAX_THREADS
                                                 : (items < 64 ? 64 : (items + 31) / 32 * 32);
  eigh_kernel<T><<<batch, threads, smem, stream>>>(a, w, v, n, graded);
  return (int)cudaGetLastError();
}

}  // namespace

// eigh of `batch` [n, n] matrices; is_double selects float64 over float32,
// graded the relative threshold over eps ||A||_F
extern "C" int small_eigh_launch(const void* a, void* w, void* v, int batch, int n,
                                 int is_double, int graded, void* stream) {
  if (batch <= 0 || n <= 0 || n > EIGH_MAX_N) return (int)cudaErrorInvalidValue;
  if (is_double)
    return eigh_launch((const double*)a, (double*)w, (double*)v, batch, n, graded,
                       (cudaStream_t)stream);
  return eigh_launch((const float*)a, (float*)w, (float*)v, batch, n, graded,
                     (cudaStream_t)stream);
}

// svd of `batch` float32 [3, 3] matrices
extern "C" int small_svd3_launch(const float* a, float* u, float* s, float* vt, int batch,
                                 void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  svd3_kernel<<<(batch + SVD_THREADS - 1) / SVD_THREADS, SVD_THREADS, 0, (cudaStream_t)stream>>>(
      a, u, s, vt, batch);
  return (int)cudaGetLastError();
}
