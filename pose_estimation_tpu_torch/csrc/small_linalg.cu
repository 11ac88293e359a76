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
//   index on ties). A matrix holding a NaN or an infinity gives NaN
//   throughout.
//   svd3: each float32 [3, 3] matrix A = U diag(S) V^T with S descending;
//   V's columns are canonical as above; U's columns are u1 = A v1 / |A v1|,
//   u2 = A v2 made orthogonal to u1 and normalised, u3 = +-(u1 x u2) with
//   the sign of (u1 x u2) . A v3. So U is a rotation or a reflection for
//   every A, rank 2 and rank 1 included, and U diag(1, 1, det(U V^T)) V^T
//   is a rotation.
//
// What bounds eigh on the H100: neither bytes nor operations. The largest
// call, the clip of one [45, 45] float64 matrix, moves 32 KB and needs
// ~10 sweeps x 45 rounds x ~3,100 multiply-adds, ~1.4e6 float64
// operations: tens of microseconds of one SM. A Jacobi sweep is a chain of
// dependent rounds, so a matrix is latency bound: its time is the number
// of rounds times the latency of a round. One block a matrix keeps the
// chain on one SM with the matrix and its eigenvector accumulator in
// shared memory, and a batch runs its matrices side by side on the 132
// SMs. The first form of this kernel spent three barrier-separated passes
// a round (the rotations on 23 of 1,024 threads, rows, then columns and V)
// and a whole sweep that rotated nothing to stop: 1.0515 device ms for
// the clip, ~2 us a round (H100 80GB HBM3, 700 W), slower than
// torch.linalg.eigh. This form spends one pass a round:
//
// 1. One pass a round. The rotations of a round act on disjoint pairs,
//    so A' = J^T A J is computed block by block: for the pairs i <= j,
//    A'[Pi, Pj] = Ji^T A[Pi, Pj] Jj (the right factor first), one thread a
//    block. A is kept as its lower triangle, double-buffered, so no thread
//    reads what another writes in the pass, and each entry is written
//    once. A pair's diagonal block is set from the closed form, a'_pq = 0.
//    V's columns are updated in place by other items of the same pass, two
//    entries an item (V is kept transposed, a column a contiguous row).
// 2. The rotations are computed one round ahead, where their inputs are.
//    A pair (p, q) of round r + 1 lies in the off-diagonal block of round r
//    whose pairs hold p and q. One thread a pair of round r + 1 computes
//    that one entry of A' as the block's thread does, reads a'_pp and
//    a'_qq from the closed form published with round r's rotations, and
//    publishes the next (c, s, a'_pp, a'_qq). Where that block lies is
//    planned once a block for all m - 1 rounds (the entries' offsets and
//    the slots and sides, 12 bytes a pair), so the chain starts with one
//    load. It runs on a warp of its own, the last, beside the block and V
//    updates, and no thread recomputes another's rotation.
// 3. A shorter rotation, two inverse square roots and no division: with d
//    = a_qq - a_pp and a_pq scaled by the power of two of max(|d|, 2 |a_pq|)
//    (the exponent bits, so d^2 + 4 a_pq^2 lies in [1, 8] for any finite
//    input), rho = 1 / sqrt(d^2 + 4 a_pq^2), w = (|d| + 1 / rho) rho / 2 =
//    c^2, g = 1 / sqrt(w), c = w g, s = sign(d) a_pq rho g, t = s g (the
//    tangent t = sign(d) 2 a_pq / (|d| + sqrt(d^2 + 4 a_pq^2)) of the
//    smaller angle) and new diagonals a_pp - t a_pq, a_qq + t a_pq. rsqrt
//    in float64, 1 / sqrtf in float32.
// 4. No integer division in the loop: a slot's pair in a round is two
//    additions modulo m - 1 by compare and select, and each thread's block
//    and V items are fixed before the loop.
// 5. The stop costs no pass: each block thread tests its four new entries
//    against their thresholds, and the round's one barrier is a
//    __syncthreads_or of those tests. The block leaves as soon as no
//    off-diagonal is over its threshold, so a diagonal input (the
//    identity's Schur complement on every frame that marginalizes
//    nothing) leaves before its first round, and no sweep is walked
//    empty.
// The small PnP shapes ([512, 12, 12], [512, 3, 3] float32) keep this
// layout, their blocks and rotations in one warp and V on the warps after
// it. The clip takes ~0.8 us a round, 0.35 device ms (NVIDIA H100 80GB
// HBM3, 700.00 W; tools/k6_times.py): a chain of dependent shared-memory
// loads and float64 operations each round, not the card's rates, still
// bounds it.
//
// Method: cyclic two-sided Jacobi in the parallel (round-robin) order;
// round r pairs r with m - 1 and (r + k) with (r - k) mod (m - 1), m = n
// rounded up to even, the matrix padded with a zero row and column for an
// odd n (the idle index, never rotated). A pair whose a_pq is at or under
// its threshold is not rotated and its a_pq is dropped. The caller picks
// the threshold. Graded (the PnP solvers' normal matrices, whose null
// vector is the pose): |a_pq| <= eps sqrt(|a_pp|) sqrt(|a_qq|), the
// relative threshold of Demmel and Veselic, which keeps the small
// eigenpairs of a graded matrix accurate to their own size. Otherwise (the
// PSD clip, which needs the eigenvalues only to eps ||A||):
// |a_pq| <= eps ||A||_F, which ends in fewer sweeps. At most
// EIGH_MAX_SWEEPS sweeps. tests/test_torch_k6_model.py models this order
// of operations in numpy. The 3x3 SVD is one-sided (Hestenes) Jacobi on
// the columns of A in float32, until no pair of columns is further from
// orthogonal than eps, at most SVD_MAX_SWEEPS.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int EIGH_MAX_THREADS = 1024;
constexpr int EIGH_MAX_N = 64;
constexpr int EIGH_MAX_HALF = EIGH_MAX_N / 2;
constexpr int EIGH_MAX_SWEEPS = 30;
// V items (slot, column pair) a thread updates in a round, at most: the
// launch gives the half^2 items to the threads of half (half + 1) / 2
// blocks rounded up to warps, or of half^2 when the blocks fit in one warp
constexpr int EIGH_V_ITEMS = 2;
constexpr int SVD_MAX_SWEEPS = 30;
constexpr int SVD_THREADS = 128;

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ float value() { return 1.1920929e-7f; } };
template <> struct Eps<double> { static __device__ double value() { return 2.220446049250313e-16; } };

// 2^-e for the binary exponent e of g >= 0, read from its exponent bits and
// clamped to a normal number
__device__ inline double pow2_inverse(double g) {
  const long long e = (__double_as_longlong(g) >> 52) & 0x7ff;
  const long long f = min(max(2046LL - e, 1LL), 2045LL);
  return __longlong_as_double(f << 52);
}

__device__ inline float pow2_inverse(float g) {
  const int e = (__float_as_int(g) >> 23) & 0xff;
  const int f = min(max(254 - e, 1), 253);
  return __int_as_float(f << 23);
}

__device__ inline double inv_sqrt(double x) { return rsqrt(x); }
__device__ inline float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

__device__ inline double fma_rn(double x, double y, double z) { return __fma_rn(x, y, z); }
__device__ inline float fma_rn(float x, float y, float z) { return __fmaf_rn(x, y, z); }

// x c - y s and x s + y c, each rounded the same way wherever they are
// computed (a block's thread and the next round's rotation thread)
template <typename T>
__device__ inline T rot_lo(T x, T y, T c, T s) { return fma_rn(x, c, -(y * s)); }
template <typename T>
__device__ inline T rot_hi(T x, T y, T c, T s) { return fma_rn(x, s, y * c); }

// entry (a, b) of Ji^T B Jj, B = [[b00, b01], [b10, b11]], Jk = [[ck, sk],
// [-sk, ck]]: the right factor first
template <typename T>
__device__ inline T block_entry(int a, int b, T b00, T b01, T b10, T b11, T ci, T si, T cj,
                                T sj) {
  const T x0 = b ? rot_hi(b00, b01, cj, sj) : rot_lo(b00, b01, cj, sj);
  const T x1 = b ? rot_hi(b10, b11, cj, sj) : rot_lo(b10, b11, cj, sj);
  return a ? rot_hi(x0, x1, ci, si) : rot_lo(x0, x1, ci, si);
}

// the rotation of a pair: (c, s) and the new diagonal; none unless `over`
template <typename T>
__device__ inline void rotation(T app, T aqq, T apq, bool over, T& c, T& s, T& dp, T& dq) {
  if (!over) {
    c = 1; s = 0; dp = app; dq = aqq;
    return;
  }
  const T d = aqq - app;
  const T f = pow2_inverse(fmax(fabs(d), T(2) * fabs(apq)));
  const T ds = d * f, as = apq * f;
  const T h = ds * ds + T(4) * as * as;              // in [1, 8]
  const T rho = inv_sqrt(h);                          // 1 / r, r = sqrt(d^2 + 4 a_pq^2)
  const T w = T(0.5) * (fabs(ds) + h * rho) * rho;   // c^2 = (|d| + r) / 2r, in [1/2, 1]
  const T g = inv_sqrt(w);                            // 1 / c
  c = w * g;
  s = (ds >= T(0) ? as : -as) * rho * g;
  const T t = s * g;
  dp = app - t * apq;
  dq = aqq + t * apq;
}

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// round r's pair in slot k, p < q: r + k with r - k (mod m - 1), slot 0
// r with m - 1
__device__ inline int wrap(int x, int m1) { return x >= m1 ? x - m1 : (x < 0 ? x + m1 : x); }

__device__ inline void slot_pair(int k, int r, int m1, int& p, int& q) {
  const int u = wrap(r + k, m1), v = k == 0 ? m1 : wrap(r - k, m1);
  p = min(u, v);
  q = max(u, v);
}

// the slot of index x in round r
__device__ inline int slot_of(int x, int r, int m1, int half) {
  if (x == m1) return 0;
  const int d = wrap(x - r, m1);
  return d < half ? d : m1 - d;
}

template <typename T>
__global__ void __launch_bounds__(EIGH_MAX_THREADS)
eigh_kernel(const T* __restrict__ a_in, T* __restrict__ w_out, T* __restrict__ v_out,
            int* __restrict__ rounds_out, int n, int graded, int rot_base) {
  using T2 = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = n + (n & 1), half = m / 2, m1 = m - 1, ld = m + 1;
  // A and the next A, [m, ld] each, lower triangles; V transposed, [m, m]:
  // row k is column k of V
  T* A = reinterpret_cast<T*>(smem_raw);
  T* An = A + m * ld;
  T* VT = An + m * ld;
  // the rotation thread's plan of each (round r, slot k): where round r's
  // block holding round r + 1's pair k lies (its four entries' offsets in
  // A, 16 bits each) and its slots and sides (`plan_meta`)
  uint2* plan_off = reinterpret_cast<uint2*>(VT + m * m);
  unsigned* plan_meta = reinterpret_cast<unsigned*>(plan_off + m1 * half);
  // the published rotations of a round and of the next, by slot: (c, s),
  // the new diagonal (a_pp, a_qq), its magnitudes' square roots
  __shared__ T2 s_cs[2][EIGH_MAX_HALF], s_d[2][EIGH_MAX_HALF], s_g[2][EIGH_MAX_HALF];
  __shared__ T s_sign[EIGH_MAX_N], s_part[EIGH_MAX_THREADS / 32];
  __shared__ int s_rank[EIGH_MAX_N], s_bad;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long base = (long long)blockIdx.x * n * n;
  const T eps = Eps<T>::value();
  // entry (x, y) of A in its lower triangle
  auto sym = [ld](int x, int y) { return x > y ? x * ld + y : y * ld + x; };

  if (tid == 0) s_bad = 0;
  T norm2 = 0;
  bool bad = false;
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    T x = 0;
    if (i < n && j < n) x = i >= j ? a_in[base + i * n + j] : a_in[base + j * n + i];
    if (i >= j) A[i * ld + j] = x;
    VT[e] = i == j ? T(1) : T(0);
    norm2 += x * x;
    bad |= !isfinite(x);
  }
  // ||A||_F^2 in a fixed order, so that every launch stops alike
  for (int o = 16; o > 0; o >>= 1) norm2 += __shfl_xor_sync(0xffffffffu, norm2, o);
  if ((tid & 31) == 0) s_part[tid >> 5] = norm2;
  const bool nan_in = __syncthreads_or(bad);
  T tol = 0;  // the threshold of an ungraded matrix, eps ||A||_F
  if (!graded) {
    T sum = 0;
    for (int w = 0; w < (nt + 31) / 32; ++w) sum += s_part[w];
    tol = eps * sqrt(sum);
  }

  // this thread's items: the block of slots (bi, bj), bi <= bj, the j's
  // of a row side by side; the slot krot of the next round; up to
  // EIGH_V_ITEMS (slot vj, column pair vk) of V
  const int nb = half * (half + 1) / 2;
  int bi = 0, bj = -1;
  if (tid < nb) {
    int t = tid;
    while (t >= half - bi) { t -= half - bi; ++bi; }
    bj = bi + t;
  }
  // the rotation threads: after the blocks in the first warp if all fit
  // in it, else the last warp; V's items on the other warps, from the last
  // thread down, so that threads without a block take them first
  const bool one_warp = nb + half <= 32;
  const int krot = tid - rot_base;
  const bool rotator = krot >= 0 && krot < half;
  const int vthreads = nt - 32;
  const int vt = one_warp ? (tid >= 32 ? nt - 1 - tid : -1) : rot_base - 1 - tid;
  int vj[EIGH_V_ITEMS], vk[EIGH_V_ITEMS], nv = 0;
#pragma unroll
  for (int u = 0; u < EIGH_V_ITEMS; ++u) {
    const int e = vt < 0 ? half * half : vt + u * vthreads;
    vj[u] = e / half;
    vk[u] = e - vj[u] * half;
    if (e < half * half) nv = u + 1;
  }

  // round 0's rotations and the stop test of the input
  bool busy = false;
  if (!nan_in) {
    if (rotator) {
      int p, q;
      slot_pair(krot, 0, m1, p, q);
      const T app = A[p * ld + p], aqq = A[q * ld + q], apq = A[q * ld + p];
      const bool over = graded ? fabs(apq) > eps * sqrt(fabs(app)) * sqrt(fabs(aqq))
                               : fabs(apq) > tol;
      T c, s, dp, dq;
      rotation(app, aqq, apq, over, c, s, dp, dq);
      s_cs[0][krot] = T2{c, s};
      s_d[0][krot] = T2{dp, dq};
      if (graded) s_g[0][krot] = T2{sqrt(fabs(dp)), sqrt(fabs(dq))};
    }
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e - i * n;
      if (i > j)
        busy |= fabs(A[i * ld + j]) > (graded ? eps * sqrt(fabs(A[i * ld + i]))
                                                    * sqrt(fabs(A[j * ld + j]))
                                              : tol);
    }
  }
  busy = __syncthreads_or(busy);
  if (busy) {
    for (int e = tid; e < m1 * half; e += nt) {
      const int r = e / half, k = e - r * half, rn = r + 1 == m1 ? 0 : r + 1;
      int p, q, pa, qa, pb, qb;
      slot_pair(k, rn, m1, p, q);
      const int ip = slot_of(p, r, m1, half), iq = slot_of(q, r, m1, half);
      slot_pair(ip, r, m1, pa, qa);
      slot_pair(iq, r, m1, pb, qb);
      const int sp = p == pa ? 0 : 1, sq = q == pb ? 0 : 1;
      const bool swap = ip > iq;
      const int pl = swap ? pb : pa, ql = swap ? qb : qa, ph = swap ? pa : pb,
                qh = swap ? qa : qb;
      plan_off[e] = make_uint2((unsigned)sym(pl, ph) | (unsigned)sym(pl, qh) << 16,
                               (unsigned)sym(ql, ph) | (unsigned)sym(ql, qh) << 16);
      plan_meta[e] = (unsigned)(swap ? iq : ip) | (unsigned)(swap ? ip : iq) << 8
                     | (unsigned)(swap ? sq : sp) << 16 | (unsigned)(swap ? sp : sq) << 17
                     | (unsigned)swap << 18 | (unsigned)(ip == iq) << 19;
    }
    __syncthreads();
  }

  const int max_rounds = EIGH_MAX_SWEEPS * m1;
  int rounds = 0, rr = 0;
  while (busy && rounds < max_rounds) {
    const int cur = rounds & 1, rn = rr + 1 == m1 ? 0 : rr + 1;
    bool over = false;
    if (bj >= 0) {
      int pi, qi;
      slot_pair(bi, rr, m1, pi, qi);
      if (bi == bj) {
        const T2 d = s_d[cur][bi];
        An[pi * ld + pi] = d.x;
        An[qi * ld + qi] = d.y;
        An[qi * ld + pi] = T(0);
      } else {
        int pj, qj;
        slot_pair(bj, rr, m1, pj, qj);
        const T2 csi = s_cs[cur][bi], csj = s_cs[cur][bj];
        const T b00 = A[sym(pi, pj)], b01 = A[sym(pi, qj)], b10 = A[sym(qi, pj)],
                b11 = A[sym(qi, qj)];
        const T n00 = block_entry(0, 0, b00, b01, b10, b11, csi.x, csi.y, csj.x, csj.y);
        const T n01 = block_entry(0, 1, b00, b01, b10, b11, csi.x, csi.y, csj.x, csj.y);
        const T n10 = block_entry(1, 0, b00, b01, b10, b11, csi.x, csi.y, csj.x, csj.y);
        const T n11 = block_entry(1, 1, b00, b01, b10, b11, csi.x, csi.y, csj.x, csj.y);
        An[sym(pi, pj)] = n00;
        An[sym(pi, qj)] = n01;
        An[sym(qi, pj)] = n10;
        An[sym(qi, qj)] = n11;
        if (graded) {
          const T2 gi = s_g[cur][bi], gj = s_g[cur][bj];
          const T gpi = eps * gi.x, gqi = eps * gi.y;
          over = fabs(n00) > gpi * gj.x || fabs(n01) > gpi * gj.y || fabs(n10) > gqi * gj.x
                 || fabs(n11) > gqi * gj.y;
        } else {
          over = fmax(fmax(fabs(n00), fabs(n01)), fmax(fabs(n10), fabs(n11))) > tol;
        }
      }
    }
    if (rotator) {
      // the next round's pair (p, q): its entry of the block (lo, hi) of
      // this round that holds it, and its new diagonal from this round's
      // closed form, by the plan
      const uint2 off = plan_off[rr * half + krot];
      const unsigned meta = plan_meta[rr * half + krot];
      const int lo = meta & 255, hi = (meta >> 8) & 255, a = (meta >> 16) & 1,
                b = (meta >> 17) & 1;
      const bool swap = (meta >> 18) & 1;
      const int ip = swap ? hi : lo, iq = swap ? lo : hi, sp = swap ? b : a, sq = swap ? a : b;
      const T2 dip = s_d[cur][ip], diq = s_d[cur][iq];
      const T app = sp ? dip.y : dip.x, aqq = sq ? diq.y : diq.x;
      T apq = 0;
      if (!((meta >> 19) & 1)) {
        const T2 cl = s_cs[cur][lo], ch = s_cs[cur][hi];
        apq = block_entry(a, b, A[off.x & 0xffff], A[off.x >> 16], A[off.y & 0xffff],
                          A[off.y >> 16], cl.x, cl.y, ch.x, ch.y);
      }
      bool rot_over;
      if (graded) {
        const T2 gip = s_g[cur][ip], giq = s_g[cur][iq];
        rot_over = fabs(apq) > eps * (sp ? gip.y : gip.x) * (sq ? giq.y : giq.x);
      } else {
        rot_over = fabs(apq) > tol;
      }
      T c, s, dp, dq;
      rotation(app, aqq, apq, rot_over, c, s, dp, dq);
      const int nx = cur ^ 1;
      s_cs[nx][krot] = T2{c, s};
      s_d[nx][krot] = T2{dp, dq};
      if (graded) s_g[nx][krot] = T2{sqrt(fabs(dp)), sqrt(fabs(dq))};
    }
    // V <- V J: columns p and q of V are rows p and q of VT, two entries
    // at a time
#pragma unroll
    for (int u = 0; u < EIGH_V_ITEMS; ++u) {
      if (u < nv) {
        int p, q;
        slot_pair(vj[u], rr, m1, p, q);
        const T2 cs = s_cs[cur][vj[u]];
        T2* const rp = reinterpret_cast<T2*>(VT + p * m) + vk[u];
        T2* const rq = reinterpret_cast<T2*>(VT + q * m) + vk[u];
        const T2 vp = *rp, vq = *rq;
        *rp = T2{rot_lo(vp.x, vq.x, cs.x, cs.y), rot_lo(vp.y, vq.y, cs.x, cs.y)};
        *rq = T2{rot_hi(vp.x, vq.x, cs.x, cs.y), rot_hi(vp.y, vq.y, cs.x, cs.y)};
      }
    }
    busy = __syncthreads_or(over);
    T* const t = A;
    A = An;
    An = t;
    rr = rn;
    ++rounds;
  }
  if (rounds_out != nullptr && tid == 0) rounds_out[blockIdx.x] = rounds;

  // ascending order by rank (ties by index), canonical signs
  for (int k = tid; k < n; k += nt) {
    const T d = A[k * ld + k];
    if (d != d) s_bad = 1;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T dj = A[j * ld + j];
      rank += (dj < d) || (dj == d && j < k);
    }
    s_rank[k] = rank;
    int arg = 0;
    T big = fabs(VT[k * m]);
    for (int i = 1; i < n; ++i) {
      const T x = fabs(VT[k * m + i]);
      if (x > big) { big = x; arg = i; }
    }
    s_sign[k] = VT[k * m + arg] < T(0) ? T(-1) : T(1);
  }
  __syncthreads();
  // with a NaN the ranks need not be a permutation: NaN in place
  const bool nan_out = nan_in || s_bad;
  const T qnan = T(NAN);
  for (int k = tid; k < n; k += nt)
    w_out[(long long)blockIdx.x * n + (nan_out ? k : s_rank[k])] = nan_out ? qnan : A[k * ld + k];
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, k = e - i * n;
    v_out[base + i * n + (nan_out ? k : s_rank[k])] = nan_out ? qnan : s_sign[k] * VT[k * m + i];
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
int eigh_launch(const T* a, T* w, T* v, int* rounds, int batch, int n, int graded,
                cudaStream_t stream) {
  const int m = n + (n & 1), half = m / 2;
  const size_t smem = (size_t)m * (3 * m + 2) * sizeof(T) + (size_t)(m - 1) * half * 12;
  static bool big_smem = false;
  if (smem > 48 * 1024 && !big_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        eigh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        EIGH_MAX_N * (3 * EIGH_MAX_N + 2) * (int)sizeof(T)
            + (EIGH_MAX_N - 1) * EIGH_MAX_HALF * 12);
    if (e != cudaSuccess) return (int)e;
    big_smem = true;
  }
  // the blocks i <= j, then the rotation threads: in the first warp if
  // all fit in it (V's half x half items then one a thread on the warps
  // after it), else on the last warp (V's items on the warps before it,
  // which also hold the blocks); at most EIGH_V_ITEMS V items a thread
  const int nb = half * (half + 1) / 2;
  const bool one_warp = nb + half <= 32;
  const int threads = 32 + (one_warp ? (half * half + 31) / 32 * 32 : (nb + 31) / 32 * 32);
  const int rot_base = one_warp ? nb : threads - 32;
  eigh_kernel<T><<<batch, threads, smem, stream>>>(a, w, v, rounds, n, graded, rot_base);
  return (int)cudaGetLastError();
}

}  // namespace

// eigh of `batch` [n, n] matrices; is_double selects float64 over float32,
// graded the relative threshold over eps ||A||_F; rounds, when not null,
// receives each matrix's number of Jacobi rounds
extern "C" int small_eigh_launch(const void* a, void* w, void* v, int* rounds, int batch, int n,
                                 int is_double, int graded, void* stream) {
  if (batch <= 0 || n <= 0 || n > EIGH_MAX_N) return (int)cudaErrorInvalidValue;
  if (is_double)
    return eigh_launch((const double*)a, (double*)w, (double*)v, rounds, batch, n, graded,
                       (cudaStream_t)stream);
  return eigh_launch((const float*)a, (float*)w, (float*)v, rounds, batch, n, graded,
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
