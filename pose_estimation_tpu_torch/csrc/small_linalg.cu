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
// of operations in numpy.
//
// The 3x3 SVD: one-sided (Hestenes) Jacobi on the columns of A itself in
// float32, not eigh(A^T A), which would square the condition number (the
// DLT's rank-2 P[:, :3] needs its small singular value), one thread a
// matrix. Its first form looped until no pair was further from
// orthogonal than eps (at most 30 sweeps) with a precise division, hypotf
// and 1 / sqrtf on each rotation's dependent chain, and sorted through
// runtime-indexed arrays: 0.0065 device ms at [512, 3, 3], ~12,900 clocks
// (H100 80GB HBM3, 700.00 W), on 4 of the 132 SMs. This form has
// 1. a fixed count of cyclic sweeps, SVD_SWEEPS = 5 of the pairs (0, 1),
//    (0, 2), (1, 2), and no data-dependent exit, as in McAdams et al.
//    2011, "Computing the SVD of 3x3 matrices with minimal branching and
//    elementary floating point operations". A rotation of a pair no
//    further from orthogonal than eps is the identity by a select. In the
//    numpy model of this order of operations
//    (tests/test_torch_svd3_model.py: rank 3, 2 and 1, near-repeated
//    singular values, entries near 1e15 and 1e-15), 3 sweeps leave the
//    columns up to 4.1e-7 ||A||^2 from orthogonal and 4 reach the float32
//    floor (<= 5.5e-8) in every case, as over 20,000 matrices of each kind;
//    the fifth is the margin;
// 2. eigh's short rotation with rsqrtf for both inverse square roots, no
//    division and no hypotf: an exactly orthogonal pair takes c = 1, s = 0;
// 3. the Gram entries |w_p|^2, |w_q|^2, w_p . w_q recomputed from W at
//    each rotation, three independent dot products;
// 4. named registers only (float3 columns; the descending, stable sort as
//    three compare-and-swaps; the canonical signs and U's fallback axis by
//    selects), so no array goes to local memory;
// 5. 32 matrices a block, so batch 512 runs on 16 SMs, its 9 floats a
//    matrix loaded and its U, S and V^T stored through shared memory,
//    coalesced.

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
// the SVD's cyclic sweeps (3 rotations each) and matrices a block (the
// header says why)
constexpr int SVD_SWEEPS = 5;
constexpr int SVD_THREADS = 32;

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

__device__ inline float dot3(float3 a, float3 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, a.z * b.z));
}

__device__ inline float3 scale3(float3 a, float k) {
  return make_float3(a.x * k, a.y * k, a.z * k);
}

__device__ inline float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// x c - y s and x s + y c, column by column
__device__ inline void rotate3(float3& x, float3& y, float c, float s) {
  const float3 a = x, b = y;
  x = make_float3(rot_lo(a.x, b.x, c, s), rot_lo(a.y, b.y, c, s), rot_lo(a.z, b.z, c, s));
  y = make_float3(rot_hi(a.x, b.x, c, s), rot_hi(a.y, b.y, c, s), rot_hi(a.z, b.z, c, s));
}

// One Jacobi rotation of the column pair (p, q) of W = A V, and of V: the
// rotation of eigh on the pair's Gram entries (|w_p|^2, |w_q|^2, w_p . w_q)
// recomputed from W, so A's own columns carry the small singular values.
// A pair no further from orthogonal than eps (the Gram entries scaled by a
// power of two, so no product overflows) takes the identity exactly, by a
// select: an exactly orthogonal pair, a zero column, a NaN.
__device__ inline void svd_rotate(float3& wp, float3& wq, float3& vp, float3& vq) {
  const float al = dot3(wp, wp), be = dot3(wq, wq), ga = dot3(wp, wq);
  const float f2 = pow2_inverse(fmaxf(al, be));
  const float gs2 = ga * f2;
  const float eps = 1.1920929e-7f;
  const bool over = gs2 * gs2 > (eps * eps) * (al * f2) * (be * f2);
  // eigh's rotation with rsqrtf for both inverse square roots
  const float d = be - al;
  const float f = pow2_inverse(fmaxf(fabsf(d), 2.0f * fabsf(ga)));
  const float ds = d * f, gs = ga * f;
  const float h = fmaf(ds, ds, 4.0f * gs * gs);      // in [1, 8]
  const float rho = rsqrtf(h);
  const float w = 0.5f * fmaf(h, rho, fabsf(ds)) * rho;
  const float g = rsqrtf(w);
  const float c = over ? w * g : 1.0f;
  const float s = over ? (ds >= 0.0f ? gs : -gs) * rho * g : 0.0f;
  rotate3(wp, wq, c, s);
  rotate3(vp, vq, c, s);
}

// descending and stable: swap (i, j), i < j, when s_j > s_i
__device__ inline void svd_order(float& si, float& sj, float3& vi, float3& vj) {
  const bool sw = sj > si;
  const float a = si;
  const float3 b = vi;
  si = sw ? sj : si;
  sj = sw ? a : sj;
  vi = sw ? vj : vi;
  vj = sw ? b : vj;
}

// v with its component of largest magnitude positive (the first on ties)
__device__ inline float3 canonical3(float3 v) {
  float lead = v.x;
  lead = fabsf(v.y) > fabsf(lead) ? v.y : lead;
  lead = fabsf(v.z) > fabsf(lead) ? v.z : lead;
  return lead < 0.0f ? scale3(v, -1.0f) : v;
}

__device__ inline float3 mat_vec(const float3 (&rows)[3], float3 v) {
  return make_float3(dot3(rows[0], v), dot3(rows[1], v), dot3(rows[2], v));
}

__global__ void __launch_bounds__(SVD_THREADS)
svd3_kernel(const float* __restrict__ a_in, float* __restrict__ u_out, float* __restrict__ s_out,
            float* __restrict__ vt_out, int batch) {
  // the block's matrices through shared memory, so that the global loads
  // and stores are coalesced; a stride of 9 words leaves no bank conflict
  __shared__ float s_a[SVD_THREADS * 9], s_vt[SVD_THREADS * 9], s_s[SVD_THREADS * 3];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * SVD_THREADS;
  const int mats = (int)min((long long)SVD_THREADS, batch - first);
  for (int e = tid; e < 9 * mats; e += SVD_THREADS) s_a[e] = a_in[9 * first + e];
  __syncthreads();

  float3 rows[3];
  bool bad = false;
  if (tid < mats) {
    const float* a = s_a + 9 * tid;
    rows[0] = make_float3(a[0], a[1], a[2]);
    rows[1] = make_float3(a[3], a[4], a[5]);
    rows[2] = make_float3(a[6], a[7], a[8]);
#pragma unroll
    for (int k = 0; k < 9; ++k) bad |= !isfinite(a[k]);
  } else {
    rows[0] = rows[1] = rows[2] = make_float3(0.0f, 0.0f, 0.0f);
  }
  // the columns of W = A V, and of V
  float3 w0 = make_float3(rows[0].x, rows[1].x, rows[2].x);
  float3 w1 = make_float3(rows[0].y, rows[1].y, rows[2].y);
  float3 w2 = make_float3(rows[0].z, rows[1].z, rows[2].z);
  float3 v0 = make_float3(1.0f, 0.0f, 0.0f), v1 = make_float3(0.0f, 1.0f, 0.0f),
         v2 = make_float3(0.0f, 0.0f, 1.0f);
#pragma unroll
  for (int sweep = 0; sweep < SVD_SWEEPS; ++sweep) {
    svd_rotate(w0, w1, v0, v1);
    svd_rotate(w0, w2, v0, v2);
    svd_rotate(w1, w2, v1, v2);
  }
  float s0 = sqrtf(dot3(w0, w0)), s1 = sqrtf(dot3(w1, w1)), s2 = sqrtf(dot3(w2, w2));
  svd_order(s0, s1, v0, v1);
  svd_order(s1, s2, v1, v2);
  svd_order(s0, s1, v0, v1);
  v0 = canonical3(v0);
  v1 = canonical3(v1);
  v2 = canonical3(v2);

  // U: u1 = A v1 / |A v1|, u2 = A v2 made orthogonal to u1 (else u1 x the
  // axis u1 is least along), u3 = +-(u1 x u2) by the sign of (u1 x u2) . A v3
  const float eps = 1.1920929e-7f;
  const float3 y0 = mat_vec(rows, v0), y1 = mat_vec(rows, v1), y2 = mat_vec(rows, v2);
  const float n1 = dot3(y0, y0);
  const float3 u0 = n1 > 0.0f ? scale3(y0, rsqrtf(n1)) : make_float3(1.0f, 0.0f, 0.0f);
  const float d12 = dot3(u0, y1);
  const float3 r1 = make_float3(fmaf(-d12, u0.x, y1.x), fmaf(-d12, u0.y, y1.y),
                                fmaf(-d12, u0.z, y1.z));
  const float n2 = dot3(r1, r1);
  float3 axis = make_float3(1.0f, 0.0f, 0.0f);
  float least = fabsf(u0.x);
  axis = fabsf(u0.y) < least ? make_float3(0.0f, 1.0f, 0.0f) : axis;
  least = fminf(least, fabsf(u0.y));
  axis = fabsf(u0.z) < least ? make_float3(0.0f, 0.0f, 1.0f) : axis;
  const float3 side = cross3(u0, axis);
  // |r1| > 8 eps |y0|, squared
  const float3 u1 = n2 > (64.0f * eps * eps) * n1 ? scale3(r1, rsqrtf(n2))
                                                  : scale3(side, rsqrtf(dot3(side, side)));
  float3 u2 = cross3(u0, u1);
  u2 = dot3(u2, y2) < 0.0f ? scale3(u2, -1.0f) : u2;

  // stage U (row-major, columns u0, u1, u2) in s_a, V^T and S beside it
  __syncthreads();
  if (tid < mats) {
    const float q = NAN;
    float* u = s_a + 9 * tid;
    float* vt = s_vt + 9 * tid;
    const float uo[9] = {u0.x, u1.x, u2.x, u0.y, u1.y, u2.y, u0.z, u1.z, u2.z};
    const float vo[9] = {v0.x, v0.y, v0.z, v1.x, v1.y, v1.z, v2.x, v2.y, v2.z};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      u[k] = bad ? q : uo[k];
      vt[k] = bad ? q : vo[k];
    }
    s_s[3 * tid] = bad ? q : s0;
    s_s[3 * tid + 1] = bad ? q : s1;
    s_s[3 * tid + 2] = bad ? q : s2;
  }
  __syncthreads();
  for (int e = tid; e < 9 * mats; e += SVD_THREADS) {
    u_out[9 * first + e] = s_a[e];
    vt_out[9 * first + e] = s_vt[e];
  }
  for (int e = tid; e < 3 * mats; e += SVD_THREADS) s_out[3 * first + e] = s_s[e];
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
