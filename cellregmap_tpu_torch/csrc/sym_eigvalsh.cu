// K6a: batched eigenvalues of the score test's (C x C) weight matrices,
// f64, for sm_90a.
//
// For each matrix A_s (s < S), the eigenvalues of its symmetric part
// (A + A^T) / 2, ascending and clamped at 0: the mixture weights of the
// score statistic's null law.  The JAX package computes them as
// max(eigh(sym(A) + eps I) - eps, 0) with eps = 1e-12 max(max|diag|, 1)
// (cellregmap_tpu/ops/linalg.py `safe_eigh`, :238-249, clamped in
// `per_snp`, engine.py:759-769): the shift keeps the TPU's QDWH eigh off
// exactly singular inputs.  Neither route here needs it: Jacobi rotations
// and Householder reflections are defined for any symmetric input, so the
// eigenvalues of sym(A) are those of the shifted matrix, shifted back, to
// rounding.  A matrix with a non-finite entry gives C NaNs (as eigh's).
//
// Replaces: the batched device eigh of `per_snp` (engine.py:759-769) under
// the Liu, saddlepoint and auto p-value methods.
//
// What bounds it on the H100: latency.  A matrix is small (C <= 64) and
// its work a few C^3 flop (4000 at the headline's C = 10), far below any
// rate bound; what sets the time is the number of dependent steps and the
// synchronisation between them.  Two routes, by size:
//
// * C <= 32 (the headline's C = 10, 20 at 10k cells): one warp a matrix,
//   WPB matrices a block, each in shared memory with the odd leading
//   dimension C | 1 (a column pass's 32 rows fall in distinct banks).
//   Cyclic Jacobi in the round-robin (circle) order: in round r of a sweep
//   the indices 0..m-1 (m = C rounded up to even; the pad index takes no
//   rotation) form m/2 disjoint pairs, taken from a table made once a
//   block, so the round's rotations commute and run together.  A round:
//   each pair's lane computes its rotation (Golub & Van Loan's symmetric
//   Schur pair, t = sign(d) e / (|d| + sqrt(d^2 + e^2)), d = a_qq - a_pp,
//   e = 2 a_pq, which is their t = sign(tau) / (|tau| + sqrt(1 + tau^2))
//   with one division fewer, its reciprocals and square roots branch-free
//   Newton steps: the rotation is the round's path); the warp
//   applies J^T from the left (rows p, q of every pair) and then J from
//   the right (columns p, q); the pair's lane writes a_pp - t a_pq, a_qq +
//   t a_pq and 0 into its own 2 x 2 block (an a_pq below half an ulp of
//   sqrt(a_pp a_qq) is zeroed with no rotation, so that a repeated
//   eigenvalue's block ends the sweeps).  Four __syncwarp a round and no
//   block barrier.  After each sweep the warp reduces the off-diagonal
//   norm and stops below eps ||A||_F (at most MAX_SWEEPS sweeps; the count
//   is written out).  Each lane then ranks one diagonal entry (ties by
//   index) and writes max(lambda, 0) to its ascending position.
// * 32 < C (C = 50 of the aggregate environment and the `contexts50`
//   cell): one block a matrix, in dynamic shared memory.  Householder
//   reduction to tridiagonal form (C - 2 steps, each a reflector made on
//   warp 0, the matrix-vector product two threads a row, the rank-2 update
//   of the trailing block two threads a row: three block barriers a step,
//   one where the reflector is trivial),
//   then each eigenvalue on its own thread by Sturm-count bisection on the
//   Gershgorin interval (LAPACK dstebz's pivmin guard) to 2 eps of the
//   interval's scale, with no barrier; a prefix maximum keeps the
//   ascending order exact where two eigenvalues tie to rounding.  The
//   count written out is the most bisection steps of the matrix.
//
// Both routes are templates on the scalar type: the f64 instantiation
// above, and an f32 one for the float32 context (the screen's), which
// rounds the weight matrices to f32 and takes every step in f32, as the
// reference's `safe_eigh(Wmat.astype(ctx dtype))` does (engine.py:767).
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MAX_C = 32;   // the warp route's largest matrix
constexpr int WPB = 4;           // matrices (warps) a block, warp route
constexpr int NTB = 128;         // threads a block, block route
constexpr int MAX_SWEEPS = 30;
constexpr int MAX_BISECT = 128;

template <class T> struct Lim;
template <> struct Lim<float> {
  static constexpr float eps = FLT_EPSILON, tiny = FLT_MIN;
};
template <> struct Lim<double> {
  static constexpr double eps = DBL_EPSILON, tiny = DBL_MIN;
};

// 1 / x and 1 / sqrt(x): async_copy.cuh's branch-free Newton forms in f64,
// the IEEE division and square root in f32
__device__ __forceinline__ double rcp_t(double x) { return rcp_nr(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt_nr(x); }
__device__ __forceinline__ float rcp_t(float x) { return 1.0f / x; }
__device__ __forceinline__ float rsqrt_t(float x) { return 1.0f / sqrt(x); }

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The eigenvalues of WPB matrices a block, one warp each (C <= 32).
template <class T>
__global__ void __launch_bounds__(32 * WPB)
sym_eigvalsh_warp_kernel(const T* __restrict__ Ain,
                         T* __restrict__ lam,
                         int* __restrict__ sweeps_out, int S, int C) {
  extern __shared__ __align__(16) unsigned char ev_warp_dyn[];
  // round r's pairs (p << 8 | q), the rotations of each warp's round
  __shared__ unsigned short pairs[(WARP_MAX_C - 1) * (WARP_MAX_C / 2)];
  __shared__ T cs[WPB][WARP_MAX_C / 2], sn[WPB][WARP_MAX_C / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = C + (C & 1), npair = m / 2, LD = C | 1;
  for (int f = threadIdx.x; f < (m - 1) * npair; f += 32 * WPB) {
    const int r = f / npair, k = f - r * npair;
    // the circle order: index 0 stays, the others rotate
    const int a = k == 0 ? 0 : 1 + (k - 1 + r) % (m - 1);
    const int b = 1 + (m - 2 - k + r) % (m - 1);
    pairs[f] = (unsigned short)(min(a, b) << 8 | max(a, b));
  }
  __syncthreads();
  const int s = blockIdx.x * WPB + warp;
  if (s >= S) return;   // the whole warp, after the block's one barrier
  T* M = reinterpret_cast<T*>(ev_warp_dyn) + warp * C * LD;
  const T* src = Ain + (int64_t)s * C * C;
  bool bad = false;
  for (int idx = lane; idx < C * C; idx += 32) {
    const int i = idx / C, j = idx - i * C;
    const T v = T(0.5) * (src[i * C + j] + src[j * C + i]);
    bad = bad || !isfinite(v);
    M[i * LD + j] = v;
  }
  if (__ballot_sync(FULL, bad)) {
    if (lane < C) lam[(int64_t)s * C + lane] = nan("");
    if (lane == 0 && sweeps_out) sweeps_out[s] = 0;
    return;
  }
  __syncwarp();

  // the lane's first element (pair k, row or column c) of a flattened
  // pass over npair x C, and its step by 32
  const int k0 = lane / C, c0 = lane - k0 * C;
  const int dk = 32 / C, dc = 32 - dk * C;
  int sweep = 0;
  for (;;) {
    // off-diagonal and total squared norms
    T off = T(0.0), tot = T(0.0);
    for (int idx = lane; idx < C * C; idx += 32) {
      const int i = idx / C, j = idx - i * C;
      const T v = M[i * LD + j];
      tot += v * v;
      if (i != j) off += v * v;
    }
    off = warp_sum(off);
    tot = warp_sum(tot);
    if (!(off > Lim<T>::eps * Lim<T>::eps * tot) || sweep >= MAX_SWEEPS)
      break;
    ++sweep;

    for (int r = 0; r < m - 1; ++r) {
      const unsigned short* pr = pairs + r * npair;
      // each pair's rotation from its 2 x 2 block: with d = a_qq - a_pp
      // and e = 2 a_pq, t = sign(d) e / (|d| + sqrt(d^2 + e^2)) (the
      // Schur pair's smaller root, one square root and one division on
      // the round's path), c = 1 / sqrt(1 + t^2); an a_pq below half an
      // ulp of sqrt(a_pp a_qq) is zeroed with no rotation (t = 0), so
      // that a repeated eigenvalue's block ends the sweeps
      T app = T(0.0), aqq = T(0.0), apq = T(0.0), t = T(0.0);
      int pp = 0, qq = C;
      if (lane < npair) {
        pp = pr[lane] >> 8;
        qq = pr[lane] & 0xff;
        T c = T(1.0), sv = T(0.0);
        if (qq < C) {
          app = M[pp * LD + pp];
          aqq = M[qq * LD + qq];
          apq = M[pp * LD + qq];
          // (branch-free: where a_pq = 0 the candidate is NaN and unused)
          const T d = aqq - app, e = T(2.0) * apq, h2 = d * d + e * e;
          const T tt =
              (d >= T(0.0) ? e : -e) * rcp_t(fabs(d) + h2 * rsqrt_t(h2));
          const T aa = fabs(app * aqq);
          const T gm = aa > T(0.0) ? aa * rsqrt_t(aa) : T(0.0);
          const bool rot =
              apq != T(0.0) && fabs(apq) > T(0.5) * Lim<T>::eps * gm;
          t = rot ? tt : T(0.0);
          c = rsqrt_t(T(1.0) + t * t);
          sv = t * c;
        }
        cs[warp][lane] = c;
        sn[warp][lane] = sv;
      }
      __syncwarp();
      // rows p, q of every pair: M <- J^T M
      for (int idx = lane, k = k0, col = c0; idx < npair * C; idx += 32) {
        const int pk = pr[k] >> 8, qk = pr[k] & 0xff;
        if (qk < C) {
          const T c = cs[warp][k], sv = sn[warp][k];
          const T x = M[pk * LD + col], y = M[qk * LD + col];
          M[pk * LD + col] = c * x - sv * y;
          M[qk * LD + col] = sv * x + c * y;
        }
        k += dk;
        col += dc;
        if (col >= C) {
          col -= C;
          ++k;
        }
      }
      __syncwarp();
      // columns p, q of every pair: M <- M J
      for (int idx = lane, k = k0, row = c0; idx < npair * C; idx += 32) {
        const int pk = pr[k] >> 8, qk = pr[k] & 0xff;
        if (qk < C) {
          const T c = cs[warp][k], sv = sn[warp][k];
          const T x = M[row * LD + pk], y = M[row * LD + qk];
          M[row * LD + pk] = c * x - sv * y;
          M[row * LD + qk] = sv * x + c * y;
        }
        k += dk;
        row += dc;
        if (row >= C) {
          row -= C;
          ++k;
        }
      }
      __syncwarp();
      // the pair's own block, in the exact form
      if (qq < C && apq != T(0.0)) {
        M[pp * LD + pp] = app - t * apq;
        M[qq * LD + qq] = aqq + t * apq;
        M[pp * LD + qq] = T(0.0);
        M[qq * LD + pp] = T(0.0);
      }
      __syncwarp();
    }
  }

  // ascending order: each lane ranks one diagonal entry
  if (lane < C) {
    const T v = M[lane * LD + lane];
    int rank = 0;
    for (int j = 0; j < C; ++j) {
      const T u = M[j * LD + j];
      rank += (u < v) || (u == v && j < lane);
    }
    lam[(int64_t)s * C + rank] = v < T(0.0) ? T(0.0) : v;
  }
  if (lane == 0 && sweeps_out) sweeps_out[s] = sweep;
}

// the number of eigenvalues of the tridiagonal (d, e^2) below x (the
// Sturm count of T - x I, LAPACK dlaebz's pivmin guard)
template <class T>
__device__ int sturm_count(const T* d, const T* e2, int C,
                           T x, T pivmin) {
  T q = d[0] - x;
  if (fabs(q) < pivmin) q = -pivmin;
  int cnt = q < T(0.0);
  for (int j = 1; j < C; ++j) {
    q = d[j] - x - e2[j - 1] / q;
    if (fabs(q) < pivmin) q = -pivmin;
    cnt += q < T(0.0);
  }
  return cnt;
}

// The eigenvalues of one matrix a block (C > 32): Householder
// tridiagonalization, then bisection an eigenvalue a thread.
template <class T>
__global__ void __launch_bounds__(NTB)
sym_eigvalsh_block_kernel(const T* __restrict__ Ain,
                          T* __restrict__ lam,
                          int* __restrict__ sweeps_out, int C) {
  extern __shared__ __align__(16) unsigned char ev_block_dyn[];
  // a step's tau, by the step's parity: a step whose reflector is trivial
  // (tau = 0) has one barrier, so warp 0 may write the next step's tau
  // while the other warps still read this one's
  __shared__ T tau_sh[2];
  __shared__ int bad_sh, iters_sh[NTB / 32];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int LD = C | 1;
  T* M = reinterpret_cast<T*>(ev_block_dyn);   // C x LD
  T* v = M + C * LD;    // the reflector (v_0 = 1), then the eigenvalues
  T* pw = v + C;        // tau A v
  T* d = pw + C;        // the tridiagonal's diagonal
  T* e2 = d + C;        // its squared off-diagonal
  const T* src = Ain + (int64_t)s * C * C;
  if (tid == 0) bad_sh = 0;
  __syncthreads();
  for (int idx = tid; idx < C * C; idx += NTB) {
    const int i = idx / C, j = idx - i * C;
    const T x = T(0.5) * (src[i * C + j] + src[j * C + i]);
    if (!isfinite(x)) bad_sh = 1;
    M[i * LD + j] = x;
  }
  __syncthreads();
  if (bad_sh) {
    for (int i = tid; i < C; i += NTB) lam[(int64_t)s * C + i] = nan("");
    if (tid == 0 && sweeps_out) sweeps_out[s] = 0;
    return;
  }

  // Householder: step k maps column k below the diagonal onto e_1
  for (int k = 0; k + 2 < C; ++k) {
    const int m = C - k - 1;                // the trailing block's size
    T* Tb = M + (k + 1) * LD + k + 1;   // the trailing block
    if (warp == 0) {
      T ss = T(0.0);
      for (int i = 2 + lane; i <= m; i += 32) {
        const T x = M[(k + i) * LD + k];
        ss += x * x;
      }
      ss = warp_sum(ss);
      const T alpha = M[(k + 1) * LD + k];
      T beta = alpha, tau = T(0.0), scal = T(0.0);
      if (ss != T(0.0)) {   // LAPACK dlarfg
        const T r = sqrt(alpha * alpha + ss);
        beta = alpha >= T(0.0) ? -r : r;
        tau = (beta - alpha) / beta;
        scal = T(1.0) / (alpha - beta);
      }
      for (int i = 1 + lane; i < m; i += 32)
        v[i] = M[(k + 1 + i) * LD + k] * scal;
      if (lane == 0) {
        v[0] = T(1.0);
        tau_sh[k & 1] = tau;
        e2[k] = beta * beta;
      }
    }
    __syncthreads();
    const T tau = tau_sh[k & 1];
    if (tau != T(0.0)) {
      // pw = tau T v, two threads a row (every thread takes the shuffle)
      for (int base = 0; base < 2 * m; base += NTB) {
        const int i = (base + tid) >> 1, half = tid & 1;
        T acc = T(0.0);
        if (i < m)
          for (int j = half; j < m; j += 2) acc += Tb[i * LD + j] * v[j];
        acc += __shfl_xor_sync(FULL, acc, 1);
        if (i < m && half == 0) pw[i] = tau * acc;
      }
      __syncthreads();
      // T -= v w^T + w v^T, w = pw - (tau / 2) (v . pw) v
      T K = T(0.0);
      for (int j = 0; j < m; ++j) K += v[j] * pw[j];
      K *= T(0.5) * tau;
      for (int base = 0; base < 2 * m; base += NTB) {
        const int i = (base + tid) >> 1, half = tid & 1;
        if (i < m) {
          const T vi = v[i], wi = pw[i] - K * vi;
          for (int j = half; j < m; j += 2)
            Tb[i * LD + j] -= vi * (pw[j] - K * v[j]) + wi * v[j];
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < C; i += NTB) d[i] = M[i * LD + i];
  if (tid == 0) {
    const T x = M[(C - 1) * LD + C - 2];
    e2[C - 2] = x * x;
  }
  __syncthreads();

  // the Gershgorin interval and pivmin (every thread)
  T gl = d[0], gu = d[0], emax = T(0.0);
  for (int j = 0; j < C; ++j) {
    const T r = (j > 0 ? sqrt(e2[j - 1]) : T(0.0)) +
                     (j + 1 < C ? sqrt(e2[j]) : T(0.0));
    gl = fmin(gl, d[j] - r);
    gu = fmax(gu, d[j] + r);
    if (j + 1 < C) emax = fmax(emax, e2[j]);
  }
  const T pivmin = Lim<T>::tiny * fmax(T(1.0), emax);
  const T tnorm = fmax(fabs(gl), fabs(gu));
  gl -= T(2.1) * tnorm * Lim<T>::eps * C + T(4.2) * pivmin;
  gu += T(2.1) * tnorm * Lim<T>::eps * C + T(2.1) * pivmin;
  const T tol = T(2.0) * Lim<T>::eps * tnorm;

  // eigenvalue i: the least x whose count reaches i + 1
  int iters = 0;
  for (int i = tid; i < C; i += NTB) {
    T lo = gl, hi = gu;
    int it = 0;
    while (it < MAX_BISECT && hi - lo > tol) {
      const T mid = T(0.5) * (lo + hi);
      if (mid <= lo || mid >= hi) break;
      ++it;
      if (sturm_count(d, e2, C, mid, pivmin) > i)
        hi = mid;
      else
        lo = mid;
    }
    v[i] = T(0.5) * (lo + hi);
    iters = max(iters, it);
  }
  for (int off = 16; off > 0; off >>= 1)
    iters = max(iters, __shfl_xor_sync(FULL, iters, off));
  if (lane == 0) iters_sh[warp] = iters;
  __syncthreads();
  // ascending exactly: a prefix maximum (ties to rounding), clamped at 0
  for (int i = tid; i < C; i += NTB) {
    T x = v[0];
    for (int j = 1; j <= i; ++j) x = fmax(x, v[j]);
    lam[(int64_t)s * C + i] = x < T(0.0) ? T(0.0) : x;
  }
  if (tid == 0 && sweeps_out) {
    int most = 0;
    for (int w = 0; w < NTB / 32; ++w) most = max(most, iters_sh[w]);
    sweeps_out[s] = most;
  }
}

template <class T>
int run(const T* A, T* lam, int* sweeps, int S, int C, cudaStream_t stream) {
  const int LD = C | 1;
  if (C <= WARP_MAX_C) {
    const int bytes = (int)sizeof(T) * WPB * C * LD;
    const dim3 blocks((S + WPB - 1) / WPB);
    auto warp_kernel = sym_eigvalsh_warp_kernel<T>;
    warp_kernel<<<blocks, 32 * WPB, bytes, stream>>>(A, lam, sweeps, S, C);
    return (int)cudaGetLastError();
  }
  const int bytes = (int)sizeof(T) * (C * LD + 4 * C);
  auto block_kernel = sym_eigvalsh_block_kernel<T>;
  if (bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
  }
  const dim3 blocks(S);
  block_kernel<<<blocks, NTB, bytes, stream>>>(A, lam, sweeps, C);
  return (int)cudaGetLastError();
}

}  // namespace

// A (S, C, C) row-major f64 on the card -> lam (S, C) ascending, clamped at
// 0 (NaN for a matrix with a non-finite entry); sweeps (S,) int32 (may be
// null): the Jacobi sweeps each matrix took (C <= 32) or its most
// bisection steps (C > 32).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int crm_sym_eigvalsh(const double* A, double* lam, int* sweeps,
                                int S, int C, cudaStream_t stream) {
  return run<double>(A, lam, sweeps, S, C, stream);
}

// The float32 context's mixture weights (engine.py:759-769 on an f32
// context: the weight matrices rounded to f32, their eigenvalues in f32):
// A (S, C, C) f32 -> lam (S, C) f32, as crm_sym_eigvalsh with every sum,
// rotation and bisection step in f32 (the bisection stops at 2 eps(f32) of
// the interval's scale, so it takes fewer steps).
extern "C" int crm_sym_eigvalsh_f32(const float* A, float* lam, int* sweeps,
                                    int S, int C, cudaStream_t stream) {
  return run<float>(A, lam, sweeps, S, C, stream);
}
