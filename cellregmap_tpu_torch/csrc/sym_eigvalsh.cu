// K6a: batched eigenvalues of the score test's (C x C) weight matrices,
// f64, for sm_90a.
//
// For each matrix A_s (s < S), the eigenvalues of its symmetric part
// (A + A^T) / 2, ascending and clamped at 0: the mixture weights of the
// score statistic's null law.  The JAX package computes them as
// max(eigh(sym(A) + eps I) - eps, 0) with eps = 1e-12 max(max|diag|, 1)
// (cellregmap_tpu/ops/linalg.py `safe_eigh`, :238-249, clamped in
// `per_snp`, engine.py:759-769): the shift keeps the TPU's QDWH eigh off
// exactly singular inputs.  Jacobi needs no shift: its rotations are
// defined for any symmetric input, so the eigenvalues of sym(A) are those
// of the shifted matrix, shifted back, to rounding.
//
// Replaces: the batched device eigh of `per_snp` (engine.py:759-769) under
// the Liu, saddlepoint and auto p-value methods.
//
// What bounds it on the H100: latency.  A matrix is small (C <= 60:
// 28.8 KB), and each Jacobi sweep is C - 1 dependent rounds of C/2
// independent rotations, each touching two rows and two columns: at the
// headline (C = 10, S = 512) a sweep is ~4 C^3 = 4000 flop a matrix, far
// below any rate bound; the rounds' barriers set the time.
//
// Design: one block per matrix, the matrix in shared memory.  Cyclic
// Jacobi with the round-robin (circle) order: in round r of a sweep the
// indices 0..m-1 (m = C rounded up to even; the pad index takes no
// rotation) form m/2 disjoint pairs, so the round's rotations commute and
// run together.  A round: each pair's thread computes its rotation
// (Golub & Van Loan's symmetric Schur pair, t = sign(tau) / (|tau| +
// sqrt(1 + tau^2))); the block applies J^T from the left (rows p, q of
// every pair) and then J from the right (columns p, q); the pair's thread
// writes a_pp - t a_pq, a_qq + t a_pq and 0 into the pair's own 2 x 2
// block.  After each sweep the block reduces the off-diagonal norm and
// stops when it is below eps ||A||_F (at most MAX_SWEEPS sweeps; the count
// is written out).  Then each thread ranks one diagonal entry (ties by
// index) and writes max(lambda, 0) to its ascending position.
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAXC = 64;         // matrix size held in shared memory
constexpr int MAX_SWEEPS = 30;

// the partner pair (p, q) of slot k in round r of the circle order over m
// (even) indices: index 0 stays, the others rotate
__device__ void round_pair(int m, int r, int k, int& p, int& q) {
  auto at = [&](int pos) { return pos == 0 ? 0 : 1 + (pos - 1 + r) % (m - 1); };
  const int a = at(k), b = at(m - 1 - k);
  p = min(a, b);
  q = max(a, b);
}

__global__ void __launch_bounds__(NT)
sym_eigvalsh_kernel(const double* __restrict__ Ain, double* __restrict__ lam,
                    int* __restrict__ sweeps_out, int C) {
  __shared__ double A[MAXC * MAXC];
  __shared__ double cs[MAXC / 2], sn[MAXC / 2];
  __shared__ double red[2][NT / 32];
  __shared__ int done;
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m = C + (C & 1);
  const int npair = m / 2;
  const double* src = Ain + (int64_t)s * C * C;

  for (int idx = tid; idx < C * C; idx += NT) {
    const int i = idx / C, j = idx - i * C;
    A[i * MAXC + j] = 0.5 * (src[i * C + j] + src[j * C + i]);
  }
  if (tid == 0) done = 0;
  __syncthreads();

  int sweep = 0;
  for (;;) {
    // off-diagonal and total squared norms, over the block
    double off = 0.0, tot = 0.0;
    for (int idx = tid; idx < C * C; idx += NT) {
      const int i = idx / C, j = idx - i * C;
      const double v = A[i * MAXC + j];
      tot += v * v;
      if (i != j) off += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      off += __shfl_xor_sync(0xffffffffu, off, o);
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    }
    if (lane == 0) {
      red[0][warp] = off;
      red[1][warp] = tot;
    }
    __syncthreads();
    if (tid == 0) {
      double o2 = 0.0, t2 = 0.0;
      for (int w = 0; w < NT / 32; ++w) {
        o2 += red[0][w];
        t2 += red[1][w];
      }
      done = !(o2 > DBL_EPSILON * DBL_EPSILON * t2) || sweep >= MAX_SWEEPS;
    }
    __syncthreads();
    if (done) break;
    ++sweep;

    for (int r = 0; r < m - 1; ++r) {
      // each pair's rotation from its 2 x 2 block
      double app = 0.0, aqq = 0.0, apq = 0.0, t = 0.0;
      int pp = 0, qq = 0;
      if (tid < npair) {
        round_pair(m, r, tid, pp, qq);
        double c = 1.0, sv = 0.0;
        if (qq < C) {
          app = A[pp * MAXC + pp];
          aqq = A[qq * MAXC + qq];
          apq = A[pp * MAXC + qq];
          if (apq != 0.0) {
            const double tau = (aqq - app) / (2.0 * apq);
            t = fabs(tau) > 1e150
                    ? 0.5 / tau
                    : (tau >= 0.0 ? 1.0 : -1.0) /
                          (fabs(tau) + sqrt(1.0 + tau * tau));
            c = 1.0 / sqrt(1.0 + t * t);
            sv = t * c;
          }
        }
        cs[tid] = c;
        sn[tid] = sv;
      }
      __syncthreads();
      // rows p, q of every pair: A <- J^T A
      for (int idx = tid; idx < npair * C; idx += NT) {
        const int k = idx / C, col = idx - k * C;
        int p, q;
        round_pair(m, r, k, p, q);
        if (q >= C) continue;
        const double c = cs[k], sv = sn[k];
        const double x = A[p * MAXC + col], y = A[q * MAXC + col];
        A[p * MAXC + col] = c * x - sv * y;
        A[q * MAXC + col] = sv * x + c * y;
      }
      __syncthreads();
      // columns p, q of every pair: A <- A J
      for (int idx = tid; idx < npair * C; idx += NT) {
        const int k = idx / C, row = idx - k * C;
        int p, q;
        round_pair(m, r, k, p, q);
        if (q >= C) continue;
        const double c = cs[k], sv = sn[k];
        const double x = A[row * MAXC + p], y = A[row * MAXC + q];
        A[row * MAXC + p] = c * x - sv * y;
        A[row * MAXC + q] = sv * x + c * y;
      }
      __syncthreads();
      // the pair's own block, in the exact form
      if (tid < npair && qq < C && apq != 0.0) {
        A[pp * MAXC + pp] = app - t * apq;
        A[qq * MAXC + qq] = aqq + t * apq;
        A[pp * MAXC + qq] = 0.0;
        A[qq * MAXC + pp] = 0.0;
      }
      __syncthreads();
    }
  }

  // ascending order: each thread ranks one diagonal entry
  for (int i = tid; i < C; i += NT) {
    const double v = A[i * MAXC + i];
    int rank = 0;
    for (int j = 0; j < C; ++j) {
      const double u = A[j * MAXC + j];
      rank += (u < v) || (u == v && j < i);
    }
    lam[(int64_t)s * C + rank] = v < 0.0 ? 0.0 : v;  // NaN stays NaN
  }
  if (tid == 0 && sweeps_out) sweeps_out[s] = sweep;
}

}  // namespace

// A (S, C, C) row-major f64 on the card, C <= 64 -> lam (S, C) ascending,
// clamped at 0; sweeps (S,) int32 (may be null): the Jacobi sweeps each
// matrix took.  Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_sym_eigvalsh(const double* A, double* lam, int* sweeps,
                                int S, int C, cudaStream_t stream) {
  sym_eigvalsh_kernel<<<S, NT, 0, stream>>>(A, lam, sweeps, C);
  return (int)cudaGetLastError();
}
