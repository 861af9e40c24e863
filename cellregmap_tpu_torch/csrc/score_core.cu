// K5: per-variant score statistic, f64, for sm_90a.
//
// For variant s at its best rho k_s, with cov = v0 Sigma + v1 I expressed in
// the eigenbasis (eigenvalues Sb = S[k_s]) and omega = v0 Sb / (v1 + v0 Sb):
//
//   u^T K0^{-1} v = (u^T v - sum_r omega_r u_r v_r) / v1   for u, v in
//   the columns of [A | X | y], A = At[s] (R, C), X = [W_t, g_t] (R, p+1);
//   B   = (XKX + ridge)^{-1} [XKy | AKX^T]                 (p+1 Cholesky)
//   APy = AKy - AKX B[:, 0],   APA = AKA - AKX B[:, 1:]
//   Q   = 1/2 ||APy||^2,       Wmat = 1/4 (APA + APA^T)
//
// Replaces: cellregmap_tpu/engine.py `score_test_core` as vmapped by
// `interaction_batch`'s `per_snp` (davies branch), lines 234-265, 736-793.
//
// What bounds it on the H100: bytes.  Per variant it reads its (R, C)
// score factor and the R-long rows of its best rho (41 MB in all at the
// headline R=1010, C=10, S=512) and does ~2 R (C+p+2)^2 / 2 flop, a few
// flop per byte.  Its real limit at this size is latency: one block per
// variant walks R serially.
//
// Design: one 256-thread block per variant.  The block streams the rows of
// [A | W_t | g_t | y_t] through shared memory in chunks of 16 and
// accumulates the omega-weighted Gram of those m = C + p + 2 columns in
// registers, each thread owning up to 8 of its m(m+1)/2 entries (m <= 63
// and p <= 7, so C = 50 fits with up to 7 covariates; the 32 KB Gram lands
// in shared memory afterwards).  The small algebra then runs in shared memory: the
// complement subtraction and 1/v1 scaling, a ridge (rcond 1e-12 *
// max(max|diag|, 1)) Cholesky of the (p+1)^2 system on one thread, the
// 1 + C triangular solves on one thread each, and APA, Q and the
// symmetrised Wmat in parallel over the C^2 entries.  Everything is f64.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;    // threads per block (one block per variant)
constexpr int MAXM = 63;   // columns of [A | X | y]: m(m+1)/2 <= NT * NACC
constexpr int NACC = 8;    // Gram entries per thread
constexpr int MAXP1 = 8;   // fixed effects p + 1
constexpr int RC = 16;     // rows per shared-memory chunk

__global__ void __launch_bounds__(NT)
score_core_kernel(const double* __restrict__ Sv, const double* __restrict__ WGt,
                  const double* __restrict__ yt, const double* __restrict__ At,
                  const double* __restrict__ WW, const double* __restrict__ Wy,
                  const double* __restrict__ Wg, const double* __restrict__ gg,
                  const double* __restrict__ gy, const double* __restrict__ AW,
                  const double* __restrict__ Ag, const double* __restrict__ Ay,
                  const double* __restrict__ AtA,
                  const int64_t* __restrict__ k_best,
                  const double* __restrict__ v0s,
                  const double* __restrict__ v1s, double* __restrict__ Qout,
                  double* __restrict__ Wout, int R, int C, int p, int S) {
  __shared__ double buf[64 * 64];          // row chunks, then the Gram
  __shared__ double om[RC];
  __shared__ double sA[MAXP1][MAXP1];       // XKX, then its Cholesky factor
  __shared__ double sB[MAXP1][MAXM + 1];    // [XKy | AKX^T], then solved
  __shared__ double sAKX[MAXM][MAXP1];
  __shared__ double sAPy[MAXM];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int p1 = p + 1;
  const int m = C + p1 + 1;
  const int xo = C;       // first X column of [A | X | y]
  const int yo = C + p1;  // the y column
  const int nent = m * (m + 1) / 2;
  const int ps = p + S;   // row length of the rotated [W | G] stack
  const int64_t k = k_best[s];
  const double v0 = v0s[s];
  const double v1 = v1s[s];
  const double* Sk = Sv + k * R;
  const double* WGk = WGt + k * (int64_t)R * ps;
  const double* yk = yt + k * R;
  const double* Ak = At + (int64_t)s * R * C;

  // this thread's Gram entries (i >= j) at triangular index i(i+1)/2 + j
  int ei[NACC], ej[NACC];
  double acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    const int e = tid + t * NT;
    int i = (int)((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
    while (i * (i + 1) / 2 > e) --i;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    ei[t] = e < nent ? i : 0;
    ej[t] = e < nent ? e - i * (i + 1) / 2 : 0;
    acc[t] = 0.0;
  }

  for (int r0 = 0; r0 < R; r0 += RC) {
    const int rows = min(RC, R - r0);
    for (int idx = tid; idx < rows * m; idx += NT) {
      const int rr = idx / m;
      const int col = idx - rr * m;
      const int64_t r = r0 + rr;
      double v;
      if (col < C) {
        v = Ak[r * C + col];
      } else if (col < C + p) {
        v = WGk[r * ps + (col - C)];
      } else if (col == C + p) {
        v = WGk[r * ps + p + s];
      } else {
        v = yk[r];
      }
      buf[rr * m + col] = v;
    }
    if (tid < rows) {
      const double sb = Sk[r0 + tid];
      om[tid] = (v0 * sb) / (v1 + v0 * sb);
    }
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
      const double w = om[rr];
      const double* row = buf + rr * m;
#pragma unroll
      for (int t = 0; t < NACC; ++t)
        acc[t] = fma(w * row[ei[t]], row[ej[t]], acc[t]);
    }
    __syncthreads();
  }

  // the weighted Gram, full symmetric, at buf[i * m + j]
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    if (tid + t * NT < nent) {
      buf[ei[t] * m + ej[t]] = acc[t];
      buf[ej[t] * m + ei[t]] = acc[t];
    }
  }
  __syncthreads();

  // K0^{-1} forms: (full-space Gram - weighted eigenbasis Gram) / v1
  for (int idx = tid; idx < p1 * p1; idx += NT) {
    const int i = idx / p1, j = idx - i * p1;
    double xx;
    if (i < p && j < p) xx = WW[i * p + j];
    else if (i < p) xx = Wg[(int64_t)i * S + s];
    else if (j < p) xx = Wg[(int64_t)j * S + s];
    else xx = gg[s];
    sA[i][j] = (xx - buf[(xo + i) * m + xo + j]) / v1;
  }
  if (tid < p1) {
    const double xy = tid < p ? Wy[tid] : gy[s];
    sB[tid][0] = (xy - buf[(xo + tid) * m + yo]) / v1;
  }
  for (int idx = tid; idx < C * p1; idx += NT) {
    const int c = idx / p1, i = idx - c * p1;
    const double ax = i < p ? AW[((int64_t)c * p + i) * S + s]
                            : Ag[(int64_t)c * S + s];
    const double v = (ax - buf[c * m + xo + i]) / v1;
    sAKX[c][i] = v;
    sB[i][1 + c] = v;
  }
  for (int c = tid; c < C; c += NT)
    sAPy[c] = (Ay[(int64_t)c * S + s] - buf[c * m + yo]) / v1;
  __syncthreads();

  // ridge + Cholesky of the (p+1)^2 system, lower factor in place
  if (tid == 0) {
    double dmax = 0.0;
    for (int i = 0; i < p1; ++i) dmax = fmax(dmax, fabs(sA[i][i]));
    const double ridge = 1e-12 * fmax(dmax, 1.0);
    for (int i = 0; i < p1; ++i) sA[i][i] += ridge;
    for (int j = 0; j < p1; ++j) {
      double d = sA[j][j];
      for (int l = 0; l < j; ++l) d -= sA[j][l] * sA[j][l];
      d = sqrt(d);
      sA[j][j] = d;
      for (int i = j + 1; i < p1; ++i) {
        double v = sA[i][j];
        for (int l = 0; l < j; ++l) v -= sA[i][l] * sA[j][l];
        sA[i][j] = v / d;
      }
    }
  }
  __syncthreads();

  // B = A^{-1} [XKy | AKX^T], one right-hand side per thread
  for (int t = tid; t < 1 + C; t += NT) {
    for (int i = 0; i < p1; ++i) {
      double v = sB[i][t];
      for (int l = 0; l < i; ++l) v -= sA[i][l] * sB[l][t];
      sB[i][t] = v / sA[i][i];
    }
    for (int i = p1 - 1; i >= 0; --i) {
      double v = sB[i][t];
      for (int l = i + 1; l < p1; ++l) v -= sA[l][i] * sB[l][t];
      sB[i][t] = v / sA[i][i];
    }
  }
  __syncthreads();

  // APA in place of the Gram's A block (each entry read and written by one
  // thread), APy in place of AKy
  for (int idx = tid; idx < C * C; idx += NT) {
    const int c = idx / C, d = idx - c * C;
    double v = (AtA[((int64_t)c * C + d) * S + s] - buf[c * m + d]) / v1;
    for (int i = 0; i < p1; ++i) v -= sAKX[c][i] * sB[i][1 + d];
    buf[c * m + d] = v;
  }
  for (int c = tid; c < C; c += NT) {
    double v = sAPy[c];
    for (int i = 0; i < p1; ++i) v -= sAKX[c][i] * sB[i][0];
    sAPy[c] = v;
  }
  __syncthreads();

  for (int idx = tid; idx < C * C; idx += NT) {
    const int c = idx / C, d = idx - c * C;
    Wout[((int64_t)s * C + c) * C + d] =
        0.25 * (buf[c * m + d] + buf[d * m + c]);
  }
  if (tid == 0) {
    double q = 0.0;
    for (int c = 0; c < C; ++c) q += sAPy[c] * sAPy[c];
    Qout[s] = 0.5 * q;
  }
}

}  // namespace

// Sv (nrho, R), WGt (nrho, R, p+S), yt (nrho, R), At (S, R, C), WW (p, p),
// Wy (p,), Wg (p, S), gg (S,), gy (S,), AW (C, p, S), Ag (C, S), Ay (C, S),
// AtA (C, C, S), k_best (S,) int64, v0 (S,), v1 (S,) -> Q (S,),
// Wmat (S, C, C).  Row-major f64 on the card; C + p + 2 <= 63, p + 1 <= 8.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_score_core(const double* Sv, const double* WGt,
                              const double* yt, const double* At,
                              const double* WW, const double* Wy,
                              const double* Wg, const double* gg,
                              const double* gy, const double* AW,
                              const double* Ag, const double* Ay,
                              const double* AtA, const int64_t* k_best,
                              const double* v0, const double* v1, double* Q,
                              double* Wmat, int R, int C, int p, int S,
                              cudaStream_t stream) {
  score_core_kernel<<<S, NT, 0, stream>>>(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy,
                                          AW, Ag, Ay, AtA, k_best, v0, v1, Q,
                                          Wmat, R, C, p, S);
  return (int)cudaGetLastError();
}
